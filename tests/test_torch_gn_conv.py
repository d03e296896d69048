"""Kernels 4 and 5's plain versions, the GroupNorm affine and the int8 weight
quantization, the port against the JAX package on the CPU on the same numpy
inputs: the Pallas kernels run in interpret mode, as tests/test_fused_gn_conv.py
and tests/test_int8_gn_conv.py run them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.models.unet import FP32GroupNorm
from polyffusion_tpu.ops import fused_gn_conv as J
from polyffusion_tpu.ops.quant import quantize_weight as jax_quantize_weight
from polyffusion_tpu_torch.ops import fused_gn_conv as P
from polyffusion_tpu_torch.ops.gn_bwd import gn_affine
from polyffusion_tpu_torch.ops.quant import quantize_weight

# tolerances of the JAX package's own tests: fp32 tests/test_fused_gn_conv.py:30,
# bf16 :59; int8 tests/test_int8_gn_conv.py:50 (fp32) and :108 (bf16); the
# gradient :80
FP32_ATOL, BF16_ATOL = 2e-4, 0.15
Q_ATOL, Q_RTOL, Q_BF16_ATOL = 1e-3, 1e-5, 0.2
GRAD_ATOL = 5e-4
B, H, W, C1, C2, O = 2, 8, 8, 64, 32, 64


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Tiny shapes: one intra-op thread keeps parallel test workers from
    oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, two_inputs, residual, dtype):
    """numpy NCHW inputs: x (and x2), a/off over both parts, w (O, C, 3, 3),
    bias, residual."""
    rng = np.random.default_rng(seed)
    c2 = C2 if two_inputs else 0
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    d = dict(x=f(B, C1, H, W), a=f(B, C1) * 0.5 + 1.0, off=f(B, C1) * 0.2,
             w=f(O, C1 + c2, 3, 3) * (9 * (C1 + c2)) ** -0.5, b=f(O) * 0.1,
             res=f(B, O, H, W) if residual else None)
    if two_inputs:
        d.update(x2=f(B, c2, H, W), a2=f(B, c2) * 0.5 + 1.0, off2=f(B, c2) * 0.2)
    return d


def _jax_args(d, dtype):
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    nhwc = lambda v: None if v is None else jnp.asarray(v.transpose(0, 2, 3, 1), jd)  # noqa: E731
    out = dict(x=nhwc(d["x"]), a=jnp.asarray(d["a"]), off=jnp.asarray(d["off"]),
               w=jnp.asarray(d["w"].transpose(2, 3, 1, 0), jd), b=jnp.asarray(d["b"]),
               res=nhwc(d["res"]))
    if "x2" in d:
        out.update(x2=nhwc(d["x2"]), a2=jnp.asarray(d["a2"]), off2=jnp.asarray(d["off2"]))
    return out


def _torch_args(d, dtype):
    t = lambda v, dt=torch.float32: None if v is None else torch.from_numpy(v).to(dt)  # noqa: E731
    out = dict(x=t(d["x"], dtype), a=t(d["a"]), off=t(d["off"]), w=t(d["w"], dtype), b=t(d["b"]),
               res=t(d["res"], dtype))
    if "x2" in d:
        out.update(x2=t(d["x2"], dtype), a2=t(d["a2"]), off2=t(d["off2"]))
    return out


def _nchw(y):
    return np.asarray(y, np.float32).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("residual", [False, True], ids=["", "residual"])
@pytest.mark.parametrize("two_inputs", [False, True], ids=["one", "concat"])
def test_plain_matches_interpret_kernel(two_inputs, residual, dtype):
    d = _inputs(0, two_inputs, residual, dtype)
    j, t = _jax_args(d, dtype), _torch_args(d, dtype)
    if two_inputs:
        want = J.gn_silu_conv3x3_concat(j["x"], j["a"], j["off"], j["x2"], j["a2"], j["off2"],
                                        j["w"], j["b"], j["res"], interpret=True)
        got = P.gn_silu_conv3x3_concat(t["x"], t["a"], t["off"], t["x2"], t["a2"], t["off2"],
                                       t["w"], t["b"], t["res"])
    else:
        want = J.gn_silu_conv3x3(j["x"], j["a"], j["off"], j["w"], j["b"], j["res"],
                                 interpret=True)
        got = P.gn_silu_conv3x3(t["x"], t["a"], t["off"], t["w"], t["b"], t["res"])
    assert got.dtype == dtype and got.shape == (B, O, H, W)
    atol = FP32_ATOL if dtype == torch.float32 else BF16_ATOL
    np.testing.assert_allclose(got.float().detach().numpy(), _nchw(want), atol=atol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("two_inputs,residual", [(False, False), (False, True), (True, False)],
                         ids=["one", "one-residual", "concat"])
def test_q_plain_matches_interpret_kernel(two_inputs, residual, dtype):
    d = _inputs(1, two_inputs, residual, dtype)
    j, t = _jax_args(d, dtype), _torch_args(d, dtype)
    jw_q, jw_scale = J.quantize_conv_kernel(jnp.asarray(d["w"].transpose(2, 3, 1, 0)))
    w_q, w_scale = P.quantize_conv_kernel(torch.from_numpy(d["w"]))
    if two_inputs:
        want = J.gn_silu_conv3x3_concat_q(j["x"], j["a"], j["off"], j["x2"], j["a2"], j["off2"],
                                          jw_q, jw_scale, j["b"], j["res"], interpret=True)
        got = P.gn_silu_conv3x3_concat_q(t["x"], t["a"], t["off"], t["x2"], t["a2"], t["off2"],
                                         w_q, w_scale, t["b"], t["res"])
    else:
        want = J.gn_silu_conv3x3_q(j["x"], j["a"], j["off"], jw_q, jw_scale, j["b"], j["res"],
                                   interpret=True)
        got = P.gn_silu_conv3x3_q(t["x"], t["a"], t["off"], w_q, w_scale, t["b"], t["res"])
    assert got.dtype == dtype and got.shape == (B, O, H, W)
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), _nchw(want), atol=Q_ATOL, rtol=Q_RTOL)
    else:
        np.testing.assert_allclose(got.float().numpy(), _nchw(want), atol=Q_BF16_ATOL)


def test_quantize_weight_matches_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    w = rng.standard_normal((64, 96, 3, 3)).astype(np.float32) * 0.07
    w[3] = 0.0  # an all-zero channel takes the 1e-8 floor
    q, scale = quantize_weight(torch.from_numpy(w))
    jq, jscale = jax_quantize_weight(jnp.asarray(w.transpose(2, 3, 1, 0)))
    assert q.dtype == torch.int8 and scale.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize("two_inputs", [False, True], ids=["one-residual", "concat"])
def test_gradient_matches_jax(two_inputs):
    """Autograd through the port's function (its backward recomputes through
    the plain version) against ``jax.grad`` through the interpret-mode kernel."""
    d = _inputs(3, two_inputs, not two_inputs, torch.float32)
    j = _jax_args(d, torch.float32)
    names = ["x", "a", "off"] + (["x2", "a2", "off2"] if two_inputs else []) + ["w", "b"]
    names += [] if two_inputs else ["res"]

    def jloss(*vals):
        v = dict(zip(names, vals))
        if two_inputs:
            y = J.gn_silu_conv3x3_concat(v["x"], v["a"], v["off"], v["x2"], v["a2"], v["off2"],
                                         v["w"], v["b"], interpret=True)
        else:
            y = J.gn_silu_conv3x3(v["x"], v["a"], v["off"], v["w"], v["b"], v["res"],
                                  interpret=True)
        return jnp.sum(y**2)

    want = jax.grad(jloss, argnums=tuple(range(len(names))))(*(j[n] for n in names))
    t = {n: v.requires_grad_() for n, v in _torch_args(d, torch.float32).items()
         if v is not None}
    if two_inputs:
        y = P.gn_silu_conv3x3_concat(t["x"], t["a"], t["off"], t["x2"], t["a2"], t["off2"],
                                     t["w"], t["b"])
    else:
        y = P.gn_silu_conv3x3(t["x"], t["a"], t["off"], t["w"], t["b"], t["res"])
    assert type(y.grad_fn).__name__.startswith("_GNSiLUConv")
    got = torch.autograd.grad((y**2).sum(), [t[n] for n in names])
    for n, g, wnt in zip(names, got, want):
        wnt = np.asarray(wnt)
        if wnt.ndim == 4:
            wnt = wnt.transpose(3, 2, 0, 1) if n == "w" else wnt.transpose(0, 3, 1, 2)
        np.testing.assert_allclose(g.numpy(), wnt, atol=GRAD_ATOL, rtol=1e-5, err_msg=n)


def test_int8_backward_raises():
    t = _torch_args(_inputs(4, True, False, torch.float32), torch.float32)
    w_q, w_scale = P.quantize_conv_kernel(t["w"])
    x = t["x"].requires_grad_()
    y = P.gn_silu_conv3x3_concat_q(x, t["a"], t["off"], t["x2"], t["a2"], t["off2"], w_q,
                                   w_scale, t["b"])
    with pytest.raises(NotImplementedError, match="sampling-only"):
        y.sum().backward()


@pytest.mark.parametrize("two_inputs", [False, True], ids=["one", "concat"])
def test_gn_affine_matches_jax(two_inputs):
    """fp32 (a, off), not rounded, over the virtual concat when given two inputs."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((B, 64, H, W)) * 2 + 0.5).astype(np.float32)
    x2 = (rng.standard_normal((B, 32, H, W)) - 0.3).astype(np.float32) if two_inputs else None
    c = 64 + (32 if two_inputs else 0)
    scale = (rng.standard_normal(c) * 0.5 + 1).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    nhwc = lambda v: None if v is None else jnp.asarray(v.transpose(0, 2, 3, 1))  # noqa: E731
    ja, joff = FP32GroupNorm().apply({"params": {"scale": jnp.asarray(scale),
                                                 "bias": jnp.asarray(bias)}},
                                     nhwc(x), nhwc(x2), return_affine=True)
    a, off = gn_affine(torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias), 32,
                       1e-5, None if x2 is None else torch.from_numpy(x2))
    assert a.dtype == off.dtype == torch.float32 and a.shape == (B, c)
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=2e-6, atol=1e-6)
    np.testing.assert_allclose(off.numpy(), np.asarray(joff), rtol=2e-6, atol=1e-6)


def test_gn_affine_is_not_rounded_in_bf16():
    """The fused route applies the affine in fp32: gn_affine of a bf16 x keeps
    fp32 values that bf16 cannot hold (the unfused GroupNorm rounds them)."""
    x = torch.randn(2, 64, 4, 4, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    a, off = gn_affine(x, torch.full((64,), 1.1), torch.full((64,), 0.3), 32, 1e-5)
    assert a.dtype == torch.float32
    assert (a != a.to(torch.bfloat16).float()).any()


@pytest.mark.parametrize("bad", ["w_shape", "w_dtype", "a_dtype", "res_shape", "x2_hw"])
def test_wrapper_raises_on_inputs_it_does_not_take(bad):
    t = _torch_args(_inputs(6, True, True, torch.float32), torch.float32)
    if bad == "w_shape":
        t["w"] = t["w"][:, :C1]
    elif bad == "w_dtype":
        t["w"] = t["w"].to(torch.bfloat16)
    elif bad == "a_dtype":
        t["a2"] = t["a2"].to(torch.bfloat16)
    elif bad == "res_shape":
        t["res"] = t["res"][:, :32]
    else:
        t["x2"] = t["x2"][:, :, :4]
    with pytest.raises(ValueError):
        P.gn_silu_conv3x3_concat(t["x"], t["a"], t["off"], t["x2"], t["a2"], t["off2"], t["w"],
                                 t["b"], t["res"])
