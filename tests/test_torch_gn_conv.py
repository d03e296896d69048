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


@pytest.mark.parametrize("c1,c2", [(40, 0), (40, 24)], ids=["one", "concat"])
def test_packed_weight_layout(c1, c2):
    """The kernels' weights: element (tap, o, c) of the packed tensor is
    w[o, c, tap // 3, tap % 3] for the first input's channels, the second
    input's start at C1 rounded up to 16, and the rest is zero."""
    w = torch.from_numpy(np.random.default_rng(7).standard_normal((24, c1 + c2, 3, 3)))
    packed = P.packed_weight(w, c1 if c2 else None)
    start2 = -(-c1 // 16) * 16
    assert packed.shape == (9, 24, -(-(start2 + c2) // 16) * 16) and packed.dtype == w.dtype
    for tap in range(9):
        for o in (0, 5, 23):
            for c in range(c1 + c2):
                col = c if c < c1 else start2 + c - c1
                assert packed[tap, o, col] == w[o, c, tap // 3, tap % 3]
    used = torch.zeros(packed.shape[2], dtype=torch.bool)
    used[:c1] = True
    used[start2:start2 + c2] = True
    assert not packed[:, :, ~used].any()


def test_packed_weight_cache_follows_in_place_updates():
    """Packed once per weight and version: the same tensor while w is
    unchanged; packed anew after an in-place update (which bumps
    w._version), a new storage, or another split; never shared between two
    weights."""
    w = torch.randn(8, 32, 3, 3)
    first = P.packed_weight(w)
    assert P.packed_weight(w) is first
    with torch.no_grad():
        w.mul_(2.0)
    again = P.packed_weight(w)
    assert again is not first
    torch.testing.assert_close(again, 2.0 * first, rtol=0, atol=0)
    assert P.packed_weight(w, 16) is not again
    other = w.clone()
    assert P.packed_weight(other) is not P.packed_weight(w, 16)
    torch.testing.assert_close(P.packed_weight(other), again, rtol=0, atol=0)


def test_fused_train_step_matches_jax_and_repacks(monkeypatch):
    """One SGD step of the tiny UNet through the fused route on the CPU, against
    the JAX package's fused route (its Pallas kernel in interpret mode, its
    custom VJP): the loss and every parameter's gradient, then the eps after the
    step; and the packed weights of each fused conv are rebuilt from the
    updated weights, not kept from before the step."""
    from test_torch_unet_gn_conv import TINY, UNET_ATOL, UNET_RTOL

    from polyffusion_tpu.models.unet import UNetModel as JaxUNet
    from polyffusion_tpu_torch.convert import unet_state_from_jax
    from polyffusion_tpu_torch.models.unet import UNetModel

    for name in ("POLYFF_FUSED_GN_CONV", "POLYFF_INT8_CONV", "POLYFF_INT8_XLA"):
        monkeypatch.delenv(name, raising=False)
    jm = JaxUNet(**TINY)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    t = np.array([5, 640], np.int32)
    cond = rng.standard_normal((2, 3, TINY["d_cond"])).astype(np.float32)
    co = rng.standard_normal((2, 2, 16, 16)).astype(np.float32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 2)),
                              jnp.zeros((1,), jnp.int32), jnp.zeros((1, 3, TINY["d_cond"])))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    monkeypatch.setenv("POLYFF_FUSED_GN_CONV", "1")
    lr = 1e-2
    args = (jnp.asarray(x.transpose(0, 2, 3, 1)), jnp.asarray(t), jnp.asarray(cond))
    apply = jax.jit(lambda p: jm.apply({"params": p}, *args))
    loss_fn = jax.jit(lambda p: jnp.sum(apply(p) * jnp.asarray(co.transpose(0, 2, 3, 1))))
    want_loss, grads = jax.value_and_grad(loss_fn)(params)
    stepped = jax.tree_util.tree_map(lambda p, g: p - lr * g, params, grads)
    want_after = np.asarray(apply(stepped)).transpose(0, 3, 1, 2)
    want_grads = unet_state_from_jax(jax.tree_util.tree_map(np.asarray, grads))

    tm = UNetModel(**TINY, gn_conv="fused")
    tm.load_state_dict(unet_state_from_jax(params), strict=True)
    inputs = (torch.from_numpy(x), torch.from_numpy(t.astype(np.int64)), torch.from_numpy(cond))
    convs = [m.weight for m in tm.modules() if isinstance(m, torch.nn.Conv2d)
             and m.kernel_size == (3, 3) and m.stride == (1, 1) and m.weight.shape[1] >= 32]
    packed = [P.packed_weight(w) for w in convs]
    loss = (tm(*inputs) * torch.from_numpy(co)).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want_grads[name].numpy(), atol=GRAD_ATOL,
                                   rtol=1e-4, err_msg=name)
    torch.optim.SGD(tm.parameters(), lr=lr).step()
    with torch.no_grad():
        got_after = tm(*inputs)
    np.testing.assert_allclose(got_after.numpy(), want_after, atol=UNET_ATOL, rtol=UNET_RTOL)
    for w, before in zip(convs, packed):
        now = P.packed_weight(w)
        assert now is not before
        torch.testing.assert_close(now[:, :, :w.shape[1]],
                                   w.detach().permute(2, 3, 0, 1).reshape(9, *w.shape[:2]),
                                   rtol=0, atol=0)
