"""The port's GroupNorm backward against the JAX package's: ``GroupNorm32``'s
autograd (the plain version of the CUDA kernel, on the CPU) against the XLA
branch of ``_gna_bwd`` and against the Pallas kernel in interpret mode; the
forward unchanged; and the checks of the kernel's wrapper. The CUDA kernel
itself is held against its plain version in ``tests/test_torch_kernels_cuda.py``
and ``chip_smoke.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from polyffusion_tpu.ops.gn_bwd import _gn_primal, _gna_bwd, gn_bwd_pallas
from polyffusion_tpu_torch.models.unet import GroupNorm32
from polyffusion_tpu_torch.ops.gn_bwd import gn_primal, group_norm_bwd


def _inputs(b, c, h, w, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, c, h, w)) * 2 + 0.5).astype(np.float32)
    scale = (rng.standard_normal(c) * 0.5 + 1.0).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    co = rng.standard_normal((b, c, h, w)).astype(np.float32)
    return x, scale, bias, co


def _port_grads(x, scale, bias, co, eps):
    gn = GroupNorm32(x.shape[1], eps=eps)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_()
    y = gn(xt)
    y.backward(torch.from_numpy(co))
    return xt.grad.numpy(), gn.weight.grad.numpy(), gn.bias.grad.numpy()


def _nhwc(a):
    return jnp.asarray(a.transpose(0, 2, 3, 1))


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("b,c,h,w,eps", [(2, 64, 16, 16, 1e-5), (1, 128, 8, 8, 1e-6), (2, 96, 8, 16, 1e-5)])
def test_groupnorm_backward_matches_jax(b, c, h, w, eps):
    """Autograd of ``GroupNorm32`` against the JAX package's analytic VJP (the
    XLA branch of ``_gna_bwd``) on the same inputs, fp32."""
    x, scale, bias, co = _inputs(b, c, h, w, seed=c + h)
    gx, gs, gb = _port_grads(x, scale, bias, co, eps)
    jx, js, jb = _nhwc(x), jnp.asarray(scale), jnp.asarray(bias)
    _, mean_c, inv_c = _gn_primal(jx, js, jb, 32, eps)
    dx, dgamma, dbeta = _gna_bwd(32, eps, (jx, js, mean_c, inv_c), _nhwc(co))
    # the tolerances of tests/test_gn_bwd.py:41-43
    np.testing.assert_allclose(gx, _nchw(dx), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(gs, np.asarray(dgamma), atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(gb, np.asarray(dbeta), atol=2e-3, rtol=1e-4)


def test_groupnorm_backward_matches_pallas_interpret():
    """The same against the TPU kernel ``_gn_bwd_kernel`` run in interpret mode."""
    x, scale, bias, co = _inputs(1, 64, 8, 8, seed=1)
    gx, gs, gb = _port_grads(x, scale, bias, co, 1e-5)
    jx, js, jb = _nhwc(x), jnp.asarray(scale), jnp.asarray(bias)
    _, mean_c, inv_c = _gn_primal(jx, js, jb, 32, 1e-5)
    dx, dgb, dbb = gn_bwd_pallas(jx, _nhwc(co), mean_c, inv_c, js, 32, interpret=True)
    np.testing.assert_allclose(gx, _nchw(dx), atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(gs, np.asarray(dgb.sum(0)), atol=2e-3, rtol=1e-4)
    np.testing.assert_allclose(gb, np.asarray(dbb.sum(0)), atol=2e-3, rtol=1e-4)


def _first_slice_forward(x, weight, bias, eps, g=32):
    """``GroupNorm32.forward`` as the first slice of the port wrote it."""
    b, c = x.shape[:2]
    x32 = x.float()
    s1 = x32.sum(dim=(2, 3))
    s2 = (x32 * x32).sum(dim=(2, 3))
    n = x[0, 0].numel() * (c // g)
    mean = s1.view(b, g, c // g).sum(-1) / n
    meansq = s2.view(b, g, c // g).sum(-1) / n
    inv = torch.rsqrt(torch.clamp(meansq - mean * mean, min=0.0) + eps)
    inv_c = inv.repeat_interleave(c // g, dim=1)
    mean_c = mean.repeat_interleave(c // g, dim=1)
    scale = weight.float()
    a = (inv_c * scale).to(x.dtype)
    off = (bias.float() - mean_c * inv_c * scale).to(x.dtype)
    return x * a[:, :, None, None] + off[:, :, None, None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_groupnorm_forward_unchanged(dtype):
    x, scale, bias, _ = _inputs(2, 64, 8, 8, seed=3)
    gn = GroupNorm32(64)
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(dtype)
    want = _first_slice_forward(xt, gn.weight, gn.bias, gn.eps)
    assert torch.equal(gn(xt), want)
    with torch.inference_mode():
        assert torch.equal(gn(xt), want)


def test_groupnorm_forward_matches_jax_primal():
    x, scale, bias, _ = _inputs(2, 64, 8, 8, seed=4)
    y, mean_c, inv_c = gn_primal(torch.from_numpy(x), torch.from_numpy(scale),
                                 torch.from_numpy(bias), 32, 1e-5)
    jy, jmean, jinv = _gn_primal(_nhwc(x), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-5)
    np.testing.assert_allclose(y.numpy(), _nchw(jy), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(mean_c.numpy(), np.asarray(jmean), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(inv_c.numpy(), np.asarray(jinv), atol=1e-6, rtol=1e-6)


def test_groupnorm_bf16_grads_in_input_and_param_dtypes():
    x, scale, bias, co = _inputs(2, 64, 8, 8, seed=5)
    gn = GroupNorm32(64)  # norm parameters stay fp32 in a bf16 model
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    gn(xt).backward(torch.from_numpy(co).to(torch.bfloat16))
    assert xt.grad.dtype == torch.bfloat16
    assert gn.weight.grad.dtype == gn.bias.grad.dtype == torch.float32
    want, _, _ = _port_grads(x, np.ones(64, np.float32), np.zeros(64, np.float32), co, 1e-5)
    assert np.abs(xt.grad.float().numpy() - want).max() < 0.05 * np.abs(want).max()


@pytest.mark.parametrize(
    "shape,groups,kw,match",
    [
        ((1, 64, 3, 3), 32, {}, "multiple of 8"),
        ((1, 4096, 8, 8), 32, {}, "channels per group"),
        ((1, 64, 8, 8), 32, {"dy_dtype": torch.bfloat16}, "float32 or bfloat16"),
        ((1, 64, 8, 8), 32, {"stats_shape": (1, 32)}, "mean_c"),
    ],
)
def test_gn_wrapper_rejects_what_the_kernel_does_not_take(shape, groups, kw, match):
    b, c = shape[:2]
    x = torch.zeros(shape)
    dy = torch.zeros(shape, dtype=kw.get("dy_dtype", torch.float32))
    stats = torch.zeros(kw.get("stats_shape", (b, c)))
    with pytest.raises(ValueError, match=match):
        group_norm_bwd(x, dy, stats, torch.zeros(b, c), torch.ones(c), groups)
