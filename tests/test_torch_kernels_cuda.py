"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports torch only, so that it also runs on a GPU machine without
JAX, where the JAX-importing ``tests/conftest.py`` has to be left out:

    python -m pytest tests/test_torch_kernels_cuda.py -q --noconftest

Without a GPU every case skips.
"""

import pytest
import torch

from polyffusion_tpu_torch.ops.attention import multihead_attention
from polyffusion_tpu_torch.ops.fused_attention import (
    packed_attention_bwd,
    packed_attention_bwd_reference,
    packed_attention_reference,
    packed_self_attention,
)
from polyffusion_tpu_torch.config import load_params
from polyffusion_tpu_torch.diffusion.sampler import _epilogue_scalars
from polyffusion_tpu_torch.diffusion.schedule import make_schedule
from polyffusion_tpu_torch.ops.gn_bwd import gn_bwd_reference, gn_primal, group_norm_bwd
from polyffusion_tpu_torch.ops.repaint_epilogue import (
    fused_repaint_epilogue,
    repaint_epilogue_reference,
)

# the limits of chip_smoke.py (set there from the card's readings)
BWD_LIMITS = {torch.bfloat16: (2e-3, 2**-6), torch.float32: (1e-6, 0.0)}
GN_LIMITS = {torch.bfloat16: (1e-4, 2**-6), torch.float32: (1e-6, 1e-6)}
GN_PARAM_LIMIT = (1e-3, 1e-5)
EPI_LIMIT = (1e-5, 1e-5)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    from polyffusion_tpu_torch.device import tf32

    tf32(False)
    return torch.Generator(device="cuda").manual_seed(0)


def _within(got, want, atol, rtol):
    want = want.float()
    return bool(((got.float() - want).abs() <= atol + rtol * want.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,t,h,d,dtype,atol,rtol",
    [
        (4, 1024, 4, 64, torch.bfloat16, 2e-3, 2**-6),
        (4, 256, 4, 64, torch.bfloat16, 2e-3, 2**-6),
        (2, 512, 2, 128, torch.bfloat16, 2e-3, 2**-6),
        (2, 512, 2, 128, torch.float32, 1e-5, 0.0),
        (3, 64, 3, 64, torch.float32, 1e-5, 0.0),
    ],
)
def test_cuda_kernel_matches_plain(b, t, h, d, dtype, atol, rtol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    from polyffusion_tpu_torch.device import tf32

    tf32(False)
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn(b, t, h * d, device="cuda", generator=g).to(dtype) for _ in range(3))
    before = packed_self_attention.launches
    got = packed_self_attention(q, k, v, d**-0.5, h)
    torch.cuda.synchronize()
    assert packed_self_attention.launches == before + 1
    want = packed_attention_reference(q, k, v, d**-0.5, h)
    # bf16: two output ulps (rtol), and near zero the effect of rounding P
    # before the normalisation here and after it in the plain version (atol);
    # fp32: reassociation of the online softmax
    want = want.float()
    assert ((got.float() - want).abs() <= atol + rtol * want.abs()).all()


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,t,h,d,dtype",
    [
        (4, 1024, 4, 64, torch.bfloat16),
        (4, 256, 4, 64, torch.bfloat16),
        (2, 512, 2, 128, torch.bfloat16),
        (2, 512, 2, 128, torch.float32),
        (3, 64, 3, 64, torch.float32),
    ],
)
def test_cuda_attention_bwd_matches_plain(b, t, h, d, dtype):
    g = _card()
    q, k, v, do = (torch.randn(b, t, h * d, device="cuda", generator=g).to(dtype) for _ in range(4))
    before = packed_attention_bwd.launches
    got = packed_attention_bwd(q, k, v, do, d**-0.5, h)
    torch.cuda.synchronize()
    assert packed_attention_bwd.launches == before + 1
    want = packed_attention_bwd_reference(q, k, v, do, d**-0.5, h)
    for x, y in zip(got, want):
        assert x.dtype == dtype
        assert _within(x, y, *BWD_LIMITS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_attention_is_differentiable(dtype):
    """Autograd through ``multihead_attention`` on the card reaches q, k and v
    through the backward kernel, and agrees with the plain version's autograd
    (the same call on CPU copies)."""
    g = _card()
    b, t, h, d = 2, 256, 4, 64
    qkv = [torch.randn(b, t, h, d, device="cuda", generator=g).to(dtype).requires_grad_()
           for _ in range(3)]
    co = torch.randn(b, t, h, d, device="cuda", generator=g).to(dtype)
    before = packed_attention_bwd.launches
    out = multihead_attention(*qkv, d**-0.5)
    got = torch.autograd.grad(out, qkv, co)
    torch.cuda.synchronize()
    assert packed_attention_bwd.launches == before + 1
    cpu = [x.detach().cpu().requires_grad_() for x in qkv]
    want = torch.autograd.grad(multihead_attention(*cpu, d**-0.5), cpu, co.cpu())
    for x, y in zip(got, want):
        assert _within(x.cpu(), y, *BWD_LIMITS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,c,hh,ww,dtype",
    [
        (2, 64, 128, 128, torch.bfloat16),
        (2, 192, 64, 64, torch.bfloat16),
        (4, 512, 16, 16, torch.bfloat16),
        (2, 128, 32, 32, torch.float32),
        (3, 64, 8, 8, torch.float32),
    ],
)
def test_cuda_gn_bwd_matches_plain(b, c, hh, ww, dtype):
    g = _card()
    x = (torch.randn(b, c, hh, ww, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    dy = torch.randn(b, c, hh, ww, device="cuda", generator=g).to(dtype)
    gamma = torch.randn(c, device="cuda", generator=g) * 0.5 + 1.0
    beta = torch.randn(c, device="cuda", generator=g) * 0.1
    _, mean_c, inv_c = gn_primal(x, gamma, beta, 32, 1e-5)
    before = group_norm_bwd.launches
    got = group_norm_bwd(x, dy, mean_c, inv_c, gamma, 32)
    torch.cuda.synchronize()
    assert group_norm_bwd.launches == before + 1
    want = gn_bwd_reference(x, dy, mean_c, inv_c, gamma, 32)
    assert got[0].dtype == dtype
    assert _within(got[0], want[0], *GN_LIMITS[dtype])
    for x_, y in zip(got[1:], want[1:]):
        assert _within(x_, y, *GN_PARAM_LIMIT)


@pytest.mark.cuda
@pytest.mark.parametrize("step", [999, 500, 0])
@pytest.mark.parametrize("shape", [(2, 2, 128, 128), (3, 2, 16, 16)])
def test_cuda_repaint_epilogue_matches_plain(shape, step):
    """Kernel 7 against its plain version with the preset's scalars at ``step``;
    the limit must also catch a blend that ignores the mask."""
    g = _card()
    cfg = load_params("sdf_chd8bar")
    scalars = _epilogue_scalars(make_schedule(cfg.n_steps, cfg.linear_start, cfg.linear_end), step)
    x, eps, p_noise, q_noise = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
    orig = (torch.rand(shape, device="cuda", generator=g) < 0.05).float()
    mask = (torch.rand(shape, device="cuda", generator=g) < 0.5).float()
    before = fused_repaint_epilogue.launches
    got = fused_repaint_epilogue(x, eps, p_noise, orig, q_noise, mask, scalars)
    torch.cuda.synchronize()
    assert fused_repaint_epilogue.launches == before + 1
    want = repaint_epilogue_reference(x, eps, p_noise, orig, q_noise, mask, scalars)
    assert got.dtype == torch.float32 and got.shape == shape
    assert _within(got, want, *EPI_LIMIT)
    fault = repaint_epilogue_reference(x, eps, p_noise, orig, q_noise, torch.zeros_like(mask), scalars)
    assert not _within(fault, want, *EPI_LIMIT)


@pytest.mark.cuda
def test_cuda_repaint_epilogue_refuses_strided_tensors():
    """On the card the wrapper raises on a layout the kernel does not take; it
    neither copies nor falls back to the plain version."""
    _card()
    tensors = [torch.zeros(2, 2, 16, 16, device="cuda") for _ in range(6)]
    tensors[1] = torch.zeros(2, 16, 16, 2, device="cuda").permute(0, 3, 1, 2)
    before = fused_repaint_epilogue.launches
    with pytest.raises(ValueError, match="contiguous"):
        fused_repaint_epilogue(*tensors, [1.0] * 7)
    assert fused_repaint_epilogue.launches == before
