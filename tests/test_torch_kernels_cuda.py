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
    fused_self_attention,
    head_major_attention_reference,
    packed_attention_bwd,
    packed_attention_bwd_reference,
    packed_attention_lse_reference,
    packed_attention_reference,
    packed_self_attention,
)
from polyffusion_tpu_torch.config import load_params
from polyffusion_tpu_torch.diffusion.sampler import _epilogue_scalars
from polyffusion_tpu_torch.diffusion.schedule import make_schedule
from polyffusion_tpu_torch.ops.fused_gn_conv import (
    gn_silu_amax,
    gn_silu_amax_reference,
    gn_silu_conv3x3,
    gn_silu_conv3x3_concat,
    gn_silu_conv3x3_concat_q,
    gn_silu_conv3x3_q,
    gn_silu_conv3x3_q_reference,
    gn_silu_conv3x3_reference,
    quantize_conv_kernel,
)
from polyffusion_tpu_torch.ops.gn_bwd import gn_bwd_reference, gn_primal, group_norm_bwd
from polyffusion_tpu_torch.ops.repaint_epilogue import (
    fused_repaint_epilogue,
    repaint_epilogue_reference,
)

# the limits of chip_smoke.py (set there from the card's readings)
ATTN_LIMITS = {torch.bfloat16: (2e-3, 2**-6), torch.float32: (1e-5, 0.0)}
BWD_LIMITS = {torch.bfloat16: (2e-3, 2**-6), torch.float32: (1e-6, 0.0)}
GN_LIMITS = {torch.bfloat16: (1e-4, 2**-6), torch.float32: (1e-6, 1e-6)}
GN_PARAM_LIMIT = (1e-3, 1e-5)
EPI_LIMIT = (1e-5, 1e-5)
GN_CONV_LIMITS = {torch.bfloat16: (1e-3, 2**-6), torch.float32: (1e-5, 1e-5)}
GN_CONV_Q_LIMITS = {torch.bfloat16: (1e-3, 2**-6), torch.float32: (1e-3, 1e-5)}


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
    "bh,t,d,dtype",
    [
        (8, 256, 64, torch.bfloat16),
        (7, 256, 64, torch.float32),
        (6, 128, 128, torch.bfloat16),
        (4, 200, 64, torch.bfloat16),
        (4, 200, 64, torch.float32),
        (3, 1000, 128, torch.bfloat16),
        (3, 1000, 128, torch.float32),
        (2, 1, 64, torch.float32),
        (2, 65, 128, torch.bfloat16),
    ],
)
def test_cuda_head_major_matches_plain(bh, t, d, dtype):
    """Kernel 3 at tile multiples and ragged lengths, down to T = 1: rows past
    T are neither read nor written (the output's guard bytes stay as set)."""
    g = _card()
    q, k, v = (torch.randn(bh, t, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    before = fused_self_attention.launches
    got = fused_self_attention(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert fused_self_attention.launches == before + 1
    want = head_major_attention_reference(q, k, v, d**-0.5)
    assert got.shape == want.shape and got.dtype == dtype
    assert torch.isfinite(got).all()
    assert _within(got, want, *ATTN_LIMITS[dtype])


@pytest.mark.cuda
def test_cuda_head_major_stays_in_bounds():
    """A ragged (BH, T, D) slice of a larger buffer: the kernel writes no row
    past T into the next head's rows, which hold a sentinel."""
    g = _card()
    bh, t, d = 3, 100, 64
    buf = torch.full((bh + 1, t, d), 7.0, device="cuda", dtype=torch.bfloat16)
    q, k, v = (torch.randn(bh, t, d, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    out = buf[:bh]
    from polyffusion_tpu_torch.ops import fused_attention as fa

    fn = fa._kernel("packed_attention", "head_major_attention_fwd",
                    [fa.ctypes.c_void_p] * 4 + [fa.ctypes.c_int] * 4
                    + [fa.ctypes.c_float, fa.ctypes.c_void_p])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, t, d, 1,
             d**-0.5, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert bool((buf[bh] == 7.0).all())
    assert _within(out, head_major_attention_reference(q, k, v, d**-0.5),
                   *ATTN_LIMITS[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_head_major_gradient_matches_plain(dtype):
    """The backward recomputes through the plain version on the card: it
    agrees with the plain version's autograd on CPU copies."""
    g = _card()
    bh, t, d = 4, 200, 64
    qkv = [torch.randn(bh, t, d, device="cuda", generator=g).to(dtype).requires_grad_()
           for _ in range(3)]
    co = torch.randn(bh, t, d, device="cuda", generator=g).to(dtype)
    got = torch.autograd.grad(fused_self_attention(*qkv, d**-0.5), qkv, co)
    cpu = [x.detach().cpu().requires_grad_() for x in qkv]
    want = torch.autograd.grad(head_major_attention_reference(*cpu, d**-0.5), cpu, co.cpu())
    for x, y in zip(got, want):
        assert _within(x.cpu(), y, *BWD_LIMITS[dtype])


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
@pytest.mark.parametrize(
    "b,t,h,d,dtype",
    [
        (4, 1024, 4, 64, torch.bfloat16),
        (4, 256, 4, 64, torch.bfloat16),
        (2, 192, 2, 64, torch.bfloat16),
        (2, 512, 2, 128, torch.bfloat16),
        (2, 128, 2, 128, torch.bfloat16),
        (3, 64, 3, 64, torch.bfloat16),
        (1, 2048, 2, 64, torch.bfloat16),
    ],
)
def test_cuda_forward_lse_matches_plain(b, t, h, d, dtype):
    """The bf16 forward's row log-sum-exp (fp32, written when a gradient will
    be taken) against the plain one, D = 64 and 128; the output meets kernel
    1's limit in each."""
    from polyffusion_tpu_torch.ops.fused_attention import _forward

    g = _card()
    q, k, v = (torch.randn(b, t, h * d, device="cuda", generator=g).to(dtype) for _ in range(3))
    out, lse = _forward(q, k, v, d**-0.5, h, True)
    torch.cuda.synchronize()
    assert lse.shape == (b, h, t) and lse.dtype == torch.float32
    assert _within(lse, packed_attention_lse_reference(q, k, d**-0.5, h), 1e-5, 0.0)
    assert _within(out, packed_attention_reference(q, k, v, d**-0.5, h), *ATTN_LIMITS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize(
    "b,t,h,d,dtype",
    [
        (4, 1024, 4, 64, torch.bfloat16),
        (4, 256, 4, 64, torch.bfloat16),
        (2, 512, 2, 128, torch.bfloat16),
        (2, 128, 2, 128, torch.bfloat16),
        (3, 64, 3, 64, torch.bfloat16),
    ],
)
def test_cuda_attention_bwd_with_forward_lse_matches_plain(b, t, h, d, dtype):
    """The backward given the forward kernel's lse against the plain backward
    (its own row statistics), and against the plain backward in lse form."""
    from polyffusion_tpu_torch.ops.fused_attention import _forward

    g = _card()
    q, k, v, do = (torch.randn(b, t, h * d, device="cuda", generator=g).to(dtype) for _ in range(4))
    _, lse = _forward(q, k, v, d**-0.5, h, True)
    before = (packed_attention_bwd.launches, packed_self_attention.launches)
    got = packed_attention_bwd(q, k, v, do, d**-0.5, h, lse=lse)
    torch.cuda.synchronize()
    assert (packed_attention_bwd.launches, packed_self_attention.launches) == (
        before[0] + 1, before[1])
    for want in (packed_attention_bwd_reference(q, k, v, do, d**-0.5, h),
                 packed_attention_bwd_reference(q, k, v, do, d**-0.5, h, lse)):
        for x, y in zip(got, want):
            assert _within(x, y, *BWD_LIMITS[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_attention_bwd_is_reproducible(d):
    """The bf16 backward has no atomics: every sum has one owner, so two calls
    on the same inputs give the same bits."""
    from polyffusion_tpu_torch.ops.fused_attention import _forward

    g = _card()
    b, t, h = 2, 256, 2
    q, k, v, do = (torch.randn(b, t, h * d, device="cuda", generator=g).to(torch.bfloat16)
                   for _ in range(4))
    _, lse = _forward(q, k, v, d**-0.5, h, True)
    first = packed_attention_bwd(q, k, v, do, d**-0.5, h, lse=lse)
    second = packed_attention_bwd(q, k, v, do, d**-0.5, h, lse=lse)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "bh,t,d",
    [(5, 130, 128), (3, 300, 64), (1, 63, 64), (9, 127, 128), (2, 129, 64)],
)
def test_cuda_head_major_ragged_bf16_matches_plain(bh, t, d):
    """Ragged T through the TMA-fed bf16 body: the map zero-fills rows past T,
    the key mask scores them -inf, and no row past T is stored."""
    g = _card()
    q, k, v = (torch.randn(bh, t, d, device="cuda", generator=g).to(torch.bfloat16)
               for _ in range(3))
    got = fused_self_attention(q, k, v, d**-0.5)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _within(got, head_major_attention_reference(q, k, v, d**-0.5),
                   *ATTN_LIMITS[torch.bfloat16])


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


# (B, C1, C2, O, H, W): main-path sites, then ragged shapes the kernels mask
# (W not a power of two, H short of a tile, channels and O off the 32/64 tiles)
GN_CONV_SHAPES = [
    (2, 64, 0, 64, 128, 128),
    (2, 128, 64, 64, 128, 128),
    (2, 64, 0, 128, 64, 64),
    (2, 256, 256, 256, 16, 16),
    (3, 64, 32, 64, 8, 8),
    (2, 96, 0, 80, 12, 20),
    (2, 40, 24, 48, 10, 10),
]


def _gn_conv_inputs(g, b, c1, c2, o, h, w, dtype, residual):
    f = lambda *s: torch.randn(*s, device="cuda", generator=g)  # noqa: E731
    d = dict(x=f(b, c1, h, w).to(dtype), a=f(b, c1) * 0.5 + 1, off=f(b, c1) * 0.3,
             w=(f(o, c1 + c2, 3, 3) * (9 * (c1 + c2)) ** -0.5).to(dtype), b=f(o) * 0.1,
             res=f(b, o, h, w).to(dtype) if residual else None, x2=None, a2=None, off2=None)
    if c2:
        d.update(x2=f(b, c2, h, w).to(dtype), a2=f(b, c2) * 0.5 + 1, off2=f(b, c2) * 0.3)
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("residual", [False, True], ids=["", "residual"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", GN_CONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_gn_conv_matches_plain(shape, dtype, residual):
    """Kernel 4 against its plain version; the limit must also catch a halo of
    SiLU(off) in place of 0."""
    g = _card()
    d = _gn_conv_inputs(g, *shape, dtype, residual)
    before = gn_silu_conv3x3.launches
    if d["x2"] is None:
        got = gn_silu_conv3x3(d["x"], d["a"], d["off"], d["w"], d["b"], d["res"])
    else:
        got = gn_silu_conv3x3_concat(d["x"], d["a"], d["off"], d["x2"], d["a2"], d["off2"], d["w"],
                                     d["b"], d["res"])
    torch.cuda.synchronize()
    assert gn_silu_conv3x3.launches == before + 1
    want = gn_silu_conv3x3_reference(d["x"], d["a"], d["off"], d["w"], d["b"], d["res"], d["x2"],
                                     d["a2"], d["off2"])
    assert got.dtype == dtype and got.shape == want.shape
    assert _within(got, want, *GN_CONV_LIMITS[dtype])
    assert not _within(_silu_halo_fault(d, dtype), want, *GN_CONV_LIMITS[dtype])


def _silu_halo_fault(d, dtype):
    """The plain version with the SiLU'd input padded by SiLU(off) in place
    of 0: the planted fault of kernel 4's check."""
    F = torch.nn.functional
    ys = []
    for x, a, off in ((d["x"], d["a"], d["off"]), (d["x2"], d["a2"], d["off2"])):
        if x is None:
            continue
        b, c, h, w = x.shape
        y = F.silu(off)[:, :, None, None].expand(b, c, h + 2, w + 2).clone()
        y[:, :, 1:-1, 1:-1] = F.silu(x.float() * a[:, :, None, None] + off[:, :, None, None])
        ys.append(y.to(dtype).float())
    out = F.conv2d(torch.cat(ys, 1), d["w"].float()) + d["b"][:, None, None]
    if d["res"] is not None:
        out = out + d["res"].float()
    return out.to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("shape", GN_CONV_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_cuda_gn_conv_q_matches_plain(shape, dtype):
    """Kernel 5 (its amax pass, then its int8 convolution) against its plain
    version."""
    g = _card()
    d = _gn_conv_inputs(g, *shape, dtype, residual=shape[2] == 0)
    w_q, w_scale = quantize_conv_kernel(d["w"])
    parts = gn_silu_amax(d["x"], d["a"], d["off"], d["x2"], d["a2"], d["off2"])
    torch.cuda.synchronize()
    assert torch.equal(parts.amax(1), gn_silu_amax_reference(d["x"], d["a"], d["off"], d["x2"],
                                                             d["a2"], d["off2"]))
    before = (gn_silu_conv3x3_q.launches, gn_silu_amax.launches)
    if d["x2"] is None:
        got = gn_silu_conv3x3_q(d["x"], d["a"], d["off"], w_q, w_scale, d["b"], d["res"])
    else:
        got = gn_silu_conv3x3_concat_q(d["x"], d["a"], d["off"], d["x2"], d["a2"], d["off2"], w_q,
                                       w_scale, d["b"], d["res"])
    torch.cuda.synchronize()
    assert (gn_silu_conv3x3_q.launches, gn_silu_amax.launches) == (before[0] + 1, before[1] + 1)
    want = gn_silu_conv3x3_q_reference(d["x"], d["a"], d["off"], w_q, w_scale, d["b"], d["res"],
                                       d["x2"], d["a2"], d["off2"])
    assert got.dtype == dtype and got.shape == want.shape
    assert _within(got, want, *GN_CONV_Q_LIMITS[dtype])


@pytest.mark.cuda
def test_cuda_gn_conv_gradient_matches_plain():
    """Autograd through kernel 4's function on the card (its backward
    recomputes through the plain version) against autograd of the plain
    version: the same computation, up to the order of cuDNN's backward sums."""
    g = _card()
    d = _gn_conv_inputs(g, 2, 64, 32, 64, 16, 16, torch.float32, False)
    names = ["x", "a", "off", "x2", "a2", "off2", "w", "b"]
    leaves = {n: d[n].clone().requires_grad_() for n in names}
    co = torch.randn(2, 64, 16, 16, device="cuda", generator=g)
    out = gn_silu_conv3x3_concat(*(leaves[n] for n in names))
    got = torch.autograd.grad(out, list(leaves.values()), co)
    ref = {n: d[n].clone().requires_grad_() for n in names}
    want = torch.autograd.grad(gn_silu_conv3x3_reference(
        ref["x"], ref["a"], ref["off"], ref["w"], ref["b"], None, ref["x2"], ref["a2"],
        ref["off2"]), list(ref.values()), co)
    for x, y in zip(got, want):
        assert _within(x, y, 1e-5, 1e-5)


@pytest.mark.cuda
def test_cuda_gn_conv_refuses_strided_input():
    g = _card()
    d = _gn_conv_inputs(g, 2, 64, 0, 64, 16, 16, torch.bfloat16, False)
    before = gn_silu_conv3x3.launches
    with pytest.raises(ValueError, match="contiguous"):
        gn_silu_conv3x3(d["x"].transpose(2, 3), d["a"], d["off"], d["w"], d["b"])
    assert gn_silu_conv3x3.launches == before
