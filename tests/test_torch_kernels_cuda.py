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
from polyffusion_tpu_torch.ops.gn_bwd import (
    gn_affine,
    gn_bwd_plan,
    gn_bwd_reference,
    gn_primal,
    group_norm_bwd,
)
from polyffusion_tpu_torch.ops.gn_fwd import gn_fwd_plan, group_norm_silu
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
        # sdxl_base's self-attentions at its CFG batch of 8: row strides 640
        # and 1280
        (8, 4096, 10, 64, torch.bfloat16, 2e-3, 2**-6),
        (8, 1024, 20, 64, torch.bfloat16, 2e-3, 2**-6),
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


def _gn_bwd_inputs(g, b, c, hh, ww, dtype):
    """x, dy and the forward's statistics; gamma is bf16-representable, so that
    its fp32 and bf16 forms hold the same values."""
    x = (torch.randn(b, c, hh, ww, device="cuda", generator=g) * 2 + 0.5).to(dtype)
    dy = torch.randn(b, c, hh, ww, device="cuda", generator=g).to(dtype)
    gamma = (torch.randn(c, device="cuda", generator=g) * 0.5 + 1.0).bfloat16().float()
    beta = torch.randn(c, device="cuda", generator=g) * 0.1
    _, mean_c, inv_c = gn_primal(x, gamma, beta, 32, 1e-5)
    return x, dy, mean_c, inv_c, gamma


# (B, C, H, W, dtype, CTAs a cluster): each cluster size, with shares that
# split a channel (2.5, 1.5, 3.25, 0.75, 0.75, 0.625 channels a CTA); the fp32
# spans at 8 are over the 64 KB budget (96, 80 and 128 KB a CTA)
GN_CLUSTER_SHAPES = [
    (2, 64, 64, 64, torch.bfloat16, 1),
    (2, 160, 64, 64, torch.bfloat16, 2),
    (2, 96, 64, 64, torch.float32, 2),
    (2, 416, 64, 64, torch.bfloat16, 4),
    (2, 96, 96, 96, torch.float32, 4),
    (2, 192, 128, 128, torch.bfloat16, 8),
    (2, 192, 128, 128, torch.float32, 8),
    (2, 160, 128, 128, torch.float32, 8),
    (1, 1024, 64, 64, torch.float32, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,hh,ww,dtype,k", GN_CLUSTER_SHAPES)
def test_cuda_gn_bwd_cluster_shapes_match_plain(b, c, hh, ww, dtype, k):
    """Kernel 6 where a span takes one CTA or a cluster of 2, 4 or 8: one
    launch per call; dx, and dgamma / dbeta in fp32, within the limits; in
    bf16 (a bf16 gamma) exactly the fp32 results cast with ``.to``."""
    g = _card()
    assert gn_bwd_plan(b, c, hh, ww, dtype, 32).cluster == k
    x, dy, mean_c, inv_c, gamma = _gn_bwd_inputs(g, b, c, hh, ww, dtype)
    before = group_norm_bwd.launches
    got = group_norm_bwd(x, dy, mean_c, inv_c, gamma, 32)
    got16 = group_norm_bwd(x, dy, mean_c, inv_c, gamma.bfloat16(), 32, param_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert group_norm_bwd.launches == before + 2
    want = gn_bwd_reference(x, dy, mean_c, inv_c, gamma, 32)
    assert _within(got[0], want[0], *GN_LIMITS[dtype])
    for x_, y in zip(got[1:], want[1:]):
        assert x_.dtype == torch.float32 and x_.shape == (c,)
        assert _within(x_, y, *GN_PARAM_LIMIT)
    assert torch.equal(got16[0], got[0])
    for x_, y in zip(got16[1:], got[1:]):
        assert x_.dtype == torch.bfloat16 and torch.equal(x_, y.to(torch.bfloat16))


# the plain DDPM and autoencoder train steps' shapes (fp32, batch 16) that no
# other path gives kernel 6: (B, C, H, W, groups, CTAs a cluster)
GN_FAMILY_SHAPES = [
    (16, 64, 128, 128, 8, 8),  # the DDPM UNet's final norm: 8 groups, 128 KB a CTA
    (16, 2048, 16, 16, 32, 2),  # its widest concat: 64 channels a group
    (16, 1280, 16, 16, 32, 2),  # 40 a group
    (16, 128, 128, 128, 32, 8),  # the up path's first concat, and the AE decoder's
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,hh,ww,groups,k", GN_FAMILY_SHAPES)
def test_cuda_gn_bwd_family_shapes_match_plain(b, c, hh, ww, groups, k):
    """Kernel 6 at 8 groups and at 64 channels a group, fp32, against
    ``gn_bwd_reference``; then through ``GroupNorm32``'s autograd, as a train
    step runs it, one launch a backward."""
    from polyffusion_tpu_torch.models.unet import GroupNorm32

    g = _card()
    assert gn_bwd_plan(b, c, hh, ww, torch.float32, groups).cluster == k
    x = torch.randn(b, c, hh, ww, device="cuda", generator=g) * 2 + 0.5
    dy = torch.randn(b, c, hh, ww, device="cuda", generator=g)
    gamma = torch.randn(c, device="cuda", generator=g) * 0.5 + 1.0
    beta = torch.randn(c, device="cuda", generator=g) * 0.1
    _, mean_c, inv_c = gn_primal(x, gamma, beta, groups, 1e-5)
    before = group_norm_bwd.launches
    got = group_norm_bwd(x, dy, mean_c, inv_c, gamma, groups)
    torch.cuda.synchronize()
    assert group_norm_bwd.launches == before + 1
    want = gn_bwd_reference(x, dy, mean_c, inv_c, gamma, groups)
    assert _within(got[0], want[0], *GN_LIMITS[torch.float32])
    for x_, y in zip(got[1:], want[1:]):
        assert _within(x_, y, *GN_PARAM_LIMIT)
    gn = GroupNorm32(c, groups=groups).cuda()
    with torch.no_grad():
        gn.weight.copy_(gamma)
        gn.bias.copy_(beta)
    xl = x.clone().requires_grad_()
    gn(xl).backward(dy)
    assert group_norm_bwd.launches == before + 2
    assert _within(xl.grad, want[0], *GN_LIMITS[torch.float32])
    assert _within(gn.weight.grad, want[1], *GN_PARAM_LIMIT)


@pytest.mark.cuda
def test_cuda_gn_bwd_is_deterministic():
    """The in-kernel sum over B adds the items in a fixed order: two calls
    give the same bits."""
    g = _card()
    x, dy, mean_c, inv_c, gamma = _gn_bwd_inputs(g, 16, 192, 64, 64, torch.bfloat16)
    a = group_norm_bwd(x, dy, mean_c, inv_c, gamma, 32)
    b = group_norm_bwd(x, dy, mean_c, inv_c, gamma, 32)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
def test_cuda_gn_bwd_refuses_a_span_no_cluster_holds():
    """64 channels of 128 x 128 fp32 a group (8 MB of x and dy) exceed eight
    CTAs' shared memory: the wrapper raises and launches nothing."""
    _card()
    x = torch.zeros(1, 2048, 128, 128, device="cuda")
    stats = torch.zeros(1, 2048, device="cuda")
    before = group_norm_bwd.launches
    with pytest.raises(ValueError, match="does not fit"):
        group_norm_bwd(x, x, stats, stats, torch.ones(2048, device="cuda"), 32)
    assert group_norm_bwd.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 64])
def test_cuda_repaint_epilogue_after_queued_predecessor(b):
    """Kernel 7 launched right behind the kernel that writes its eps (the CFG
    combine of ``make_eps_fn``) while the card is still busy, so that it is
    queued before eps exists: it must wait for eps (programmatic dependent
    launch) and match the plain version on the finished eps."""
    g = _card()
    cfg = load_params("sdf_chd8bar")
    scalars = _epilogue_scalars(make_schedule(cfg.n_steps, cfg.linear_start, cfg.linear_end), 500)
    shape = (b, 2, 128, 128)
    x, e_u, e_c, p_noise, q_noise = (torch.randn(shape, device="cuda", generator=g)
                                     for _ in range(5))
    orig = (torch.rand(shape, device="cuda", generator=g) < 0.05).float()
    mask = (torch.rand(shape, device="cuda", generator=g) < 0.5).float()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)  # the card stays busy while the host queues
    eps = e_u + 5.0 * (e_c - e_u)
    got = fused_repaint_epilogue(x, eps, p_noise, orig, q_noise, mask, scalars)
    torch.cuda.synchronize()
    want = repaint_epilogue_reference(x, eps, p_noise, orig, q_noise, mask, scalars)
    assert _within(got, want, *EPI_LIMIT)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [2, 64])
def test_cuda_repaint_epilogue_after_early_trigger(b):
    """Kernel 7 behind a predecessor that lets it start at once and writes its
    eps 1 ms later (``early_trigger_copy``): it must read eps only after
    griddepcontrol.wait, and so match the plain version on the written eps."""
    import ctypes

    from polyffusion_tpu_torch.ops._build import load

    g = _card()
    copy = load("repaint_epilogue").early_trigger_copy
    copy.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_ulonglong,
                     ctypes.c_void_p]
    copy.restype = ctypes.c_int
    cfg = load_params("sdf_chd8bar")
    scalars = _epilogue_scalars(make_schedule(cfg.n_steps, cfg.linear_start, cfg.linear_end), 500)
    shape = (b, 2, 128, 128)
    x, eps, p_noise, q_noise = (torch.randn(shape, device="cuda", generator=g) for _ in range(4))
    orig = (torch.rand(shape, device="cuda", generator=g) < 0.05).float()
    mask = (torch.rand(shape, device="cuda", generator=g) < 0.5).float()
    late = torch.zeros_like(eps)
    torch.cuda.synchronize()
    fused_repaint_epilogue(x, eps, p_noise, orig, q_noise, mask, scalars)  # loads the module
    torch.cuda.synchronize()
    assert copy(eps.data_ptr(), late.data_ptr(), eps.numel(), 1_000_000,
                torch.cuda.current_stream().cuda_stream) == 0
    got = fused_repaint_epilogue(x, late, p_noise, orig, q_noise, mask, scalars)
    torch.cuda.synchronize()
    want = repaint_epilogue_reference(x, eps, p_noise, orig, q_noise, mask, scalars)
    assert _within(got, want, *EPI_LIMIT)


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


# (B, C1, C2, O, H, W): main-path sites, then shapes the kernels mask: O off
# the 64 / 128 / 256 channel tiles (80, 48, 192, 136), channels off the 64- and
# 128-channel chunks and C1 off 16 (96, 40 + 24, 72 + 40), H and W off the
# 8-wide pixel tiles (12 x 20, 10 x 10, 24 x 40), W odd (rows not 16-byte
# aligned: 9 x 13), batch 1
GN_CONV_SHAPES = [
    (2, 64, 0, 64, 128, 128),
    (2, 128, 64, 64, 128, 128),
    (2, 64, 0, 128, 64, 64),
    (2, 256, 256, 256, 16, 16),
    (3, 64, 32, 64, 8, 8),
    (2, 96, 0, 80, 12, 20),
    (2, 40, 24, 48, 10, 10),
    (2, 64, 0, 192, 16, 16),
    (2, 72, 40, 136, 24, 40),
    (2, 64, 0, 64, 9, 13),
    (1, 128, 0, 128, 32, 32),
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


# -- the VAE pretraining tasks (no kernel of the port: plain PyTorch on the card) --------


def _vae_batch(name, b, g):
    """A (prmat2c, pnotree, chord, prmat) batch with the task's field only."""
    empty = torch.zeros(b, 1)
    if name == "chd_8bar":
        chord = torch.zeros(b, 32, 36)
        rows = torch.arange(32)
        for i in range(b):
            chord[i, rows, torch.randint(0, 12, (32,), generator=g)] = 1
            chord[i, :, 12:24] = torch.randint(0, 2, (32, 12), generator=g).float()
            chord[i, rows, 24 + torch.randint(0, 12, (32,), generator=g)] = 1
        return empty, empty, chord, empty
    pt = torch.full((b, 128, 20, 6), 2, dtype=torch.long)
    pt[..., 0] = 130
    for i in range(b):
        for t in range(128):
            n = int(torch.randint(0, 9, (), generator=g))
            pt[i, t, :n, 0] = torch.randint(0, 128, (n,), generator=g)
            pt[i, t, :n, 1:] = torch.randint(0, 2, (n, 5), generator=g)
            if n < 20:
                pt[i, t, n, 0] = 129
    return empty, pt, empty, empty


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["chd_8bar", "pnotree_vae"])
def test_cuda_vae_loss_and_gradients_match_the_cpu(name):
    """One fp32 loss and its gradients, card against CPU: the same weights,
    batch, noise and teacher-forcing coins, at a small width (``chd_8bar``
    hidden 32; ``pnotree_vae`` at its fixed widths, one item of four
    segments), within the limits of ``chip_smoke.py``'s step check (loss rel
    1e-5, gradients rel 1e-4 in norm per tensor)."""
    from polyffusion_tpu_torch.main import build_task

    _card()
    cfg = load_params(name)
    if name == "chd_8bar":
        cfg.update(chd_hidden_dim=32, chd_z_input_dim=32, chd_z_dim=16)
    g = torch.Generator().manual_seed(1)
    batch = _vae_batch(name, 4 if name == "chd_8bar" else 1, g)
    out = {}
    for device in ("cuda", "cpu"):
        task = build_task(cfg, device=device, seed=2)
        noise = task.draw_noise(batch, torch.Generator().manual_seed(3),
                                {"tfr_chd": 0.5, "tfr_pnt1": 0.8, "tfr_pnt2": 0.8})
        loss, metrics = task.loss_fn(tuple(t.to(device) for t in batch),
                                     type(noise)(*(t.to(device) for t in noise)))
        loss.backward()
        out[device] = ({k: v.item() for k, v in metrics.items()},
                       {k: p.grad.cpu() for k, p in task.model.named_parameters()})
    (got_m, got_g), (want_m, want_g) = out["cuda"], out["cpu"]
    for k, w in want_m.items():
        assert abs(got_m[k] - w) <= 1e-5 * abs(w), (k, got_m[k], w)
    for k, w in want_g.items():
        assert (got_g[k] - w).norm() <= 1e-4 * w.norm() + 1e-9, k


# -- distillation: kernels 1, 2 and 6 under the teacher's and the student's passes ---------


@pytest.mark.cuda
@pytest.mark.parametrize("mode,kind", [("guided", "eps_guided"), ("halve", "v")])
def test_cuda_distill_loss_and_gradients_match_the_cpu(mode, kind):
    """One fp32 distillation loss and the student's gradients, card against
    CPU: a small ``sdf_chdvnl`` (64 channels, one level attending over 1024
    tokens, one head of 64), the same student and teacher weights, batch and
    draws, within the limits of ``chip_smoke.py``'s step check (loss rel
    1e-5, gradients rel 1e-4 in norm per tensor); the card's passes launch
    kernels 1, 2 and 6."""
    from polyffusion_tpu_torch.diffusion.progressive import halving_grids, phase_tables
    from polyffusion_tpu_torch.main import build_task
    from polyffusion_tpu_torch.tasks.distill import DistillTask

    _card()
    cfg = load_params("sdf_chdvnl")
    cfg.update(bf16=False, channels=64, attention_levels=[0], channel_multipliers=[1],
               n_res_blocks=1, n_heads=1)
    g = torch.Generator().manual_seed(1)
    x0 = (torch.rand(2, 2, 32, 32, generator=g) > 0.9).float()
    chord = torch.zeros(2, 32, 36)
    chord[:, torch.arange(32), torch.randint(0, 36, (32,), generator=g)] = 1
    empty = torch.zeros(2, 1)
    teacher = build_task(cfg, device="cpu", seed=3).unet.state_dict()
    out, launches = {}, {}
    for device in ("cuda", "cpu"):
        base = build_task(cfg, device=device, seed=2)
        tables = phase_tables(base.schedule, halving_grids(1000, 8, 2)[0])
        task = DistillTask(base, teacher, 5.0, mode, kind,
                           tables=tables if mode == "halve" else None)
        noise = task.draw_noise((x0,), torch.Generator().manual_seed(4))
        before = (packed_self_attention.launches, packed_attention_bwd.launches,
                  group_norm_bwd.launches)
        loss, _ = task.loss_fn(tuple(t.to(device) for t in (x0, empty, chord, empty)),
                               type(noise)(*(t.to(device) for t in noise)))
        loss.backward()
        launches[device] = [n - b for n, b in zip((packed_self_attention.launches,
                                                   packed_attention_bwd.launches,
                                                   group_norm_bwd.launches), before)]
        out[device] = (loss.item(), {k: p.grad.cpu() for k, p in task.model.named_parameters()})
    (got, got_g), (want, want_g) = out["cuda"], out["cpu"]
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    for k, w in want_g.items():
        assert (got_g[k] - w).norm() <= 1e-4 * w.norm() + 1e-9, k
    assert min(launches["cuda"]) > 0 and launches["cpu"] == [0, 0, 0], launches


# Kernel 8 (ops/gn_fwd.py). The sdf_chd8bar UNet's GroupNorm sites at batch 2:
# (C, H, W, channels-last); the layout is the one the site has in the model
# (the convolutions after a SpatialTransformer leave channels-last)
GN_FWD_SITES = [
    (64, 128, 128, False), (64, 64, 64, False), (128, 64, 64, False), (128, 32, 32, False),
    (256, 32, 32, False), (384, 32, 32, False), (384, 64, 64, False), (256, 64, 64, False),
    (192, 64, 64, False), (192, 128, 128, False), (128, 128, 128, False),
    (256, 32, 32, True), (256, 16, 16, True), (512, 16, 16, True), (512, 32, 32, True),
]
# the plain DDPM and autoencoder families' shapes: (B, C, H, W, groups)
GN_FWD_FAMILY = [(2, 64, 128, 128, 8), (2, 2048, 16, 16, 32), (2, 1280, 16, 16, 32),
                 (2, 128, 128, 128, 32)]
MANTISSA_BITS = {torch.bfloat16: 7, torch.float32: 23}
# kernel 8 against its plain version, in ulps of the affine's largest operand
# (``_ulps``). bf16: a that rounds the other way (the statistics summed in
# another order) moves x * a by up to 2 ulps of it, off by one, and z's
# rounding one more (the card read at most 3, chip_smoke.py's shapes).
# fp32: the order moves a and off by a few fp32 ulps, each up to 2 of x * a
# (the card read at most 7, batch 2)
GN_FWD_ULPS = {torch.bfloat16: 4, torch.float32: 16}


def _gn_fwd_inputs(g, b, c, h, w, dtype, channels_last, exact):
    """x, weight, bias. ``exact``: x in eighths of at most 1.5, whose sums
    and sums of squares fp32 holds exactly in any order, so the kernel's and
    the plain version's statistics are the same bits."""
    if exact:
        x = torch.randint(-8, 13, (b, c, h, w), device="cuda", generator=g).float() / 8
    else:
        x = torch.randn(b, c, h, w, device="cuda", generator=g) * 2 + 0.5
    x = x.to(dtype)
    if channels_last:
        x = x.contiguous(memory_format=torch.channels_last)
    weight = torch.randn(c, device="cuda", generator=g) * 0.5 + 1.0
    bias = torch.randn(c, device="cuda", generator=g) * 0.1
    return x, weight, bias


def _gn_fwd_plain(x, weight, bias, groups, eps, silu):
    y = gn_primal(x, weight, bias, groups, eps)[0]
    return torch.nn.functional.silu(y) if silu else y


def _ulps(got, want, x, weight, bias, groups, eps):
    """|got - want| in units of the last place, in x's dtype, of the largest
    operand of the affine at each element (|x * a|, |beta|, |mean * a|,
    |want|): the statistics summed in another order move a and off by an
    ulp or so of those, however far x * a + off, or beta - mean * a,
    cancels."""
    a, off = gn_affine(x, weight, bias, groups, eps)
    per_channel = torch.maximum(bias.float().abs().expand_as(off), (bias.float() - off).abs())
    scale = torch.maximum((x.float() * a[:, :, None, None]).abs(),
                          per_channel[:, :, None, None].expand_as(x))
    scale = torch.maximum(scale, want.float().abs()).clamp_min(2.0**-100)
    ulp = torch.ldexp(torch.ones_like(scale),
                      torch.frexp(scale).exponent - 1 - MANTISSA_BITS[x.dtype])
    return ((got.float() - want.float()).abs() / ulp)


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [False, True], ids=["", "silu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("site", GN_FWD_SITES, ids=lambda s: "x".join(map(str, s[:3]))
                         + ("-cl" if s[3] else ""))
def test_cuda_gn_fwd_matches_plain(site, dtype, silu):
    """Kernel 8 against its plain version at the sdf_chd8bar sites. With
    exact statistics (x in eighths) every element is bit-equal. On Gaussian
    x, whose fp32 sums the two take in other orders, within ``GN_FWD_ULPS``
    (``_ulps``), and in bf16 at least 99.9 % bit-equal. A channels-last
    shape the channels-last plan refuses (fp32 (512, 32, 32): 2 MB an item)
    runs the NCHW kernel on a copy, and y comes back channels-last."""
    c, h, w, cl = site
    g = _card()
    eps = 1e-6 if (c, h, w, cl) == (256, 32, 32, False) else 1e-5
    for exact in (True, False):
        x, weight, bias = _gn_fwd_inputs(g, 2, c, h, w, dtype, cl, exact)
        before = (group_norm_silu.launches, group_norm_silu.silu_launches)
        got = group_norm_silu(x, weight, bias, 32, eps, silu)
        torch.cuda.synchronize()
        assert (group_norm_silu.launches, group_norm_silu.silu_launches) == (
            before[0] + 1, before[1] + int(silu))
        want = _gn_fwd_plain(x, weight, bias, 32, eps, silu)
        assert got.dtype == dtype and got.stride() == x.stride()
        if exact:
            assert torch.equal(got, want), (got.float() - want.float()).abs().max()
            continue
        ulps = _ulps(got, want, x, weight, bias, 32, eps).max().item()
        equal = (got == want).float().mean().item()
        assert ulps <= GN_FWD_ULPS[dtype], (ulps, equal)
        assert dtype == torch.float32 or equal >= 0.999, (ulps, equal)


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [False, True], ids=["", "silu"])
@pytest.mark.parametrize("b,c,h,w,groups", GN_FWD_FAMILY)
def test_cuda_gn_fwd_family_shapes_match_plain(b, c, h, w, groups, silu):
    """Kernel 8 at the DDPM and autoencoder shapes, fp32: 8 groups, and 64
    channels a group; exact statistics bit-equal, Gaussian x within
    ``GN_FWD_ULPS``."""
    g = _card()
    for exact in (True, False):
        x, weight, bias = _gn_fwd_inputs(g, b, c, h, w, torch.float32, False, exact)
        got = group_norm_silu(x, weight, bias, groups, 1e-5, silu)
        want = _gn_fwd_plain(x, weight, bias, groups, 1e-5, silu)
        if exact:
            assert torch.equal(got, want)
        else:
            ulps = _ulps(got, want, x, weight, bias, groups, 1e-5).max().item()
            assert ulps <= GN_FWD_ULPS[torch.float32], ulps


# sdxl_base's GroupNorm shapes at its CFG batch of 8, NCHW as its UNet holds
# them: (C, H, W, the plan's cluster); 30 channels a group at 128^2 is a span
# of 960 KB on eight CTAs, the decoder's 2560-channel inputs 80 a group
SDXL_GN_FWD_SITES = [
    (320, 128, 128, 8), (320, 64, 64, 2), (640, 128, 128, 8), (640, 64, 64, 4),
    (640, 32, 32, 1), (960, 128, 128, 8), (960, 64, 64, 4), (1280, 64, 64, 8),
    (1280, 32, 32, 2), (1920, 64, 64, 8), (1920, 32, 32, 2), (2560, 32, 32, 4),
]


@pytest.mark.cuda
@pytest.mark.parametrize("silu", [False, True], ids=["", "silu"])
@pytest.mark.parametrize("site", SDXL_GN_FWD_SITES, ids=lambda s: "x".join(map(str, s[:3])))
def test_cuda_gn_fwd_sdxl_shapes_match_plain(site, silu):
    """Kernel 8 at every sdxl_base GroupNorm shape, bf16, batch 8, one
    launch a call: exact statistics bit-equal, Gaussian x within
    ``GN_FWD_ULPS`` and at least 99.9 % bit-equal."""
    c, h, w, k = site
    g = _card()
    assert gn_fwd_plan(c, h, w, torch.bfloat16, 32, False).cluster == k
    for exact in (True, False):
        x, weight, bias = _gn_fwd_inputs(g, 8, c, h, w, torch.bfloat16, False, exact)
        before = (group_norm_silu.launches, group_norm_silu.silu_launches)
        got = group_norm_silu(x, weight, bias, 32, 1e-5, silu)
        torch.cuda.synchronize()
        assert (group_norm_silu.launches, group_norm_silu.silu_launches) == (
            before[0] + 1, before[1] + int(silu))
        want = _gn_fwd_plain(x, weight, bias, 32, 1e-5, silu)
        if exact:
            assert torch.equal(got, want), (got.float() - want.float()).abs().max()
            continue
        ulps = _ulps(got, want, x, weight, bias, 32, 1e-5).max().item()
        equal = (got == want).float().mean().item()
        assert ulps <= GN_FWD_ULPS[torch.bfloat16] and equal >= 0.999, (ulps, equal)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,groups,layout", [
    ((1, 8192, 8, 8), 32, "nchw"),        # 256 channels a group
    ((1, 64, 128, 128), 1, "nchw"),       # a span no cluster holds (4 MB)
    ((1, 64, 8, 8), 32, "strided"),       # neither layout
])
def test_cuda_group_norm_raises_where_kernel_8_cannot_take_it(shape, groups, layout):
    """Outside autograd a model's GroupNorm on the card is kernel 8 or an
    error, never the plain code; under autograd it is the plain forward."""
    from polyffusion_tpu_torch.models.unet import GroupNorm32

    g = _card()
    x = torch.randn(shape, device="cuda", generator=g)
    if layout == "strided":
        x = torch.randn(shape[0], shape[1], shape[2], 2 * shape[3], device="cuda",
                        generator=g)[..., ::2]
    gn = GroupNorm32(shape[1], groups=groups).cuda()
    before = group_norm_silu.launches
    with torch.inference_mode(), pytest.raises(ValueError, match="kernel 8 does not take"):
        gn(x)
    assert group_norm_silu.launches == before
    assert gn(x).grad_fn is not None


@pytest.mark.cuda
@pytest.mark.parametrize("cl", [False, True], ids=["nchw", "cl"])
def test_cuda_gn_fwd_is_deterministic(cl):
    """The statistics are added in a fixed order, across the cluster too:
    two launches give the same bits."""
    g = _card()
    x, weight, bias = _gn_fwd_inputs(g, 16, 512 if cl else 192, 32 if cl else 128,
                                     32 if cl else 128, torch.bfloat16, cl, False)
    assert gn_fwd_plan(*x.shape[1:], torch.bfloat16, 32, cl).cluster == (8 if cl else 4)
    a = group_norm_silu(x, weight, bias, 32, 1e-5, True)
    b = group_norm_silu(x, weight, bias, 32, 1e-5, True)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_gn_fwd_refuses_strided_and_oversized_inputs():
    """On the card the wrapper raises on a layout the kernel does not take,
    and on a span no cluster holds; it launches nothing and falls back to
    nothing."""
    _card()
    weight, bias = torch.ones(64, device="cuda"), torch.zeros(64, device="cuda")
    strided = torch.zeros(2, 64, 16, 32, device="cuda")[..., ::2]
    big = torch.zeros(1, 64, 128, 128, device="cuda")  # one group of 4 MB
    before = group_norm_silu.launches
    with pytest.raises(ValueError, match="channels-last"):
        group_norm_silu(strided, weight, bias, 32, 1e-5)
    with pytest.raises(ValueError, match="does not fit"):
        group_norm_silu(big, weight, bias, 1, 1e-5)
    assert group_norm_silu.launches == before


@pytest.mark.cuda
def test_cuda_unet_sampling_eval_runs_kernel_8_at_every_norm():
    """The sdf_chd8bar UNet in its sampling precision on the card: under
    ``inference_mode`` 56 launches an evaluation, 45 with the SiLU, and the
    output close to the autograd forward's (the statistics summed in
    another order); under autograd none."""
    from polyffusion_tpu_torch.models.unet import UNetModel
    from polyffusion_tpu_torch.utils.precision import cast_sampling_params

    g = _card()
    tm = cast_sampling_params(UNetModel(channels=64, attention_levels=(2, 3),
                                        channel_multipliers=(1, 2, 4, 4), n_heads=4,
                                        d_cond=512).cuda().eval())
    args = (torch.randn(2, 2, 128, 128, device="cuda", generator=g),
            torch.tensor([3, 977], device="cuda"),
            torch.randn(2, 1, 512, device="cuda", generator=g).bfloat16())
    before = (group_norm_silu.launches, group_norm_silu.silu_launches)
    with torch.inference_mode():
        fast = tm(*args)
    torch.cuda.synchronize()
    assert (group_norm_silu.launches - before[0], group_norm_silu.silu_launches - before[1]) == (
        56, 45)
    slow = tm(*args)
    assert group_norm_silu.launches - before[0] == 56
    rel = (fast - slow.detach()).norm() / slow.detach().norm()
    assert rel < 2e-2, rel
