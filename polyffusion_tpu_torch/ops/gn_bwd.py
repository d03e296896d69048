"""GroupNorm + per-channel affine over NCHW with a CUDA backward.

Counterpart of ``polyffusion_tpu/ops/gn_bwd.py``: ``group_norm_affine`` is its
custom VJP of the same name, whose forward is the UNet's one-pass GroupNorm
(``models/unet.py:GroupNorm32``) bit for bit and which saves the per-channel
fp32 mean and inverse std for the backward, as ``_gna_fwd`` does. The backward
kernel (``csrc/gn_bwd.cu``) replaces ``_gn_bwd_kernel``; its plain version
``gn_bwd_reference`` is the XLA branch of ``_gna_bwd``.

The JAX package keeps this backward opt-in, because on the TPU XLA fused the
analytic backward into neighbouring work and won. The port runs eagerly with
no such fusion, so on a CUDA tensor every GroupNorm's backward is the kernel.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from .. import tracing
from .s2d import unfold_channel_sums

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS_PER_GROUP = 64  # the kernel's shared-memory tables
# the kernel's split of one (item, group): the shared memory a CTA should fill
# with its share of x and dy (three CTAs an SM, so that one CTA's copies overlap
# another's stores: one CTA of up to 200 KB an SM ran the train step's large
# spans 20-40 % slower on an H100, and more, smaller CTAs a span gained at
# most 5 %), and the most it may fill where no cluster's share fits that (of
# the 227 KB a block may take, leaving room for the barriers and tables)
SMEM_BUDGET = 64 * 1024
SMEM_LIMIT = 200 * 1024
CLUSTER_SIZES = (1, 2, 4, 8)
CHUNK_BYTES = 16 * 1024  # of one tensor a bulk copy: a share arrives in at most 16 chunks

_entry = []  # the C entry point, with its argument types set once
_TICKETS: Dict[torch.device, torch.Tensor] = {}  # per device: the kernel's group counters


def _channel_sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x32 = x.float()
    return x32.sum(dim=(2, 3)), (x32 * x32).sum(dim=(2, 3))


def _affine32(s1, s2, n_spatial: int, weight, bias, groups: int, eps: float):
    """(a, off, mean_c, inv_c), all fp32 (B, C), from per-channel sums over
    ``n_spatial`` positions: y = x * a + off is the normalised, scaled and
    shifted x."""
    b, c = s1.shape
    g = groups
    n = n_spatial * (c // g)
    mean = s1.view(b, g, c // g).sum(-1) / n
    meansq = s2.view(b, g, c // g).sum(-1) / n
    inv = torch.rsqrt(torch.clamp(meansq - mean * mean, min=0.0) + eps)
    inv_c = inv.repeat_interleave(c // g, dim=1)
    mean_c = mean.repeat_interleave(c // g, dim=1)
    scale = weight.float()
    return inv_c * scale, bias.float() - mean_c * inv_c * scale, mean_c, inv_c


def gn_primal(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """GroupNorm with one-pass fp32 statistics (E[x^2] - E[x]^2) whose
    per-channel affine is folded in fp32 and applied in x's dtype. Returns
    (y, mean_c, inv_c), the statistics fp32 (B, C), repeated per channel."""
    a32, off32, mean_c, inv_c = _affine32(*_channel_sums(x), x[0, 0].numel(), weight, bias,
                                          groups, eps)
    a, off = a32.to(x.dtype), off32.to(x.dtype)
    return x * a[:, :, None, None] + off[:, :, None, None], mean_c, inv_c


def gn_affine(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
    x2: Optional[torch.Tensor] = None, folded: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The GroupNorm of ``x`` as its fp32 per-(batch, channel) affine (a, off),
    y = x * a + off, unrounded: the input of the fused GroupNorm-SiLU-conv
    kernel (``ops/fused_gn_conv.py``), as the JAX package's
    ``FP32GroupNorm(return_affine=True)`` gives it. With ``x2`` the statistics
    are those of the virtual channel concat [x, x2] (never built), and a and
    off span C1 + C2 channels. ``folded``: x and x2 are space-to-depth folded
    (``ops/s2d.py``), and a and off are per unfolded channel (JAX's
    ``FP32GroupNorm(folded=True)``). Differentiable by autograd."""

    def sums(t):
        s1, s2 = _channel_sums(t)
        return (unfold_channel_sums(s1), unfold_channel_sums(s2)) if folded else (s1, s2)

    s1, s2 = sums(x)
    if x2 is not None:
        t1, t2 = sums(x2)
        s1, s2 = torch.cat([s1, t1], dim=1), torch.cat([s2, t2], dim=1)
    n_spatial = x[0, 0].numel() * (2 if folded else 1)
    a, off, _, _ = _affine32(s1, s2, n_spatial, weight, bias, groups, eps)
    return a, off


def gn_bwd_reference(
    x: torch.Tensor, dy: torch.Tensor, mean_c: torch.Tensor, inv_c: torch.Tensor,
    gamma: torch.Tensor, groups: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward (the JAX package's ``_gna_bwd``, XLA branch): (dx in
    x's dtype, dgamma (C,) fp32, dbeta (C,) fp32)."""
    b, c = x.shape[:2]
    cg = c // groups
    n_g = x[0, 0].numel() * cg
    mean4, inv4 = mean_c[:, :, None, None], inv_c[:, :, None, None]
    dy32 = dy.float()
    xh = (x.float() - mean4) * inv4
    dyg = dy32 * gamma.float()[None, :, None, None]
    dbeta = dy32.sum(dim=(0, 2, 3))
    dgamma = (dy32 * xh).sum(dim=(0, 2, 3))

    def group_mean(v):  # (B, C) -> per-group mean repeated to (B, C)
        gsum = v.view(b, groups, cg).sum(-1, keepdim=True)
        return (gsum / n_g).expand(b, groups, cg).reshape(b, c)

    s1 = group_mean(dyg.sum(dim=(2, 3)))[:, :, None, None]
    s2 = group_mean((dyg * xh).sum(dim=(2, 3)))[:, :, None, None]
    dx = inv4 * (dyg - (s1 + xh * s2))
    return dx.to(x.dtype), dgamma, dbeta


class ClusterPlan(NamedTuple):
    """How a kernel splits one span (kernel 6: an (item, group) of x and
    dy; kernel 8, ``ops/gn_fwd.py``: one of x) over ``cluster`` CTAs of
    ``share`` elements each (the last may hold fewer), each share copied in
    chunks of ``chunk`` elements; ``smem`` bytes of shared memory a CTA (each
    tensor's share rounded up to 128 bytes)."""

    cluster: int
    share: int
    chunk: int
    smem: int


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def split_plan(span: int, itemsize: int, k: int, tensors: int = 2, unit: int = 8) -> ClusterPlan:
    """A span of ``span`` elements of each of ``tensors`` tensors over ``k``
    CTAs: shares of a multiple of ``unit`` elements (8: 16-byte aligned in
    either dtype), chunks of ``CHUNK_BYTES``."""
    share = _round_up(-(-span // k), unit)
    return ClusterPlan(k, share, min(share, CHUNK_BYTES // itemsize),
                       tensors * _round_up(share * itemsize, 128))


def cluster_plan(span: int, itemsize: int, tensors: int = 2, unit: int = 8) -> ClusterPlan:
    """The smallest of ``CLUSTER_SIZES`` whose share fits ``SMEM_BUDGET``
    bytes of shared memory a CTA; where none does, the largest cluster, if
    its share fits ``SMEM_LIMIT``. Raises ``ValueError`` where it does not."""
    plans = [split_plan(span, itemsize, k, tensors, unit) for k in CLUSTER_SIZES]
    for plan in plans:
        if plan.smem <= SMEM_BUDGET:
            return plan
    if plans[-1].smem <= SMEM_LIMIT:
        return plans[-1]
    raise ValueError(
        f"a GroupNorm span of {tensors} x {span * itemsize} bytes does not fit "
        f"{CLUSTER_SIZES[-1]} CTAs of {SMEM_LIMIT} bytes of shared memory: the kernel takes at "
        f"most {CLUSTER_SIZES[-1] * SMEM_LIMIT} bytes")


@functools.lru_cache(maxsize=None)
def gn_bwd_plan(b: int, c: int, h: int, w: int, dtype: torch.dtype, groups: int) -> ClusterPlan:
    """``cluster_plan`` of the span of cg * H * W elements that one (item,
    group) of x and dy is."""
    return cluster_plan(c // groups * h * w, dtype.itemsize)


def _check(x, dy, mean_c, inv_c, gamma, groups: int, param_dtype) -> None:
    if x.dim() != 4 or dy.shape != x.shape:
        raise ValueError(f"x and dy must share one (B, C, H, W) shape, got "
                         f"{tuple(x.shape)}, {tuple(dy.shape)}")
    b, c, h, w = x.shape
    if c % groups or c // groups > MAX_CHANNELS_PER_GROUP:
        raise ValueError(f"{c} channels in {groups} groups: the kernel takes at most "
                         f"{MAX_CHANNELS_PER_GROUP} channels per group")
    if (h * w) % 8:
        raise ValueError(f"H * W = {h * w} is not a multiple of 8")
    if dy.dtype != x.dtype or x.dtype not in _DTYPE_CODES:
        raise ValueError(f"x and dy must both be float32 or bfloat16, got {x.dtype}, {dy.dtype}")
    for name, v in (("mean_c", mean_c), ("inv_c", inv_c)):
        if v.shape != (b, c) or v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of shape {(b, c)}, got {v.dtype} "
                             f"{tuple(v.shape)}")
    if gamma.shape != (c,) or gamma.dtype not in _DTYPE_CODES:
        raise ValueError(f"gamma must be float32 or bfloat16 of shape {(c,)}, got {gamma.dtype} "
                         f"{tuple(gamma.shape)}")
    if param_dtype not in _DTYPE_CODES:
        raise ValueError(f"param_dtype must be float32 or bfloat16, got {param_dtype}")
    if any(v.device != x.device for v in (dy, mean_c, inv_c, gamma)):
        raise ValueError("all inputs must lie on one device")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"group_norm_bwd runs on cuda or cpu, not {x.device}")
    for name, v in (("x", x), ("dy", dy), ("mean_c", mean_c), ("inv_c", inv_c), ("gamma", gamma)):
        if not v.is_contiguous() or v.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _tickets(device: torch.device, groups: int) -> torch.Tensor:
    """The kernel's per-group counters on ``device``: int32 zeros, allocated
    once (and again for more groups) and kept; every launch leaves them 0."""
    t = _TICKETS.get(device)
    if t is None or t.numel() < groups:
        t = torch.zeros(max(groups, 32), dtype=torch.int32, device=device)
        _TICKETS[device] = t
    return t


def group_norm_bwd(
    x: torch.Tensor, dy: torch.Tensor, mean_c: torch.Tensor, inv_c: torch.Tensor,
    gamma: torch.Tensor, groups: int, *, param_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dx, dgamma, dbeta) of ``gn_primal`` for the output gradient ``dy``:
    dx in x's dtype, dgamma and dbeta (C,) summed over B, in ``param_dtype``.
    ``gamma`` is the weight in its own dtype (fp32 or bf16).

    On a CUDA tensor this is one launch of the kernel (and raises if it
    cannot); on a CPU tensor it runs ``gn_bwd_reference`` and casts."""
    _check(x, dy, mean_c, inv_c, gamma, groups, param_dtype)
    if x.device.type == "cpu":
        dx, dgamma, dbeta = gn_bwd_reference(x, dy, mean_c, inv_c, gamma, groups)
        return dx, dgamma.to(param_dtype), dbeta.to(param_dtype)
    b, c, h, w = x.shape
    plan = gn_bwd_plan(b, c, h, w, x.dtype, groups)
    if not _entry:
        from ._build import load

        fn = load("gn_bwd").gn_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entry.append(fn)
    dx = torch.empty_like(x)
    dgamma = torch.empty(c, dtype=param_dtype, device=x.device)
    dbeta = torch.empty(c, dtype=param_dtype, device=x.device)
    partials = torch.empty(2, b, c, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _entry[0](x.data_ptr(), dy.data_ptr(), mean_c.data_ptr(), inv_c.data_ptr(),
                        gamma.data_ptr(), dx.data_ptr(), dgamma.data_ptr(), dbeta.data_ptr(),
                        partials.data_ptr(), _tickets(x.device, groups).data_ptr(),
                        b, c, groups, h * w, plan.cluster, plan.share, plan.chunk,
                        _DTYPE_CODES[x.dtype], _DTYPE_CODES[gamma.dtype],
                        _DTYPE_CODES[param_dtype],
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gn_bwd launch failed: cudaError {err}")
    group_norm_bwd.launches += 1
    return dx, dgamma, dbeta


group_norm_bwd.launches = 0
tracing.register("ops.group_norm_bwd.launches", group_norm_bwd, "launches")


class _GroupNormAffine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps):
        y, mean_c, inv_c = gn_primal(x, weight, bias, groups, eps)
        ctx.save_for_backward(x, weight, mean_c, inv_c)
        ctx.groups = groups
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean_c, inv_c = ctx.saved_tensors
        dx, dgamma, dbeta = group_norm_bwd(x.contiguous(), dy.contiguous(), mean_c, inv_c,
                                           weight.contiguous(), ctx.groups,
                                           param_dtype=weight.dtype)
        return dx, dgamma, dbeta, None, None


def group_norm_affine(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float
) -> torch.Tensor:
    """``gn_primal``'s output, differentiable through ``group_norm_bwd``."""
    return _GroupNormAffine.apply(x, weight, bias, groups, eps)
