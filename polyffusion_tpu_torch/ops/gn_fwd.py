"""GroupNorm forward, and the SiLU after it, in one pass: kernel 8.

``group_norm_silu`` is ``gn_primal``'s output (``ops/gn_bwd.py``: one-pass
fp32 statistics, the fp32 affine applied in x's dtype), then ``F.silu`` where
``silu`` is set. On a CUDA tensor it is one launch of ``csrc/gn_fwd.cu``,
which reads x once and writes y once; on a CPU tensor it runs that plain
code. It has no gradient: the models take it only outside autograd
(``kernel_takes``), and their training steps keep ``group_norm_affine`` and
its backward kernel. The JAX package has no such kernel: on the TPU XLA
fused this work into its neighbours.

x is NCHW, contiguous or channels-last (``torch.channels_last``): the
convolutions after a SpatialTransformer leave the latter, and y keeps x's
layout. A channels-last x whose item no cluster holds (fp32 (512, 32, 32):
2 MB), or whose groups the channels-last kernel does not take, runs the NCHW
kernel on a contiguous copy, and y is copied back to channels-last.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from .. import tracing
from .gn_bwd import ClusterPlan, cluster_plan, gn_primal

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHANNELS_PER_GROUP = 128  # NCHW: the kernel's table of a and off
MAX_GROUPS = 64  # channels-last: a CTA holds every group of its positions
THREADS = 256  # channels-last: a thread per 16-byte channel vector of a position
# where ``kernel_takes`` sends a model's GroupNorm to ``group_norm_silu`` (the
# CPU tests add "cpu", whose plain code then stands in for the kernel)
KERNEL_DEVICES = ("cuda",)

_entry = []  # the C entry point, with its argument types set once


@functools.lru_cache(maxsize=None)
def gn_fwd_plan(c: int, h: int, w: int, dtype: torch.dtype, groups: int,
                channels_last: bool) -> ClusterPlan:
    """``ops/gn_bwd.py:cluster_plan`` of one span of x (NCHW: an (item,
    group); channels-last: an item, its shares whole positions). Raises
    ``ValueError`` for a shape the kernel does not take."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"x must be float32 or bfloat16, got {dtype}")
    if groups <= 0 or c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    if (h * w) % 8:
        raise ValueError(f"H * W = {h * w} is not a multiple of 8")
    cg = c // groups
    if channels_last:
        vec = 16 // dtype.itemsize
        if groups > MAX_GROUPS or cg % vec or c // vec > THREADS:
            raise ValueError(
                f"channels-last: the kernel takes at most {MAX_GROUPS} groups of a multiple of "
                f"{vec} channels and {THREADS * vec} channels, got {groups} groups of {c}")
        span, unit = c * h * w, c
    else:
        if cg > MAX_CHANNELS_PER_GROUP:
            raise ValueError(f"{c} channels in {groups} groups: the kernel takes at most "
                             f"{MAX_CHANNELS_PER_GROUP} channels per group")
        span, unit = cg * h * w, 8
    return cluster_plan(span, dtype.itemsize, tensors=1, unit=unit)


def _layout(x: torch.Tensor) -> bool:
    """True for channels-last x, False for contiguous NCHW; raises otherwise."""
    if x.is_contiguous():
        return False
    if x.is_contiguous(memory_format=torch.channels_last):
        return True
    raise ValueError(f"x must be contiguous NCHW or channels-last, got strides {x.stride()}")


def _plan(x: torch.Tensor, groups: int) -> Tuple[ClusterPlan, bool]:
    """The plan of x's spans, and whether the kernel reads x channels-last
    (False for a channels-last x that runs as an NCHW copy)."""
    c, h, w = x.shape[1:]
    if _layout(x):
        try:
            return gn_fwd_plan(c, h, w, x.dtype, groups, True), True
        except ValueError:
            pass
    return gn_fwd_plan(c, h, w, x.dtype, groups, False), False


def _check(x, weight, bias, groups: int) -> Tuple[ClusterPlan, bool]:
    if x.dim() != 4:
        raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
    c = x.shape[1]
    plan = _plan(x, groups)
    for name, v in (("weight", weight), ("bias", bias)):
        if v.shape != (c,) or v.dtype not in _DTYPE_CODES or not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous float32 or bfloat16 of shape {(c,)}, "
                             f"got {v.dtype} {tuple(v.shape)}")
    if weight.dtype != bias.dtype:
        raise ValueError(f"weight and bias must share a dtype, got {weight.dtype}, {bias.dtype}")
    if weight.device != x.device or bias.device != x.device:
        raise ValueError("x, weight and bias must lie on one device")
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"group_norm_silu runs on cuda or cpu, not {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    return plan


def kernel_takes(x: torch.Tensor, groups: int) -> bool:
    """Whether a model's GroupNorm runs kernel 8 on ``x``: a CUDA tensor
    outside autograd (``torch.no_grad`` or ``inference_mode``: the samplers).
    A CUDA tensor there whose dtype, shape, layout or alignment the plan
    does not hold raises ``ValueError``: the card runs no plain GroupNorm
    in a sampler. (A CPU tensor, where the tests widen ``KERNEL_DEVICES``,
    keeps the plain code instead.)"""
    if x.device.type not in KERNEL_DEVICES or torch.is_grad_enabled() or x.numel() == 0:
        return False
    try:
        if x.dim() != 4:
            raise ValueError(f"x must be (B, C, H, W), got {tuple(x.shape)}")
        if x.data_ptr() % 16:
            raise ValueError("x must be 16-byte aligned")
        _plan(x, groups)
    except ValueError as e:
        if x.device.type == "cuda":
            raise ValueError(f"kernel 8 does not take this GroupNorm of {groups} groups over "
                             f"{x.dtype} {tuple(x.shape)} strides {x.stride()}: {e}") from e
        return False
    return True


def group_norm_silu(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
    silu: bool = False,
) -> torch.Tensor:
    """``gn_primal(x, weight, bias, groups, eps)[0]``, then ``F.silu`` where
    ``silu``, in x's dtype and layout. No gradient flows through it.

    On a CUDA tensor this is one launch of the kernel (and raises if it
    cannot), with a copy each way where a channels-last x runs as NCHW; on
    a CPU tensor it runs the plain code."""
    plan, nhwc = _check(x, weight, bias, groups)
    if x.device.type == "cpu":
        y = gn_primal(x, weight, bias, groups, eps)[0]
        return F.silu(y) if silu else y
    b, c, h, w = x.shape
    xk = x if nhwc else x.contiguous()
    if not _entry:
        from ._build import load

        fn = load("gn_fwd").gn_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _entry.append(fn)
    y = torch.empty_like(xk)
    with torch.cuda.device(x.device):
        err = _entry[0](xk.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
                        b, c, groups, h * w, plan.cluster, plan.share, plan.chunk,
                        _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype],
                        int(nhwc), int(silu), eps,
                        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gn_fwd launch failed: cudaError {err}")
    group_norm_silu.launches += 1
    group_norm_silu.silu_launches += int(silu)
    return y if xk is x else y.contiguous(memory_format=torch.channels_last)


group_norm_silu.launches = 0
group_norm_silu.silu_launches = 0
tracing.register("ops.group_norm_silu.launches", group_norm_silu, "launches")
tracing.register("ops.group_norm_silu.silu_launches", group_norm_silu, "silu_launches")
