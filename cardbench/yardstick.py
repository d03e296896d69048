"""The benchmark's frozen arithmetic: the card's published peaks, the least
time of each of the program's kernels (copied from ``chip_smoke.py``), the
table of kernel classes (copied from ``profile_unet.py``), the FLOPs of the
reference models, and the reduction of a profiler trace to busy time, idle
share, classes and idle gaps. A later change to the program's copies moves
nothing here."""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM data sheet, dense: FLOP/s by operand type, HBM bytes/s
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12, "int8": 1979e12}
ITEMSIZE = {"bfloat16": 2, "tf32": 4, "float32": 4}


def attention_bound(b, t, h, d, dtype_name, itemsize):
    """ms: QK^T and PV (4 b h t^2 d operations); q, k, v read and o written once."""
    ops = 4 * b * h * t * t * d
    nbytes = 4 * b * t * h * d * itemsize
    return max(ops / PEAK_OPS_PER_S[dtype_name], nbytes / HBM_BYTES_PER_S) * 1e3


def attention_bwd_bound(b, t, h, d, dtype_name, itemsize):
    """ms: five T x T x D products per (batch, head); q, k, v, dO read once and
    dq, dk, dv written once."""
    ops = 5 * 2 * b * h * t * t * d
    nbytes = 7 * b * t * h * d * itemsize
    return max(ops / PEAK_OPS_PER_S[dtype_name], nbytes / HBM_BYTES_PER_S) * 1e3


def gn_bwd_bound(shape, itemsize, params_bytes=4):
    """ms: x and dy read once and dx written once, with the (B, C) statistics
    and the (C,) scale read and its two gradients written."""
    b, c = shape[:2]
    numel = 1
    for s in shape:
        numel *= s
    nbytes = 3 * numel * itemsize + 2 * b * c * 4 + 3 * c * params_bytes
    return nbytes / HBM_BYTES_PER_S * 1e3


# kernel-name fragments -> class, first match wins
CLASSES = (
    ("repaint_epilogue", "repaint_epilogue (kernel 7)"),
    ("attn_bwd", "packed_attention_bwd (kernel 2)"),
    ("attention_bwd", "packed_attention_bwd (kernel 2)"),
    ("gn_bwd", "gn_bwd (kernel 6)"),
    ("packed_attention", "packed_attention (kernel 1)"),
    ("attention_fwd", "packed_attention (kernel 1)"),
    ("gn_silu_conv_q", "gn_silu_conv_q (kernel 5)"),
    ("gn_silu_amax", "gn_silu_amax (kernel 5's amax pass)"),
    ("gn_silu_conv", "gn_silu_conv (kernel 4)"),
    ("multi_tensor", "optimizer and master copies (foreach kernels)"),
    ("cudnn", "convolution (cuDNN and its transposes)"),
    ("fprop", "convolution (cuDNN and its transposes)"),
    ("dgrad", "convolution (cuDNN and its transposes)"),
    ("wgrad", "convolution (cuDNN and its transposes)"),
    ("conv", "convolution (cuDNN and its transposes)"),
    ("gemm", "matmul (cuBLAS)"),
    ("nvjet", "matmul (cuBLAS)"),
    ("rnn", "GRU (cuDNN)"),
    ("layer_norm", "LayerNorm"),
    ("reduce", "reductions (GroupNorm statistics)"),
    ("memcpy", "memory copies"),
    ("memset", "memory copies"),
    ("copy", "copies and casts"),
    ("cat", "copies and casts"),
    ("elementwise", "other elementwise"),
)
# CUPTI records for the host's launch queue, not device work
NOT_KERNELS = ("Command Buffer Full",)


def classify(name: str) -> str:
    low = name.lower()
    for frag, cls in CLASSES:
        if frag in low:
            return cls
    return "other"


class Trace(NamedTuple):
    """A profiled slice: device operations and host operations as (name,
    start_us, end_us), the slice's wall seconds by the host clock, and how
    many units (evals, steps, passes) it holds."""

    device: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    wall_s: float
    units: int


def trace_of(prof, wall_s: float, units: int) -> Trace:
    """The device and host operations of a ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    device, host = [], []
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            if not e.is_user_annotation and e.name not in NOT_KERNELS and end > start:
                device.append((e.name, start, end))
        elif e.device_type == DeviceType.CPU:
            host.append((e.name, start, end))
    return Trace(device, host, wall_s, units)


def busy_us(ops: Sequence[Tuple[str, float, float]]) -> float:
    """The union of the operations' intervals, in us."""
    total, cur_s, cur_e = 0.0, None, None
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def kernel_us(trace: Trace, fragment: str) -> Tuple[float, int]:
    """Summed device us and launch count of the operations whose names hold
    ``fragment``."""
    hits = [e - s for n, s, e in trace.device if fragment in n]
    return sum(hits), len(hits)


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    """The classes of device operations that took most time, and the idle
    time between device operations summed by the innermost host operation
    running at each gap's midpoint, seconds each."""
    by_class = defaultdict(float)
    for n, s, e in trace.device:
        by_class[classify(n)] += (e - s) / 1e6
    ops = sorted(trace.device, key=lambda o: o[1])
    gaps = []
    end = None
    for _, s, e in ops:
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    host = sorted(trace.host, key=lambda o: o[1])
    starts = [h[1] for h in host]
    by_host = defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) / 2
        i = bisect.bisect_right(starts, mid)
        name, best = "no host operation", None
        for j in range(max(0, i - 2000), i):
            n, s, e = host[j]
            if e >= mid and (best is None or e - s < best):
                name, best = n, e - s
        by_host[name] += (g1 - g0) / 1e6
    return {
        "device_ops": sorted(([k, v] for k, v in by_class.items()), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(([k, v] for k, v in by_host.items()), key=lambda kv: -kv[1])[:top],
    }


def forward_flops(model: nn.Module, *inputs) -> int:
    """FLOPs of one forward of ``model`` (on the meta device) as
    ``torch.utils.flop_counter`` counts them: matrix products, convolutions
    and attention."""
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(*inputs)
    return int(counter.get_total_flops())


class Sites(NamedTuple):
    """Per forward: each self-attention's (B, T, heads, head dim) and each
    GroupNorm's input shape."""

    attention: List[Tuple[int, int, int, int]]
    group_norm: List[Tuple[int, ...]]


def sites(model: nn.Module, *inputs) -> Sites:
    """The self-attentions (a module with ``to_q`` called without a
    condition) and GroupNorms a forward of ``model`` runs, found by hooks."""
    att, gn, hooks = [], [], []
    orig_gn = torch.nn.functional.group_norm

    def gn_spy(x, num_groups, *a, **k):
        gn.append(tuple(x.shape))
        return orig_gn(x, num_groups, *a, **k)

    for m in model.modules():
        if hasattr(m, "to_q"):
            def pre(mod, args, _m=m):
                x = args[0]
                if len(args) < 2 or args[1] is None:
                    att.append((x.shape[0], x.shape[1], mod.n_heads, mod.d_head))
            hooks.append(m.register_forward_pre_hook(pre))
    torch.nn.functional.group_norm = gn_spy
    try:
        with torch.no_grad():
            model(*inputs)
    finally:
        torch.nn.functional.group_norm = orig_gn
        for h in hooks:
            h.remove()
    return Sites(att, gn)
