"""Where the device time of one sampling step goes: a warm full-width
``sdf_chd8bar`` UNet eval in bf16 at the main path's CFG batch, on one GPU.

    python -m polyffusion_tpu_torch.profile_unet [--gn_conv unfused|fused|int8]

Prints the eval's time from CUDA events, then a ``torch.profiler`` breakdown of
the same evals: device time per kernel class and the top kernels, and the share
of the window in which the device was idle. Weights are random (seeded).
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .config import load_params
from .models import ChordEncoder
from .models.unet import GN_CONV_MODES
from .tasks import SDFTask

# kernel-name fragments -> class, first match wins
CLASSES = (
    ("repaint_epilogue", "repaint_epilogue (this port's kernel)"),
    ("attn_bwd", "packed_attention_bwd (this port's kernel)"),
    ("attention_bwd", "packed_attention_bwd (this port's kernel)"),
    ("gn_bwd", "gn_bwd (this port's kernel)"),
    ("packed_attention", "packed_attention (this port's kernel)"),
    ("attention_fwd", "packed_attention (this port's kernel)"),
    ("gn_silu_conv_q", "gn_silu_conv_q (this port's kernel 5)"),
    ("gn_silu_amax", "gn_silu_amax (kernel 5's amax pass)"),
    ("gn_silu_conv", "gn_silu_conv (this port's kernel 4)"),
    ("multi_tensor", "optimizer and master copies (foreach kernels)"),
    ("cudnn", "convolution (cuDNN, with its NCHW<->NHWC transposes)"),
    ("fprop", "convolution (cuDNN, with its NCHW<->NHWC transposes)"),
    ("dgrad", "convolution (cuDNN, with its NCHW<->NHWC transposes)"),
    ("wgrad", "convolution (cuDNN, with its NCHW<->NHWC transposes)"),
    ("conv", "convolution (cuDNN, with its NCHW<->NHWC transposes)"),
    ("gemm", "matmul (cuBLAS)"),
    ("nvjet", "matmul (cuBLAS)"),
    ("layer_norm", "LayerNorm"),
    ("reduce", "reductions (GroupNorm statistics)"),
    ("copy", "copies and casts"),
    ("cat", "copies and casts"),
    ("elementwise", "other elementwise"),
)
BATCH = 128  # the CFG double batch of a batch-64 request
EVALS = 3
# CUPTI records for the host's launch queue, not kernels
NOT_KERNELS = ("Command Buffer Full",)


def classify(name: str) -> str:
    low = name.lower()
    for frag, cls in CLASSES:
        if frag in low:
            return cls
    return "other"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--gn_conv", default="unfused", choices=list(GN_CONV_MODES))
    args = p.parse_args(argv)
    cfg = load_params("sdf_chd8bar")
    task = SDFTask(cfg, ChordEncoder(36, cfg.chd_hidden_dim, cfg.chd_z_dim),
                   generator=torch.Generator().manual_seed(0), gn_conv=args.gn_conv)
    g = torch.Generator(device=task.device).manual_seed(0)
    x = torch.randn(BATCH, 2, 128, 128, device=task.device, generator=g)
    t = torch.full((BATCH,), 501, dtype=torch.int32, device=task.device)
    cond = torch.randn(BATCH, 1, cfg.d_cond, device=task.device, generator=g)

    def run():
        for _ in range(EVALS):
            task.apply_eps(x, t, cond)
        torch.cuda.synchronize()

    with torch.inference_mode():
        run()  # warm up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        eval_ms = start.elapsed_time(end) / EVALS
        print(f"{torch.cuda.get_device_name(0)}: UNet eval at batch {BATCH} bf16, "
              f"gn_conv {args.gn_conv}: "
              f"{eval_ms:.3f} ms (CUDA events, mean of {EVALS})")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall_ms = (time.perf_counter() - t0) * 1e3

    breakdown(prof, wall_ms, EVALS, "eval")


def breakdown(prof, wall_ms: float, n: int, unit: str) -> float:
    """Prints the device time of a profiled window of ``n`` units (evals,
    steps) by kernel class and the top kernels, and the window's idle share.
    Returns the device's busy ms in the window (0 when none was recorded)."""
    by_class, by_kernel, counts = defaultdict(float), defaultdict(float), defaultdict(int)
    for evt in prof.key_averages():
        # kernels only: operators, autograd nodes and annotated ranges (such as
        # Optimizer.step, also shown on the device's timeline) carry the
        # device time of the kernels they launch
        dev_us = evt.self_device_time_total
        if (evt.device_type != DeviceType.CUDA or evt.is_user_annotation or dev_us <= 0
                or evt.key in NOT_KERNELS):
            continue
        by_class[classify(evt.key)] += dev_us
        by_kernel[evt.key] += dev_us
        counts[evt.key] += evt.count
    busy_ms = sum(by_class.values()) / 1e3
    if busy_ms == 0:
        print("profiler recorded no device time: only the CUDA-event time above holds")
        return 0.0
    print(f"profiled window: {wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}")
    if busy_ms > wall_ms:
        print("warning: device busy exceeds the wall time: some device time is counted twice")
    print(f"device time per {unit} by kernel class:")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3 / n:9.3f} ms  {us / 1e3 / busy_ms:6.1%}  {cls}")
    print(f"top kernels (ms per {unit}, launches per {unit}):")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3 / n:9.3f} ms  {counts[name] // n:4d}  {name[:110]}")
    return busy_ms


if __name__ == "__main__":
    main()
