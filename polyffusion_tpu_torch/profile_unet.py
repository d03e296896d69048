"""Where the device time of one sampling step goes: a warm full-width
``sdf_chd8bar`` UNet eval in bf16 at the main path's CFG batch, on one GPU.

    python -m polyffusion_tpu_torch.profile_unet

Prints the eval's time from CUDA events, then a ``torch.profiler`` breakdown of
the same evals: device time per kernel class and the top kernels, and the share
of the window in which the device was idle. Weights are random (seeded).
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from .config import load_params
from .models import ChordEncoder
from .tasks import SDFTask

# kernel-name fragments -> class, first match wins
CLASSES = (
    ("packed_attention", "packed_attention (this port's kernel)"),
    ("cudnn", "convolution (cuDNN, with its NCHW<->NHWC transposes)"),
    ("fprop", "convolution (cuDNN, with its NCHW<->NHWC transposes)"),
    ("conv", "convolution (cuDNN, with its NCHW<->NHWC transposes)"),
    ("gemm", "matmul (cuBLAS)"),
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


def main() -> None:
    cfg = load_params("sdf_chd8bar")
    task = SDFTask(cfg, ChordEncoder(36, cfg.chd_hidden_dim, cfg.chd_z_dim),
                   generator=torch.Generator().manual_seed(0))
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
        print(f"{torch.cuda.get_device_name(0)}: UNet eval at batch {BATCH} bf16: "
              f"{eval_ms:.3f} ms (CUDA events, mean of {EVALS})")

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            wall_ms = (time.perf_counter() - t0) * 1e3

    by_class, by_kernel, counts = defaultdict(float), defaultdict(float), defaultdict(int)
    for evt in prof.key_averages():
        dev_us = evt.self_device_time_total
        if dev_us <= 0 or evt.key.startswith("aten::") or evt.key in NOT_KERNELS:
            continue
        by_class[classify(evt.key)] += dev_us
        by_kernel[evt.key] += dev_us
        counts[evt.key] += evt.count
    busy_ms = sum(by_class.values()) / 1e3
    if busy_ms == 0:
        print("profiler recorded no device time: only the CUDA-event time above holds")
        return
    print(f"profiled window: {wall_ms:.3f} ms wall, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.3f}")
    if busy_ms > wall_ms:
        print("warning: device busy exceeds the wall time: some device time is counted twice")
    print("device time per eval by kernel class:")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3 / EVALS:9.3f} ms  {us / 1e3 / busy_ms:6.1%}  {cls}")
    print("top kernels (ms per eval, launches per eval):")
    for name, us in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {us / 1e3 / EVALS:9.3f} ms  {counts[name] // EVALS:4d}  {name[:110]}")


if __name__ == "__main__":
    main()
