"""Where the device time of one train step goes: warm full-width ``sdf_chd8bar``
train steps in bf16 (fp32 masters) at the preset's batch 16, on one GPU.

    python -m polyffusion_tpu_torch.profile_train

Prints the step's time from CUDA events and on the host clock, steps per
second and peak device memory, then a ``torch.profiler`` breakdown of further
steps: device time per kernel class and the top kernels, the share of the
window in which the device was idle, and last one JSON line with the device
kernels launched per step and the GroupNorm backward kernel's (kernel 6) ms
and launches per step. Weights and the batch are random (seeded).
"""

from __future__ import annotations

import json
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from .config import load_params
from .models import ChordEncoder, init_weights_
from .profile_unet import NOT_KERNELS, breakdown
from .tasks import SDFTask
from .train import create_state, make_train_step

STEPS = 10
PROFILED_STEPS = 3


def main() -> None:
    cfg = load_params("sdf_chd8bar")
    enc = ChordEncoder(cfg.chd_input_dim, cfg.chd_hidden_dim, cfg.chd_z_dim)
    init_weights_(enc, torch.Generator().manual_seed(1))
    task = SDFTask(cfg, enc, generator=torch.Generator().manual_seed(0), training=True)
    state = create_state(task.unet, cfg.learning_rate, cfg.max_grad_norm, bf16=cfg.bf16)
    step = make_train_step(task)
    b = cfg.batch_size
    g = torch.Generator(device=task.device).manual_seed(0)
    chord = torch.zeros(b, 32, 36, dtype=torch.uint8, device=task.device)
    rows = torch.arange(32, device=task.device)
    for i in range(b):  # root one-hot | chroma multi-hot | bass one-hot
        chord[i, rows, torch.randint(0, 12, (32,), generator=g, device=task.device)] = 1
        chord[i, :, 12:24] = torch.randint(0, 2, (32, 12), generator=g, device=task.device)
        chord[i, rows, 24 + torch.randint(0, 12, (32,), generator=g, device=task.device)] = 1
    roll = (torch.rand(b, 2, 128, 128, generator=g, device=task.device) > 0.97).to(torch.uint8)
    batch = (roll, None, chord, None)  # as the feeder sends it: uint8, unused fields empty

    def run(n: int) -> None:
        for _ in range(n):
            step(state, batch, seed=0)
        torch.cuda.synchronize()

    run(3)  # warm up: kernel builds, cuDNN's algorithm choice
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    run(STEPS)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / STEPS
    step_ms = start.elapsed_time(end) / STEPS
    print(f"{torch.cuda.get_device_name(0)}: train step at batch {b} bf16: {step_ms:.3f} ms "
          f"(CUDA events, mean of {STEPS}), {wall_ms:.3f} ms on the host clock, "
          f"{1e3 / wall_ms:.3f} steps/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(PROFILED_STEPS)
        prof_wall_ms = (time.perf_counter() - t0) * 1e3
    busy_ms = breakdown(prof, prof_wall_ms, PROFILED_STEPS, "step")
    print(json.dumps(dict(card=torch.cuda.get_device_name(0), step_ms=step_ms, wall_ms=wall_ms,
                          busy_ms_per_step=busy_ms / PROFILED_STEPS,
                          **kernel_launches(prof, PROFILED_STEPS))))


def kernel_launches(prof, steps: int) -> dict:
    """Device kernels launched per step in a profiled window of ``steps``
    steps, and the GroupNorm backward kernel's (``gn_bwd`` in its name) launches
    and device ms per step."""
    launches, gn_launches, gn_us = 0, 0, 0.0
    for evt in prof.key_averages():
        if (evt.device_type != DeviceType.CUDA or evt.is_user_annotation
                or evt.self_device_time_total <= 0 or evt.key in NOT_KERNELS):
            continue
        launches += evt.count
        if "gn_bwd" in evt.key:
            gn_launches += evt.count
            gn_us += evt.self_device_time_total
    return dict(kernels_per_step=launches / steps, gn_bwd_launches_per_step=gn_launches / steps,
                gn_bwd_ms_per_step=gn_us / 1e3 / steps)


if __name__ == "__main__":
    main()
