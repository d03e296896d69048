#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s ``[s2d]`` phase, or its ``[profile]`` phase at
several depths, alone on one GPU.

    python3 scripts/s2d_phases.py s2d
    python3 scripts/s2d_phases.py profile [--steps 50,20,50,20]

From the root of a checkout with one CUDA card. The script builds the port's
kernels, then ``s2d`` runs ``drive_s2d`` (the space-to-depth level 0's
checks with their planted faults, the bf16 eval folded and unfolded in turns,
a DDIM-50 request) with the same lines and ``[s2d] summary`` JSON as in the
full script; ``profile`` runs the training path (``drive_training_path``,
whose run directory the phase samples from), then ``profile_inpainting``
once for each of ``--steps`` profiled DDPM steps, in that order, and logs
each phase's seconds by the host clock: what the depth of the profiled window
costs the full script. Then the card's name and power limit. It raises where a
phase fails.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("phase", choices=["s2d", "profile"])
    p.add_argument("--steps", default="50,20,50,20",
                   help="profiled DDPM steps of each [profile] run, in order")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("s2d_phases: no CUDA device", file=sys.stderr)
        return 1
    from polyffusion_tpu_torch.device import tf32
    from polyffusion_tpu_torch.ops import _build
    from polyffusion_tpu_torch.ops.fused_attention import (
        fused_self_attention,
        packed_attention_bwd,
        packed_self_attention,
    )
    from polyffusion_tpu_torch.ops.fused_gn_conv import (
        gn_silu_amax,
        gn_silu_conv3x3,
        gn_silu_conv3x3_q,
    )
    from polyffusion_tpu_torch.ops.gn_bwd import group_norm_bwd
    from polyffusion_tpu_torch.ops.repaint_epilogue import fused_repaint_epilogue

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    cs.log(smi)
    tf32(False)
    t0 = time.perf_counter()
    _build.build_all()
    cs.log(f"[build] {len(_build.SOURCES)} source(s) in {time.perf_counter() - t0:.2f} s")
    counters = {"packed_attention": packed_self_attention,
                "packed_attention_bwd": packed_attention_bwd,
                "head_major_attention": fused_self_attention, "gn_bwd": group_norm_bwd,
                "repaint_epilogue": fused_repaint_epilogue, "gn_silu_conv": gn_silu_conv3x3,
                "gn_silu_conv_q": gn_silu_conv3x3_q, "gn_silu_amax": gn_silu_amax}
    if args.phase == "s2d":
        cs.log(f"[s2d] launches by path {cs.drive_s2d(counters, smi)}")
    else:
        with tempfile.TemporaryDirectory() as work:
            cs.drive_training_path(counters, work)
            # request A's mask shape (its values only weight the blend)
            mask = np.zeros((cs.CLI_A_SEGMENTS, 2, 128, 128), np.float32)
            mask[..., 64:] = 1.0
            secs = []
            for steps in (int(n) for n in args.steps.split(",")):
                cs.PROFILE_STEPS = steps
                t0 = time.perf_counter()
                # no request A runs here: its idle share prints as nan
                cs.profile_inpainting(work, mask, request_secs=float("nan"))
                secs.append((steps, time.perf_counter() - t0))
                cs.log(f"[profile] {steps} steps: phase {secs[-1][1]:.3f} s")
            cs.log(f"[profile] phase seconds by depth, in order: {secs}")
    cs.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
