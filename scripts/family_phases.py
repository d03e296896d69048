#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s plain DDPM and autoencoder phases alone on one GPU.

    python3 scripts/family_phases.py [--skip-gn]

From the root of a checkout with one CUDA card. The script builds the port's
kernels, holds kernel 6 against its plain version at the fp32 GroupNorm
shapes of the DDPM and autoencoder train steps (``GN_FAMILY_SHAPES``;
``--skip-gn`` leaves this out), writes ``chip_smoke.py``'s synthetic songs,
then runs ``drive_family_paths``: the card-vs-CPU checks with their planted
faults, the training CLI runs, the DDPM CLI requests and the profiled warm
steps, with the same lines and ``[family] summary`` JSON as in the full
script, then the card's name and power limit. It raises where a phase fails.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("family_phases: no CUDA device", file=sys.stderr)
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
    if "--skip-gn" not in sys.argv[1:]:
        # only the family shapes: the sdf step's shapes stay with the full script
        cs.GN_TRAIN_SHAPES, cs.GN_FP32_SHAPES, cs.GROUPNORM_SITES = [], [], 0
        cs.check_gn_bwd()
    counters = {"packed_attention": packed_self_attention,
                "packed_attention_bwd": packed_attention_bwd,
                "head_major_attention": fused_self_attention, "gn_bwd": group_norm_bwd,
                "repaint_epilogue": fused_repaint_epilogue, "gn_silu_conv": gn_silu_conv3x3,
                "gn_silu_conv_q": gn_silu_conv3x3_q, "gn_silu_amax": gn_silu_amax}
    with tempfile.TemporaryDirectory() as work:
        cs.write_songs(os.path.join(work, "songs"), cs.TRAIN_SONGS, seed=100)
        t0 = time.perf_counter()
        launches = cs.drive_family_paths(counters, work)
        cs.log(f"[family] kernel-6 launches by path {launches}; the phases in "
               f"{time.perf_counter() - t0:.3f} s")
    cs.log(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
