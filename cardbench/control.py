"""The readings that the limits of ``limits/<cell>.json`` are set from, on
the card at the cell's own sizes. Not run by the benchmark.

    python3 -m cardbench.control --workload <cell> --seeds 1,2,3 [--as control] [--seconds 3]

For each seed, one run of the cell through the harness's own ``run_cell``
and its own comparison, with a short window, in one process:

- ``--as control`` (the default): the plain reference in the nearest
  precision below the one the configuration states (bf16 -> fp8,
  TF32 -> bf16) in the program's place;
- ``--as program``: the program itself (the lower readings);
- ``--as <fault>``: the program with a fault of ``faults.py`` planted.

One JSON line a seed: every number the driver compares, also those the
cell leaves out, and ``correct`` as the cell's own limits decide it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import sys

from . import faults
from . import spec as specs
from .run import run_cell

LOWER = {"bf16": "fp8", "tf32": "bf16"}
NUMBERS = {"generate": ("sample_gap",),
           "serve": ("sample_gap", "midi_mismatch", "unanswered"),
           "train": ("loss_gap", "grad_gap", "delta_gap", "work_gap", "cond_gap")}


def readings(cell: str, seed: int, what: str = "control", seconds: float = 3.0,
             device="cuda", spec=None, lower: str = None) -> dict:
    """One run of ``cell`` (or of ``spec``) as ``what``: every number the
    driver compares and ``correct`` by the cell's own limits. ``lower``: the
    control's precision, where not the one below the configuration's."""
    s = specs.load(cell, held=True) if spec is None else spec
    own = dict(s.limits)
    s.limits = {k: own.get(k, math.inf) for k in NUMBERS[s.traffic["driver"]]}
    s.control = (lower or LOWER[s.config["precision"]]) if what == "control" else None
    plant = (faults.planted(what, s) if what not in ("control", "program")
             else contextlib.nullcontext())
    try:
        with plant:
            got = run_cell(s, seed, seconds, False, device)["checks"]
    finally:
        s.limits, s.control = own, None
    values = {k: c["value"] for k, c in got.items()}
    correct = all(math.isfinite(values[k]) and values[k] <= lim for k, lim in own.items())
    return {"correct": correct, **values}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--as", dest="what", default="control",
                   choices=("control", "program", *faults.FAULTS))
    p.add_argument("--seconds", type=float, default=3.0, help="each run's window")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        got = readings(args.workload, seed, args.what, args.seconds, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "as": args.what, **got}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
