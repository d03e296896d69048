"""Run one cell of the benchmark once and print its result line.

    python3 -m cardbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, on a machine with
the cell's NVIDIA cards. Set-up (kernel loads, weights drawn on the card from
the seed, the cell's warm pass) is ``setup_s``; then the window of
``--seconds``; with ``--trace 1`` a profiled slice after it, from which the
per-layer metrics are read. Once the window has closed the plain reference
recomputes a sample of what the window produced and decides ``correct``.
The last line of standard output is one JSON object; the numbers compared,
each with its limit, are the last lines of standard error too.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from . import spec as specs  # noqa: E402
from .yardstick import breakdown, busy_us  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "polyffusion_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({name for name in sys.modules if name.split(".")[0] in FORBIDDEN})


def run_cell(spec: specs.Spec, seed: int, seconds: float, trace: bool, device="cuda",
             t0: float = None) -> dict:
    """One run of ``spec`` on ``device``: the result object the last line
    prints (``--trace 1``: the per-layer metrics; else the end-to-end ones)."""
    t0 = time.perf_counter() if t0 is None else t0
    out = spec.driver.run(spec, seed, seconds, trace, device, t0)
    metrics = {}
    if trace:
        ctx = {**out.ctx, "spec": spec, "trace": out.trace, "e2e": out.e2e}
        for m in spec.per_layer:
            value = specs.reader(m["name"]).read(ctx)
            if value is None:
                print(f"[run] {m['name']}: nothing to read", file=sys.stderr)
            else:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in spec.end_to_end:
            metrics[m["name"]] = {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "count": int(spec.cell.get("chips", 1)),
        "memory_peak_bytes": int(out.peak_bytes),
    }
    result = {
        "correct": all(math.isfinite(v) and v <= lim for v, lim in out.checks.values()),
        "attempted": int(out.attempted),
        "failed": int(out.failed),
        "metrics": metrics,
        "device": dev,
    }
    if trace and out.trace is not None:
        dev["busy_s"] = busy_us(out.trace.device) / 1e6
        dev["window_s"] = out.trace.wall_s
        result["breakdown"] = breakdown(out.trace)
    result["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = specs.load(args.workload)
    chips = int(spec.cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"[run] needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    print(f"[run] {args.workload} seed {args.seed} on {torch.cuda.get_device_name(0)}; "
          f"TF32 cuDNN {torch.backends.cudnn.allow_tf32}, "
          f"cuBLAS {torch.backends.cuda.matmul.allow_tf32}", file=sys.stderr)
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    found = forbidden_modules()
    if found:
        print(f"[run] JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
