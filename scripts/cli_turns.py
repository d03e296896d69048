#!/usr/bin/env python3
"""Time the inference CLI of two checkouts in turns on one GPU.

    python3 scripts/cli_turns.py --parent <checkout> [--pairs 8] [--request ddim|ddpm]

From the root of a checkout with one CUDA card. ``<checkout>`` is another
tree of this repository (``git archive <commit> | tar -x -C checkout/parent``;
``checkout/`` is ignored). The script writes synthetic songs and a seeded
random ``chd8bar.pt`` (``chip_smoke.py``'s helpers), trains the full-width
bf16 ``sdf_chd8bar`` preset for 2 steps with this checkout's training CLI,
then runs the request on that run directory in a process of each checkout in
turns (parent, change, then change, parent, ...): each process builds or
loads its checkout's kernels, answers one warm-up request and times 3 more
(host clock around a synchronised CLI call: task build, condition, sampling,
.mid). ``ddim``: DDIM-50, CFG 5, 2 segments; ``ddpm``: ``chip_smoke.py``'s
request A (DDPM-1000 RePaint "below", 2 segments, CFG 5; one timed, no
warm-up). Prints each process's seconds, then the medians per checkout, the
pairs the change wins and the spread (interquartile range) of the parent's
processes, beside the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQUESTS = {
    "ddim": (["--uncond_scale", "5", "--ddim", "--length", "2"], 1, 3),
    "ddpm": (["--uncond_scale", "5", "--inpaint_type", "below", "--length", "2"], 0, 1),
}


def worker(tree: str, work: str, request: str) -> None:
    """In a process of its own: the requests of ``tree``'s CLI; prints one JSON
    line of their seconds."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from polyffusion_tpu_torch.inference import main
    from polyffusion_tpu_torch.ops import _build

    _build.build_all()
    extra, warm, timed = REQUESTS[request]
    args = ["--chkpt_path", os.path.join(work, "run"), "--data_dir", os.path.join(work, "songs"),
            "--song_fn", "song000.npz", "--pretrained_dir", os.path.join(work, "pretrained"),
            "--output_dir", os.path.join(work, "gen"), *extra]
    for _ in range(warm):
        main(args)
    secs = []
    for _ in range(timed):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        main(args)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    print("SECONDS " + json.dumps(secs), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--parent", required=True, help="the other checkout's root")
    p.add_argument("--pairs", type=int, default=8)
    p.add_argument("--request", choices=sorted(REQUESTS), default="ddim")
    p.add_argument("--worker", nargs=2, metavar=("TREE", "WORK"), help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.worker:
        worker(*args.worker, args.request)
        return 0

    import torch

    if not torch.cuda.is_available():
        print("cli_turns: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    from polyffusion_tpu_torch.main import main as train_main

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    with tempfile.TemporaryDirectory() as work:
        pre, data = os.path.join(work, "pretrained"), os.path.join(work, "songs")
        os.makedirs(pre)
        enc = chip_smoke.random_chord_encoder(chip_smoke.full_cfg(bf16=True), seed=5)
        torch.save({"model": {f"chord_enc.{k}": v for k, v in enc.state_dict().items()}},
                   os.path.join(pre, "chd8bar.pt"))
        chip_smoke.write_songs(data, 8, seed=100)
        train_main(["--model", "sdf_chd8bar", "--output_dir", os.path.join(work, "run"),
                    "--data_dir", data, "--pretrained_dir", pre, "--max_steps", "2",
                    "--log_every", "1"])
        trees = {"parent": os.path.abspath(args.parent), "change": ROOT}
        medians = {"parent": [], "change": []}
        for i in range(args.pairs):
            for name in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
                out = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--parent", args.parent,
                     "--request", args.request, "--worker", trees[name], work],
                    capture_output=True, text=True)
                line = [s for s in out.stdout.splitlines() if s.startswith("SECONDS ")]
                if out.returncode or not line:
                    raise RuntimeError(f"{name} failed:\n{out.stderr[-3000:]}")
                secs = json.loads(line[0][len("SECONDS "):])
                medians[name].append(statistics.median(secs))
                print(f"[turns] pair {i} {name}: {[round(s, 3) for s in secs]} s", flush=True)
    par, ch = medians["parent"], medians["change"]
    wins = sum(c < q for q, c in zip(par, ch))
    quart = statistics.quantiles(par, n=4) if len(par) > 1 else [par[0]] * 3
    print(f"[turns] {args.request}: parent median {statistics.median(par):.3f} s, change median "
          f"{statistics.median(ch):.3f} s, change faster in {wins} of {len(par)} pairs, parent "
          f"interquartile range {quart[2] - quart[0]:.3f} s ({smi})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
