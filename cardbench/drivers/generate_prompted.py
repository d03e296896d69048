"""Offline generation from prompts in a closed loop: ``generate``'s loop with
each request's condition taken from the family's ``request_condition`` (the
text encoders' output, drawn from the seed and the request's number) in
place of chord progressions. One caller sends requests of ``batch`` samples
back to back, each with its own start noise; the window closes when the
request in flight at ``--seconds`` completes, and the rate is every sample
over that whole time. The peak memory is taken from the program's warm
evaluation on, past the drawing of its weights.

``ctx`` also carries ``counters``: the change over the window of each of the
program's counters (``polyffusion_tpu_torch.tracing.counters()``) that is a
number at both ends.

Traffic parameters: ``batch``, ``ddim_steps``, ``cfg_scale``, ``check_rows``
(how many of the window's samples, drawn from the seed, the reference
recomputes).
"""

from __future__ import annotations

import sys
import time

import torch

from .. import inputs
from ..programs import gen_program
from .common import Outcome, peak_bytes, profiled, release, row_gap, stamp, sync
from .generate import request_noise


def _counters() -> dict:
    from polyffusion_tpu_torch import tracing

    return {k: v for k, v in tracing.counters().items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}


def run(spec, seed: int, seconds: float, trace: bool, device, t0: float) -> Outcome:
    cfg, traffic, fam = spec.config, spec.traffic, spec.family
    batch = int(traffic["batch"])

    def condition(r):
        return fam.request_condition(cfg, seed, r, batch, device)

    stamp(t0, "imports")
    prog = gen_program(spec, seed, device)
    stamp(t0, "program built")
    release(device)
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    prog.warm(batch)
    sync(device)
    setup_s = time.perf_counter() - t0

    outputs = []
    before = _counters()
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        r = len(outputs)
        outputs.append(prog.generate(condition(r), request_noise(cfg, seed, r, batch, device)))
    elapsed = time.perf_counter() - start
    after = _counters()
    e2e = {"gen_samples_per_s": batch * len(outputs) / elapsed, "setup_s": setup_s}
    evals = len(outputs) * int(traffic["ddim_steps"])
    ctx = {"evals": evals, "units": evals, "seconds": elapsed, "eval_batch": 2 * batch,
           "counters": {k: after[k] - before[k] for k in after if k in before}}
    slice_ = None
    if trace:
        r = len(outputs)

        def one_request():
            prog.generate(condition(r), request_noise(cfg, seed, r, batch, device))
            return int(traffic["ddim_steps"])

        t_trace = time.perf_counter()
        slice_ = profiled(one_request, device)
        print(f"[generate_prompted] profiled request and its trace read in "
              f"{time.perf_counter() - t_trace:.1f} s", file=sys.stderr)
    peak = peak_bytes(device)
    del prog
    release(device)

    # the reference recomputes a sample of the window's answers
    t_ref = time.perf_counter()
    g = inputs.rng(seed, 4)
    n_rows = min(int(traffic["check_rows"]), batch * len(outputs))
    picks = sorted(g.choice(batch * len(outputs), size=n_rows, replace=False).tolist())
    parts, noise, got = {}, [], []
    for p in picks:
        r, row = divmod(p, batch)
        for k, v in condition(r).items():
            parts.setdefault(k, []).append(v[row])
        noise.append(request_noise(cfg, seed, r, batch, device)[row])
        got.append(torch.from_numpy(outputs[r][row]))
    want = fam.reference_generate(cfg, traffic, seed, {k: torch.stack(v) for k, v in parts.items()},
                                  torch.stack(noise).permute(0, 3, 1, 2), device)
    gap = row_gap(torch.stack(got).to(want.device), want)
    stamp(t0, "reference done")
    print(f"[generate_prompted] {len(outputs)} requests, rows checked {picks}, reference "
          f"{time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    checks = {"sample_gap": (gap, float(spec.limits["sample_gap"]))}
    return Outcome(e2e, len(outputs), 0, checks, ctx, peak, slice_)
