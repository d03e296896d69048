"""Offline generation in a closed loop: one caller sends requests of
``batch`` samples back to back, each with a chord progression a sample and
its own start noise, both drawn from the seed and the request's number. The
window closes when the request in flight at ``--seconds`` completes; the rate
is every sample over that whole time.

Traffic parameters: ``batch``, ``ddim_steps``, ``cfg_scale``, ``check_rows``
(how many of the window's samples, drawn from the seed, the reference
recomputes).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import inputs
from ..programs import gen_program
from .common import Outcome, peak_bytes, profiled, release, row_gap, stamp, sync

NOISE_PART = 3


def request_noise(cfg, seed: int, r: int, batch: int, device) -> torch.Tensor:
    """Request r's start noise, NHWC as the program's ``predict`` takes it."""
    g = inputs.device_generator(device, seed, NOISE_PART, r)
    shape = (batch, cfg.get("img_h", 128), cfg.get("img_w", 128), cfg.get("out_channels", 2))
    return torch.randn(shape, generator=g, device=device)


def run(spec, seed: int, seconds: float, trace: bool, device, t0: float) -> Outcome:
    cfg, traffic, fam = spec.config, spec.traffic, spec.family
    batch = int(traffic["batch"])
    stamp(t0, "imports")
    prog = gen_program(spec, seed, device)
    stamp(t0, "program built")
    prog.warm(batch)
    sync(device)
    setup_s = time.perf_counter() - t0

    outputs = []
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        r = len(outputs)
        outputs.append(prog.generate(inputs.chords(seed, r, batch),
                                     request_noise(cfg, seed, r, batch, device)))
    elapsed = time.perf_counter() - start
    e2e = {"gen_samples_per_s": batch * len(outputs) / elapsed, "setup_s": setup_s}
    evals = len(outputs) * int(traffic["ddim_steps"])
    ctx = {"evals": evals, "units": evals, "seconds": elapsed, "eval_batch": 2 * batch}
    slice_ = None
    if trace:
        r = len(outputs)

        def one_request():
            prog.generate(inputs.chords(seed, r, batch), request_noise(cfg, seed, r, batch, device))
            return int(traffic["ddim_steps"])

        slice_ = profiled(one_request, device)
    peak = peak_bytes(device)
    del prog
    release(device)

    # the reference recomputes a sample of the window's answers
    g = inputs.rng(seed, 4)
    n_rows = min(int(traffic["check_rows"]), batch * len(outputs))
    picks = sorted(g.choice(batch * len(outputs), size=n_rows, replace=False).tolist())
    chords, noise, got = [], [], []
    for p in picks:
        r, row = divmod(p, batch)
        chords.append(inputs.chords(seed, r, batch)[row])
        noise.append(request_noise(cfg, seed, r, batch, device)[row])
        got.append(torch.from_numpy(outputs[r][row]))
    want = fam.reference_generate(cfg, traffic, seed, np.stack(chords),
                                  torch.stack(noise).permute(0, 3, 1, 2), device)
    gap = row_gap(torch.stack(got).to(want.device), want)
    stamp(t0, "reference done")
    print(f"[generate] {len(outputs)} requests, rows checked {picks}", file=sys.stderr)
    checks = {"sample_gap": (gap, float(spec.limits["sample_gap"]))}
    return Outcome(e2e, len(outputs), 0, checks, ctx, peak, slice_)
