"""Served generation, open loop: requests arrive on a fixed schedule at
``rate`` requests/s and go to the program's ``RequestQueue.submit`` (in
process, no HTTP), which coalesces them within ``coalesce_ms`` into passes of
the ``GenerationWorker`` padded to ``batch``. Each request asks for 1 or 2
samples (half each), carries no seed and has its own chord progressions.

The schedule is the same for every seed up to its order: the gaps are the
exponential distribution's quantiles at (k + 1/2) / N for N = rate x
seconds, scaled to span the window, and the sizes half 1 and half 2, both
shuffled by the seed. A request's latency runs from its scheduled time to
its reply; a request that fails, or has no reply a minute after the last one
was due, counts as beyond every limit. ``serve_p95_s`` is the 95th
percentile over every request due in the window.

Traffic parameters: ``batch``, ``ddim_steps``, ``cfg_scale``, ``rate``,
``coalesce_ms``, ``check_requests`` (how many answered requests, drawn from
the seed, the reference recomputes), ``trace_seconds`` (the profiled slice's
arrivals).
"""

from __future__ import annotations

import base64
import math
import statistics
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from .. import inputs
from ..programs import serve_reference
from ..reference.midi import midi_bytes
from ..reference.precision import strict_fp32
from .common import Outcome, peak_bytes, profiled, release, row_gap, stamp, sync

GRACE_S = 60.0


def schedule(seed: int, rate: float, seconds: float, part: int = 0):
    """(due offsets in s, sample counts) of the arrivals in [0, seconds)."""
    n = max(1, int(round(rate * seconds)))
    g = inputs.rng(seed, 6, part)
    gaps = -np.log1p(-(np.arange(n) + 0.5) / n) / rate
    gaps = g.permutation(gaps) * (seconds / gaps.sum())
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
    sizes = g.permutation(np.array([1] * (n // 2) + [2] * (n - n // 2)))
    return due.tolist(), sizes.tolist()


class Recorder:
    """The program's passes as the worker ran them: the session generator's
    state just before each pass (its start noise is drawn from it), the
    padded conditions and the output."""

    def __init__(self, session):
        self.passes = []
        self._session, self._predict = session, session.predict
        session.predict = self

    def __call__(self, cond, *args, **kwargs):
        state = self._session.generator.get_state()
        out = self._predict(cond, *args, **kwargs)
        self.passes.append((state, np.asarray(cond), out))
        return out


class PackagingClock:
    """While open, the worker's packaging of each reply (integrity, MIDI) is
    a profiler range of its own and its host seconds are summed: the share of
    the dispatcher's time that goes to packaging, in the traced slice only."""

    def __init__(self):
        from polyffusion_tpu_torch.serve import GenerationWorker

        self.cls, self.seconds, self.replies, self.samples = GenerationWorker, 0.0, 0, 0
        self._orig = GenerationWorker.__dict__["_package"]

    def __enter__(self):
        fn = self._orig.__func__

        def timed(gen, *args, **kwargs):
            t = time.perf_counter()
            with torch.profiler.record_function("serve.GenerationWorker._package"):
                out = fn(gen, *args, **kwargs)
            self.seconds += time.perf_counter() - t
            self.replies += 1
            self.samples += int(gen.shape[0])
            return out

        self.cls._package = staticmethod(timed)
        return self

    def __exit__(self, *exc):
        self.cls._package = self._orig


def onsets_per_sample(passes) -> float:
    """The mean count of rounded onset pixels (the notes the MIDI writer
    makes) of a sample over the passes' outputs, padding rows included."""
    counts = [(np.rint(out[:, 0]) > 0).sum(axis=(1, 2)) for _, _, out in passes]
    return float(np.concatenate(counts).mean()) if counts else math.nan


def _send(rqueue, scale, requests, seed, part, seconds):
    """Send ``requests`` = (due offsets, sizes) open loop; returns records
    (due, latency or None, reply or None, num) once every reply is in or
    the grace after the last due time has passed."""
    due, sizes = requests
    records = [None] * len(due)
    lock = threading.Lock()

    def call(i, t_due):
        chords = inputs.chords(seed, 1000 * part + i, sizes[i])
        try:
            reply = rqueue.submit(sizes[i], scale, None, chords)
            lat = time.perf_counter() - t_due
        except Exception as e:  # a failed request: beyond every limit
            print(f"[serve] request {i} failed: {type(e).__name__}: {e}", file=sys.stderr)
            reply, lat = None, None
        with lock:
            records[i] = (t_due, lat, reply, sizes[i])

    pool = ThreadPoolExecutor(max_workers=256)
    futures = []
    start = time.perf_counter()
    for i, d in enumerate(due):
        t_due = start + d
        pause = t_due - time.perf_counter()
        if pause > 0:
            time.sleep(pause)
        futures.append(pool.submit(call, i, t_due))
    late = max(0.0, time.perf_counter() - start - seconds)
    wait(futures, timeout=GRACE_S)
    pool.shutdown(wait=False, cancel_futures=True)
    with lock:
        out = [r if r is not None else (start + due[i], None, None, sizes[i])
               for i, r in enumerate(records)]
    return out, late, start


def run(spec, seed: int, seconds: float, trace: bool, device, t0: float) -> Outcome:
    from polyffusion_tpu_torch.serve import GenerationWorker, RequestQueue

    cfg, traffic, fam = spec.config, spec.traffic, spec.family
    batch, scale = int(traffic["batch"]), float(traffic["cfg_scale"])
    stamp(t0, "imports")
    prog = fam.GenProgram(cfg, traffic, seed, device)
    stamp(t0, "program built")
    worker = GenerationWorker(prog.session, batch_size=batch)
    worker.warmup(scales=(scale,))
    if spec.control:
        serve_reference(spec, seed, device, worker)
    # a caller waits at most until a grace past the slowest possible reply
    rqueue = RequestQueue(worker, coalesce_ms=float(traffic["coalesce_ms"]),
                          timeout_s=seconds + float(traffic["trace_seconds"]) + 2 * GRACE_S)
    rec = Recorder(prog.session)
    sync(device)
    setup_s = time.perf_counter() - t0

    rate = float(traffic["rate"])
    records, late, start = _send(rqueue, scale, schedule(seed, rate, seconds), seed, 0,
                                 seconds)
    close = start + seconds
    done = [r[0] + r[1] for r in records if r[1] is not None]
    backlog = sum(1 for r in records if r[1] is None or r[0] + r[1] > close)
    lats = [r[1] if r[1] is not None else math.inf for r in records]
    answered = [r for r in records if r[2] is not None]
    n = len(lats)
    p95 = sorted(lats)[min(n - 1, math.ceil(0.95 * n) - 1)]
    e2e = {"serve_p95_s": p95, "setup_s": setup_s}
    replies = [r[2] for r in answered]
    ctx = {
        "latencies": [r[1] for r in answered],
        "pass_ms": [rp["device_ms"] for rp in replies],
        "queue_wait_ms": [1000 * r[1] - r[2]["device_ms"] for r in answered],
        "samples": sum(r[3] for r in answered),
        "passes": sum(1.0 / (rp.get("batched_with", 0) + 1) for rp in replies),
        "late_s": late,
        "units": len(rec.passes),
        "seconds": (max(done) if done else close) - start,
    }
    med = statistics.median
    print(f"[serve] rate {rate}/s: {n} requests, {n - len(answered)} unanswered, pass p50 "
          f"{med(ctx['pass_ms']) if answered else math.inf:.1f} ms, p50 "
          f"{med(ctx['latencies']) if answered else math.inf:.3f} s, p95 {p95:.3f} s, "
          f"{ctx['samples'] / max(ctx['passes'], 1e-9):.2f} samples a pass, generator late "
          f"{late:.3f} s, {backlog} outstanding at the close, last third p50 "
          f"{med(lats[2 * n // 3:]):.3f} s, first third {med(lats[: max(1, n // 3)]):.3f} s, "
          f"{onsets_per_sample(rec.passes):.1f} onsets a sample",
          file=sys.stderr)
    window_passes = len(rec.passes)
    slice_ = None
    if trace:
        clock = PackagingClock()

        def arrivals():
            before = len(rec.passes)
            t_s = float(traffic["trace_seconds"])
            with clock:
                _send(rqueue, scale, schedule(seed, rate, t_s, part=1), seed, 1, t_s)
            return len(rec.passes) - before

        slice_ = profiled(arrivals, device)
        ctx["package_s"], ctx["package_samples"] = clock.seconds, clock.samples
        onsets = onsets_per_sample(rec.passes[window_passes:])
        print(f"[serve] traced slice: {slice_.units} passes in {slice_.wall_s:.3f} s, "
              f"packaging {clock.replies} replies of {clock.samples} samples "
              f"{clock.seconds:.3f} s "
              f"({100 * clock.seconds / slice_.wall_s:.1f} % of the slice), "
              f"{onsets:.1f} onsets a sample", file=sys.stderr)
        stamp(t0, "traced slice read")
    peak = peak_bytes(device)
    rqueue.close()

    # the reference recomputes a sample of the window's answered requests
    g = inputs.rng(seed, 7)
    k = min(int(traffic["check_requests"]), len(answered))
    order = [i for i in g.permutation(len(records)).tolist() if records[i][2] is not None]
    longest = max(order, key=lambda i: records[i][3], default=None)
    picks = ([longest] + [i for i in order if i != longest])[:k] if k else []
    passes = rec.passes[:window_passes]
    del prog, worker, rqueue, rec
    release(device)
    _, enc = fam.reference_models(cfg, seed, device)
    shape = (batch, cfg["img_h"], cfg["img_w"], cfg["out_channels"])
    chords, noise, got, midi_bad = [], [], [], 0
    for i in picks:
        num = records[i][3]
        chords.append(inputs.chords(seed, i, num))
        with torch.no_grad(), strict_fp32():
            want_cond = enc(torch.from_numpy(chords[-1]).to(device)).cpu().numpy()
        p, off = _locate(passes, want_cond)
        state, _, out = passes[p]
        gen = torch.Generator(device=device)
        gen.set_state(state)
        noise.append(torch.randn(shape, generator=gen, device=device)[off:off + num])
        got.append(torch.from_numpy(out[off:off + num]))
        if base64.b64decode(records[i][2]["midi_b64"]) != midi_bytes(out[off:off + num]):
            midi_bad += 1
    del enc
    gap = math.inf
    if picks:
        want = fam.reference_generate(cfg, traffic, seed, np.concatenate(chords),
                                      torch.cat(noise).permute(0, 3, 1, 2), device)
        gap = row_gap(torch.cat(got).to(want.device), want)
    print(f"[serve] requests checked {picks}", file=sys.stderr)
    stamp(t0, "reference done")
    checks = {"sample_gap": (gap, float(spec.limits["sample_gap"])),
              "midi_mismatch": (float(midi_bad), 0.0),
              "unanswered": (float(n - len(answered)), 0.0)}
    return Outcome(e2e, n, n - len(answered), checks, ctx, peak, slice_)


def _locate(passes, cond):
    """(pass, row offset) whose conditions are nearest ``cond`` (num, 1, d)."""
    best = (math.inf, None, None)
    for p, (_, c, _) in enumerate(passes):
        for off in range(0, c.shape[0] - cond.shape[0] + 1):
            d = float(np.abs(c[off:off + cond.shape[0]] - cond).max())
            if d < best[0]:
                best = (d, p, off)
    return best[1], best[2]
