"""The program's own spans (``polyffusion_tpu_torch/tracing.py``), read in
the process of a served run once it is over, and laid on the profiled
slice's device timeline.

The window's requests are the first ``len(ctx["latencies"])`` request ids of
the last ``RequestQueue`` the run made: the window's requests are all sent
before the slice's. For each the spans give its encoding (``serve.encode``),
its wait until its group closed (``serve.queued``), its pass (``serve.pass``)
and the wait from the pass's end to the end of its ``serve.reply``, when its
thread wakes with the reply.

``yardstick.Trace`` keeps times relative to a start it does not store, so
the offset between the two clocks is estimated: each ``serve.encode`` and
``inference.pull`` ends just after a device-to-host copy returns, and CUPTI
records that copy's runtime call (``cudaMemcpy*``, ``cudaStreamSynchronize``)
from every thread. Of the offsets that put a pull of the slice on a call's
end, the one that lines up most of these ends with calls (within
``MATCH_MS``) wins; the estimate is the median of their offsets, and the
residual the median distance of each from it. Each idle gap of the card in the slice is then split by the state of
the dispatcher thread over it (by overlap): inside ``serve.package``,
``serve.pass``, ``serve.coalesce``, ``serve.lock_wait``, ``serve.idle`` (no
request waiting), or none of them.

A program without ``tracing.py`` (or that recorded nothing) has nothing to
read: every reader then returns None.
"""

from __future__ import annotations

import bisect
import statistics
import sys
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional

STATES = {"serve.package": "package", "serve.pass": "pass", "serve.coalesce": "coalesce",
          "serve.lock_wait": "lock_wait", "serve.idle": "idle"}
ANCHORS = ("serve.encode", "inference.pull")
COPY_CALLS = ("cudaMemcpy", "cuMemcpy", "cudaStreamSynchronize")
MATCH_MS = 2.0  # an anchor ends at most this long after its copy's call


def records() -> Optional[list]:
    """The program's recorded spans, or None where the program has no recorder."""
    try:
        from polyffusion_tpu_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()


class Request(NamedTuple):
    rid: int
    encode_ms: Optional[float]
    queued_ms: Optional[float]
    pass_ms: Optional[float]
    reply_wait_ms: Optional[float]  # the end of its pass to the end of its reply
    start_ns: Optional[int]  # its enqueue
    end_ns: Optional[int]  # its reply's end


class Served(NamedTuple):
    requests: List[Request]  # the window's, by request id
    dispatcher: int  # the thread of the last queue's dispatcher
    states: List[tuple]  # (start_ns, end_ns, state) of the dispatcher's top-level spans


def served(recs: list, n_window: int) -> Optional[Served]:
    """The window's requests of the last queue in ``recs``."""
    queued = [r for r in recs if r.name == "serve.queued" and r.attrs]
    if not queued or n_window <= 0:
        return None
    qid = max(r.attrs.get("queue", 0) for r in queued)
    queued = {r.rid: r for r in queued if r.attrs.get("queue") == qid}
    coalesce = [r for r in recs if r.name == "serve.coalesce" and r.attrs
                and r.attrs.get("queue") == qid]
    if not coalesce:
        return None
    dispatcher = coalesce[-1].thread
    window = sorted(queued)[:n_window]
    by_name = defaultdict(dict)
    passes = {}
    for r in recs:
        if r.name in ("serve.encode", "serve.reply", "serve.package") and r.rid is not None:
            by_name[r.name][r.rid] = r
        elif r.name == "serve.pass" and r.attrs and r.attrs.get("rids"):
            for rid in r.attrs["rids"]:
                passes[rid] = r
    out = []
    for rid in window:
        enc, q = by_name["serve.encode"].get(rid), queued[rid]
        p, rep = passes.get(rid), by_name["serve.reply"].get(rid)
        out.append(Request(
            rid, enc.ms if enc else None, q.ms, p.ms if p else None,
            (rep.end_ns - p.end_ns) / 1e6 if p and rep else None,
            q.start_ns, rep.end_ns if rep else None))
    states = sorted((r.start_ns, r.end_ns, STATES[r.name]) for r in recs
                    if r.thread == dispatcher and r.parent is None and r.name in STATES)
    return Served(out, dispatcher, states)


def _median(values) -> Optional[float]:
    values = [v for v in values if v is not None]
    return statistics.median(values) if values else None


def package_share(s: Served, recs: list) -> Optional[float]:
    """% of the window's dispatcher time, first enqueue to last reply, inside
    ``serve.package``."""
    starts = [r.start_ns for r in s.requests if r.start_ns is not None]
    ends = [r.end_ns for r in s.requests if r.end_ns is not None]
    if not starts or not ends or max(ends) <= min(starts):
        return None
    t0, t1 = min(starts), max(ends)
    inside = sum(max(0, min(r.end_ns, t1) - max(r.start_ns, t0)) for r in recs
                 if r.name == "serve.package" and r.thread == s.dispatcher)
    return 100.0 * inside / (t1 - t0)


def align(trace, recs: list, dispatcher: int):
    """(offset_ns, residual_ms, anchors lined up): a trace time ``t_us`` is
    ``offset_ns + 1000 t_us`` on the spans' clock; None without copy calls.
    The candidates pair each copy call with the pulls of the slice's passes,
    the dispatcher's last ``trace.units``."""
    calls = sorted(e * 1e3 for n, _, e in trace.host if n.startswith(COPY_CALLS))
    pulls = [r.end_ns for r in recs if r.name == "inference.pull" and r.thread == dispatcher]
    pulls = pulls[-max(1, trace.units):]
    if not calls or not pulls:
        return None
    base = pulls[0]  # ns from here on: small enough for a float's ns
    anchors = sorted(r.end_ns - base for r in recs if r.name in ANCHORS)

    def dists(offset):
        """Each anchor's distance from the nearest copy call, where that is
        at most MATCH_MS."""
        out = []
        for a in anchors:
            i = bisect.bisect_left(calls, a - offset)
            d = min((a - offset - calls[j] for j in (i - 1, i) if 0 <= j < len(calls)), key=abs)
            if abs(d) <= MATCH_MS * 1e6:
                out.append(d)
        return out

    best = None
    for p in pulls:
        for c in calls:
            got = dists(p - base - c)
            key = (len(got), -statistics.median(abs(d) for d in got))
            if best is None or key > best[0]:
                best = (key, p - base - c)
    # recentre on the anchors lined up: each ends a lag after its call
    devs = [best[1] + d for d in dists(best[1])]
    offset = statistics.median(devs)
    residual = statistics.median(abs(d - offset) for d in devs) / 1e6
    return base + int(round(offset)), residual, len(devs)


def _gaps(device) -> List[tuple]:
    """(start_us, end_us) of the card's idle gaps between its operations."""
    gaps, end = [], None
    for _, s, e in sorted(device, key=lambda o: o[1]):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def idle_split(trace, states: List[tuple], offset_ns: int) -> Dict[str, float]:
    """Seconds of the slice's idle gaps by the dispatcher's state, and
    ``"none"`` where it was in none of them."""
    states = [((s - offset_ns) / 1e3, (e - offset_ns) / 1e3, n) for s, e, n in states]
    starts = [s for s, _, _ in states]
    out = defaultdict(float)
    for a, b in _gaps(trace.device):
        covered = 0.0
        i = max(0, bisect.bisect_right(starts, a) - 1)
        while i < len(states) and states[i][0] < b:
            s, e, name = states[i]
            overlap = min(e, b) - max(s, a)
            if overlap > 0:
                out[name] += overlap / 1e6
                covered += overlap
            i += 1
        out["none"] += max(0.0, (b - a) - covered) / 1e6
    return dict(out)


_cache: dict = {}


def read(ctx) -> Dict[str, Optional[float]]:
    """Every span metric of a served run's ``ctx`` (None where nothing is to
    be read), computed once a run."""
    recs = records()
    lats = ctx.get("latencies")
    if not recs or not lats:
        return {}
    key = (id(ctx.get("trace")), len(recs), recs[-1].sid, len(lats))
    if key in _cache:
        return _cache[key]
    out: Dict[str, Optional[float]] = {}
    s = served(recs, len(lats))
    if s is not None:
        req = s.requests
        out["encode_ms_p50"] = _median(r.encode_ms for r in req)
        out["dispatch_wait_p50_ms"] = _median(r.queued_ms for r in req)
        out["reply_wait_p50_ms"] = _median(r.reply_wait_ms for r in req)
        out["package_share"] = package_share(s, recs)
        parts = [(r.encode_ms, r.queued_ms, r.pass_ms, r.reply_wait_ms) for r in req]
        sums = [None if None in p else sum(p) for p in parts]
        # the sender's latencies in send order against the spans' in id order
        late = [1000 * lat - t for lat, t in zip(lats, sums) if t is not None]
        print(f"[spans] {len(req)} window requests: medians encode "
              f"{out['encode_ms_p50']} ms, queued {out['dispatch_wait_p50_ms']} ms, pass "
              f"{_median(r.pass_ms for r in req)} ms, reply wait {out['reply_wait_p50_ms']} ms, "
              f"their sum {_median(sums)} ms; latency less the sum, paired in arrival order: "
              f"median {_median(late)} ms; packaging {out['package_share']} % of the window",
              file=sys.stderr)
        trace = ctx.get("trace")
        if trace is not None and trace.device:
            al = align(trace, recs, s.dispatcher)
            if al is not None:
                offset, residual, n = al
                split = idle_split(trace, s.states, offset)
                total = sum(split.values())
                if total > 0:
                    out["idle_in_package_pct"] = 100.0 * split.get("package", 0.0) / total
                    out["idle_in_pass_pct"] = 100.0 * split.get("pass", 0.0) / total
                named = total - split.get("none", 0.0)
                print(f"[spans] clocks aligned on {n} anchors, offset {offset} ns, residual "
                      f"{residual:.4f} ms; idle {total:.4f} s of the slice by the dispatcher's "
                      f"state: " + ", ".join(f"{k} {v:.4f} s" for k, v in sorted(split.items()))
                      + f"; named {100 * named / max(total, 1e-12):.2f} %", file=sys.stderr)
    _cache.clear()
    _cache[key] = out
    return out


def metric(ctx, name: str) -> Optional[float]:
    """One span metric; a fault in reading it is printed and reads as nothing,
    so that it never ends the run."""
    try:
        return read(ctx).get(name)
    except Exception as e:
        print(f"[spans] {name}: {type(e).__name__}: {e}", file=sys.stderr)
        return None
