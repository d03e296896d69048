"""The readers of the program's spans (``cardbench/spans.py``): the four
span-only metrics on a tiny served run on the CPU, and on a synthetic slice
the clocks' offset recovered and the card's idle time split by the
dispatcher's state."""

import pytest

from cardbench import spans
from cardbench.run import run_cell
from cardbench.tests.tiny import tiny_spec
from cardbench.yardstick import Trace
from polyffusion_tpu_torch import tracing
from polyffusion_tpu_torch.tracing import Record

SEED = 2 ** 31 + 99
SPAN_ONLY = ("encode_ms_p50.serve", "dispatch_wait_p50_ms.serve", "reply_wait_p50_ms.serve",
             "package_share.serve")
IDLE = ("idle_in_package_pct.serve", "idle_in_pass_pct.serve")


def test_the_span_readers_read_a_tiny_served_run():
    result = run_cell(tiny_spec("chd8bar.serve-ddim50-open"), SEED, 0.5, True, "cpu")
    assert result["correct"]
    for name in SPAN_ONLY:
        assert result["metrics"][name]["value"] > 0, name
    # the CPU's trace holds no device operation to be idle between
    assert not set(IDLE) & set(result["metrics"])


BASE = 1_790_000_000_000_000_000  # the spans' clock, ns
PLANTED = BASE - 12_345_678  # the trace's zero on that clock
DISPATCHER, QUEUE = 1, 7


def _ns(ms):
    return BASE + int(round(ms * 1e6))


def _us(ms):  # the trace's clock
    return (_ns(ms) - PLANTED) / 1e3


def synthetic(passes=3):
    """Three passes of two requests each: encode, queue, coalesce, lock, pass
    (its pull last), two packages, each reply waking its caller, then an idle
    dispatcher; the
    card busy inside each pass but for a 10-ms hole, and a copy call ending
    just before each pull and encoding."""
    recs, device, host = [], [], []
    sid = iter(range(1, 10_000))

    def rec(name, a, b, thread=DISPATCHER, rid=None, parent=None, **attrs):
        recs.append(Record(name, _ns(a), _ns(b), thread, next(sid), parent, rid, attrs or None))

    for i in range(passes):
        s = 100 + 2000 * i
        rids = [2 * i + 1, 2 * i + 2]
        if i == 0:
            rec("serve.idle", s - 400, s - 100)
        for k, rid in enumerate(rids):
            rec("serve.encode", s - 300 + k, s - 290 + k, thread=100 + rid, rid=rid)
            host.append(("cudaMemcpyAsync", _us(s - 295 + k), _us(s - 290.03 + k)))
            device.append(("encoder_kernel", _us(s - 295 + k), _us(s - 294.5 + k)))
            rec("serve.queued", s - 289 + k, s - 75, rid=rid, queue=QUEUE)
        rec("serve.coalesce", s - 100, s - 75, rids=rids, queue=QUEUE)
        rec("serve.lock_wait", s - 75, s)
        rec("serve.pass", s, s + 1000, rids=rids, rows=2, padded=1)
        rec("inference.pull", s + 990, s + 1000, parent=0)
        host.append(("cudaMemcpyAsync", _us(s + 990.5), _us(s + 999.95)))
        host.append(("cudaMemcpyAsync", _us(s + 300), _us(s + 300.01)))  # a decoy
        device += [("unet_kernel", _us(s + 2), _us(s + 500)),
                   ("unet_kernel", _us(s + 510), _us(s + 999.9))]
        t = s + 1000
        for rid in rids:
            rec("serve.package", t, t + 150, rid=rid, samples=1)
            rec("serve.reply", t + 150, t + 151, thread=100 + rid, rid=rid)
            t += 150
        rec("serve.idle", t, s + 1900)
    return recs, Trace(device, host, 6.0, passes)


def test_the_offset_planted_in_a_synthetic_trace_is_recovered():
    recs, trace = synthetic()
    offset, residual, n = spans.align(trace, recs, DISPATCHER)
    assert abs(offset - PLANTED) < 1e6 and residual < 1.0
    assert n == 9  # three pulls and six encodings


def test_the_idle_split_sums_to_the_idle_time():
    recs, trace = synthetic()
    s = spans.served(recs, 6)
    split = spans.idle_split(trace, s.states, spans.align(trace, recs, DISPATCHER)[0])
    idle_s = sum(b - a for a, b in spans._gaps(trace.device)) / 1e6
    assert sum(split.values()) == pytest.approx(idle_s, rel=1e-9)
    shares = {k: 100 * v / idle_s for k, v in split.items()}
    assert sum(shares.values()) == pytest.approx(100.0)
    # two 150-ms packages in each of two gaps between passes; in each pass a
    # 10-ms hole, 2 ms before its first kernel and (but the last) 0.1 ms after
    # its last; the estimate is 0.03 ms off
    assert split["package"] == pytest.approx(2 * 0.3, abs=1e-4)
    assert split["pass"] == pytest.approx(3 * 0.010 + 3 * 0.002 + 2 * 0.0001, abs=1e-4)
    assert shares.get("none", 0.0) < 0.1


def test_the_readers_read_every_metric_of_a_synthetic_slice(monkeypatch):
    recs, trace = synthetic()
    monkeypatch.setattr(spans, "records", lambda: recs)
    ctx = {"latencies": [2.0] * 4, "trace": trace}
    got = spans.read(ctx)
    for name in SPAN_ONLY + IDLE:
        assert got[name.split(".")[0]] is not None, name
    assert got["encode_ms_p50"] == pytest.approx(10.0)
    assert got["dispatch_wait_p50_ms"] == pytest.approx(213.5)
    assert got["reply_wait_p50_ms"] == pytest.approx((151 + 301) / 2)
    assert 0 < got["idle_in_pass_pct"] < got["idle_in_package_pct"] < 100


def test_a_program_without_the_recorder_has_nothing_to_read(monkeypatch):
    monkeypatch.setattr(spans, "records", lambda: None)
    recs, trace = synthetic()
    assert spans.read({"latencies": [1.0], "trace": trace}) == {}
    tracing.clear()
    monkeypatch.setattr(spans, "records", tracing.snapshot)
    assert spans.read({"latencies": [1.0], "trace": trace}) == {}
