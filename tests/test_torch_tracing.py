"""The port's recorder (``polyffusion_tpu_torch/tracing.py``) on the CPU:
nesting, request ids across threads, the ring's bound, switching it off, the
counter registry, and its clock against ``torch.profiler``'s."""

import statistics
import threading
import time
import types
from collections import deque

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from polyffusion_tpu_torch import tracing
from polyffusion_tpu_torch.ops import fused_attention, fused_gn_conv, gn_bwd, repaint_epilogue

JOIN_S = 60


@pytest.fixture(autouse=True)
def fresh_ring():
    tracing.clear()
    yield
    tracing.enable(True)
    tracing.clear()


def _in_thread(fn):
    t = threading.Thread(target=fn)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive()


def test_spans_nest_with_parents_per_thread():
    with tracing.span("outer", rows=3) as outer:
        with tracing.span("inner") as inner:
            pass
        tracing.record("by_hand", 1, 2)
    recs = {r.name: r for r in tracing.snapshot()}
    assert [r.name for r in tracing.snapshot()] == ["inner", "by_hand", "outer"]
    assert recs["outer"].parent is None and recs["outer"].attrs == {"rows": 3}
    assert recs["inner"].parent == outer.sid == recs["by_hand"].parent
    assert recs["inner"].sid == inner.sid
    assert recs["outer"].start_ns <= recs["inner"].start_ns <= recs["inner"].end_ns
    assert recs["inner"].end_ns <= recs["outer"].end_ns
    assert len({r.thread for r in recs.values()}) == 1

    def other():
        with tracing.span("elsewhere"):
            pass

    with tracing.span("open"):
        _in_thread(other)
    (elsewhere,) = [r for r in tracing.snapshot() if r.name == "elsewhere"]
    assert elsewhere.parent is None and elsewhere.thread != recs["outer"].thread


def test_one_request_id_across_threads():
    rid = tracing.new_id()
    t_enq, done = {}, threading.Event()

    def request():
        with tracing.span("req.encode", rid=rid):
            with tracing.span("req.child"):  # inherits the id
                pass
        t_enq["t"] = time.time_ns()
        done.wait(JOIN_S)  # alive while the dispatcher works: thread ids are not reused

    def dispatcher():
        while "t" not in t_enq:
            time.sleep(0.001)
        tracing.record("req.queued", t_enq["t"], time.time_ns(), rid=rid)
        with tracing.span("req.reply", rid=rid):
            done.set()

    threads = [threading.Thread(target=request), threading.Thread(target=dispatcher)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads)
    mine = [r for r in tracing.snapshot() if r.rid == rid]
    assert [r.name for r in mine] == ["req.child", "req.encode", "req.queued", "req.reply"]
    assert mine[0].thread == mine[1].thread != mine[2].thread == mine[3].thread
    assert tracing.new_id() > rid


def test_the_ring_is_bounded_and_drops_the_oldest(monkeypatch):
    assert tracing.RING >= 1 << 17 and tracing._ring.maxlen == tracing.RING
    monkeypatch.setattr(tracing, "_ring", deque(maxlen=8))
    for i in range(20):
        with tracing.span(f"s{i}"):
            pass
    assert [r.name for r in tracing.snapshot()] == [f"s{i}" for i in range(12, 20)]


def test_disabled_records_nothing_and_opens_no_range():
    tracing.enable(False)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("off", rid=1):
            torch.ones(4).sum()
        tracing.record("off_by_hand", 0, 1)
    assert tracing.snapshot() == []
    assert "off" not in {e.name for e in prof.events()}
    tracing.enable(True)
    with tracing.span("on"):
        pass
    assert [r.name for r in tracing.snapshot()] == ["on"]


def test_the_registry_lists_kernel_launches_and_serve_counters():
    from polyffusion_tpu_torch.serve import GenerationWorker, RequestQueue

    got = tracing.counters()
    wrappers = [(fused_attention, "packed_self_attention"),
                (fused_attention, "packed_attention_bwd"),
                (fused_attention, "fused_self_attention"),
                (fused_gn_conv, "gn_silu_conv3x3"), (fused_gn_conv, "gn_silu_conv3x3_q"),
                (fused_gn_conv, "gn_silu_amax"), (gn_bwd, "group_norm_bwd"),
                (repaint_epilogue, "fused_repaint_epilogue")]
    for module, name in wrappers:
        fn = getattr(module, name)
        assert got[f"ops.{name}.launches"] == fn.launches
        before = fn.launches
        fn.launches += 2
        try:
            assert tracing.counters()[f"ops.{name}.launches"] == before + 2
        finally:
            fn.launches = before

    session = types.SimpleNamespace(task=None, cfg={})
    worker = GenerationWorker(session, batch_size=4)
    rq = RequestQueue(worker, coalesce_ms=1.0, timeout_s=JOIN_S)
    try:
        worker._count(2, 3)
        rq.batches += 1
        serve = {k: v for k, v in tracing.counters().items() if k.startswith("serve.")}
        assert serve == {"serve.queue.batches": 1, "serve.worker.last_device_ms": None,
                         "serve.worker.padded_rows": 1, "serve.worker.passes": 1,
                         "serve.worker.requests": 2, "serve.worker.samples": 3}
    finally:
        rq.close(JOIN_S)


def test_a_span_and_the_profilers_stamp_of_it_agree():
    """The span's clock is the profiler's: its start and the profiler's
    stamp of the range it opens differ by well under 2 ms (the median of
    five, as a thread may lose its core between the two readings)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(5):
            with tracing.span(f"anchor{i}"):
                torch.ones(8).sum()
    recs = {r.name: r for r in tracing.snapshot()}
    starts, lengths = [], []
    for ev in prof.events():
        if ev.name in recs:
            rec = recs[ev.name]
            starts.append(tracing.origin_ns(prof) + ev.time_range.start * 1e3 - rec.start_ns)
            lengths.append((ev.time_range.end - ev.time_range.start) * 1e3 - rec.ms * 1e6)
    assert len(starts) == 5
    assert abs(statistics.median(starts)) < 2e6, [d / 1e6 for d in starts]
    assert abs(statistics.median(lengths)) < 2e6, [d / 1e6 for d in lengths]


def test_a_range_appears_only_where_the_spans_own_thread_is_profiled():
    def other():
        with tracing.span("on_other_thread"):
            torch.ones(8).sum()

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("on_profiled_thread"):
            torch.ones(8).sum()
        _in_thread(other)
    names = {e.name for e in prof.events()}
    assert "on_profiled_thread" in names and "on_other_thread" not in names
    # both are recorded all the same
    assert {r.name for r in tracing.snapshot()} >= {"on_profiled_thread", "on_other_thread"}
