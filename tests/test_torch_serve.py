"""The generation worker (``polyffusion_tpu_torch/serve.py``) on the CPU: its
conditions and replies against the JAX package's worker, the JAX package's
tests/test_serve.py cases in the port's terms, and the CLI's server end to
end. Every thread join, event wait and socket has a timeout."""

import base64
import http.client
import json
import os
import threading
import time
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch
import yaml

from polyffusion_tpu.config import Params as JaxParams
from polyffusion_tpu.models.encoders import ChordEncoder as JaxChordEncoder
from polyffusion_tpu.serve import GenerationWorker as JaxWorker
from polyffusion_tpu.tasks import SDFTask as JaxSDFTask
from polyffusion_tpu_torch import tracing
from polyffusion_tpu_torch.config import Params
from polyffusion_tpu_torch.convert import chord_encoder_state_from_jax, unet_state_from_jax
from polyffusion_tpu_torch.inference import InferenceSession
from polyffusion_tpu_torch.models import ChordEncoder
from polyffusion_tpu_torch.serve import (
    GenerationWorker,
    RequestError,
    RequestQueue,
    make_handler,
    parse_args,
    start,
)
from polyffusion_tpu_torch.tasks import SDFTask

CHD_Z = 16
# the JAX serve tests' config with attention at level 1 (kernel 1's plain
# version runs) and a tiny frozen chord encoder (d_cond = its z)
TINY = dict(
    model_name="sdf_test", batch_size=2, max_epoch=1, learning_rate=1e-4,
    max_grad_norm=10, bf16=False, in_channels=2, out_channels=2, channels=32,
    attention_levels=[1], n_res_blocks=1, channel_multipliers=[1, 2], n_heads=2,
    tf_layers=1, d_cond=CHD_Z, linear_start=0.00085, linear_end=0.012,
    n_steps=8, img_h=32, img_w=32, cond_type="chord", cond_mode="mix",
    use_enc=True, chd_hidden_dim=16, chd_z_dim=CHD_Z,
)
COND_ATOL = 2e-5  # the condition tolerance of the port's encoder tests
JOIN_S = 300  # every join and socket: a fault fails, it never hangs


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """The JAX task and the port's, with the same UNet and chord encoder."""
    enc = JaxChordEncoder(hidden_dim=16, z_dim=CHD_Z)
    enc_params = jax.tree_util.tree_map(
        np.asarray, enc.init(jax.random.PRNGKey(1), np.zeros((1, 32, 36), np.float32))["params"])
    jtask = JaxSDFTask(JaxParams(TINY), chord_enc=enc, chord_enc_params=enc_params)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(jtask.init_params)(jax.random.PRNGKey(0)))
    chd = ChordEncoder(36, 16, CHD_Z)
    chd.load_state_dict(chord_encoder_state_from_jax(enc_params), strict=True)
    task = SDFTask(Params(TINY), chord_enc=chd, device="cpu")
    task.load_unet_state(unet_state_from_jax(params))
    return jtask, params, task


@pytest.fixture(scope="module")
def worker(pair):
    w = GenerationWorker(InferenceSession(pair[2], seed=0, device="cpu"), batch_size=2)
    w.warm = True
    w.warmed_scales = [1.0]
    return w


def _jax_worker(jtask):
    w = JaxWorker.__new__(JaxWorker)
    w.cfg, w.batch, w.task = jtask.cfg, 2, jtask
    return w


def _chords(rng, *shape):
    chords = np.zeros(shape + (36,), np.float32)
    idx = np.indices(shape)
    chords[(*idx, rng.integers(0, 12, shape))] = 1.0
    chords[..., 12:24] = rng.integers(0, 2, shape + (12,))
    chords[(*idx, 24 + rng.integers(0, 12, shape))] = 1.0
    return chords


def _midi(reply):
    return base64.b64decode(reply["midi_b64"])


class _Http:
    """A ThreadingHTTPServer on a free port in a thread, shut down on exit."""

    def __init__(self, worker, rqueue=None):
        self.server = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(worker, rqueue))
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(JOIN_S)

    def call(self, method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=JOIN_S)
        try:
            if body is None:
                conn.request(method, path)
            else:
                conn.request(method, path, body=body if isinstance(body, bytes)
                             else json.dumps(body), headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()


def _in_threads(fns):
    """Run each callable in its own thread; results, or the exceptions raised."""
    out = [None] * len(fns)

    def call(i):
        try:
            out[i] = fns[i]()
        except Exception as e:  # surfaced to the assertions
            out[i] = e

    threads = [threading.Thread(target=call, args=(i,)) for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(JOIN_S)
    assert not any(t.is_alive() for t in threads), "a request thread did not finish"
    return out


@pytest.fixture
def spy(worker):
    """Record each device pass's autoreg flag."""
    calls = []
    real = worker.session.predict

    def predict(*a, **kw):
        calls.append(kw.get("autoreg", False))
        return real(*a, **kw)

    worker.session.predict = predict
    yield calls
    worker.session.predict = real


@pytest.fixture
def rqueue(worker):
    made = []

    def make(coalesce_ms):
        made.append(RequestQueue(worker, coalesce_ms=coalesce_ms, timeout_s=JOIN_S))
        return made[-1]

    yield make
    for q in made:
        q.close(JOIN_S)
        assert not q._thread.is_alive()


# -- against the JAX package's worker ----------------------------------------------------


@pytest.mark.parametrize("with_chord", [True, False])
def test_cond_matches_jax(pair, worker, with_chord):
    chord = _chords(np.random.default_rng(0), 2, 32).tolist() if with_chord else None
    want = np.asarray(_jax_worker(pair[0])._cond(2, chord))
    got = worker._cond(2, chord)
    assert got.shape == want.shape == (2, 1, CHD_Z)
    np.testing.assert_allclose(got, want, atol=COND_ATOL, rtol=0,
                               err_msg=f"conditions beyond atol {COND_ATOL}")


@pytest.mark.parametrize("with_chord", [True, False])
def test_long_conds_match_jax(pair, worker, with_chord):
    chord = _chords(np.random.default_rng(1), 2, 3 * 32).tolist() if with_chord else None
    want = _jax_worker(pair[0])._long_conds(3, 2, chord)
    got = worker._long_conds(3, 2, chord)
    for g, w, shape in zip(got, want, [(2, 3, 1, CHD_Z), (2, 2, 1, CHD_Z)]):
        assert g.shape == np.shape(w) == shape
        np.testing.assert_allclose(g, np.asarray(w), atol=COND_ATOL, rtol=0,
                                   err_msg=f"conditions beyond atol {COND_ATOL}")


def test_package_matches_jax():
    """The same generation gives the same MIDI bytes and integrity score."""
    gen = np.random.default_rng(2).random((3, 2, 128, 128)).astype(np.float32) * 1.1
    for batched_with in (0, 2):
        want = JaxWorker._package(gen, 12.34, batched_with)
        got = GenerationWorker._package(gen, 12.34, batched_with)
        assert _midi(got) == _midi(want) and _midi(got)[:4] == b"MThd"
        assert got == want


def test_package_long_matches_jax(worker, pair):
    gen = np.random.default_rng(3).random((2, 6, 2, 64, 128)).astype(np.float32)
    want = _jax_worker(pair[0])._package_long(gen, 3, 7.5, batched_with=1)
    assert worker._package_long(gen, 3, 7.5, batched_with=1) == want


# -- the worker -------------------------------------------------------------------------------


def test_generate_returns_midi_and_metrics(worker):
    before = worker.samples
    out = worker.generate(num=1, uncond_scale=1.0, seed=7)
    assert _midi(out)[:4] == b"MThd"
    assert 0.0 <= out["integrity_err"] <= 1.0
    assert out["num"] == 1 and out["device_ms"] > 0
    assert worker.samples == before + 1


def test_generate_with_chord_conditioning(worker):
    out = worker.generate(num=2, uncond_scale=5.0, chord=_chords(np.random.default_rng(4), 2, 32))
    assert out["num"] == 2


def test_warmup_registers_scales(worker):
    """Repeat warmups union into warmed_scales; warmup generations stay out
    of the counters."""
    before = (worker.requests, worker.samples)
    worker.warmup([0.0])
    assert worker.warm and {0.0, 1.0} <= set(worker.warmed_scales)
    worker.warmup([0.0, 2.0])
    assert sorted(worker.warmed_scales) == [0.0, 1.0, 2.0]
    assert (worker.requests, worker.samples) == before
    worker.warmed_scales[:] = [1.0]


@pytest.mark.parametrize("bad", [
    dict(num=3), dict(num=0),
    dict(num=1, chord=np.zeros((1, 31, 36)).tolist()),
    dict(num=1, chord=[[["x"] * 36] * 32]),
])
def test_generate_rejects_malformed(worker, bad):
    """RequestError, not an assert (``python -O`` strips those)."""
    with pytest.raises(RequestError):
        worker.generate(uncond_scale=1.0, **bad)


def test_seeded_generation_reproduces(worker):
    a = worker.generate(num=2, uncond_scale=3.0, seed=5)
    worker.generate(num=1, uncond_scale=1.0)  # the generator moves on
    b = worker.generate(num=2, uncond_scale=3.0, seed=5)
    assert a["midi_b64"] == b["midi_b64"]


def test_conditions_are_encoded_in_inference_mode(worker, monkeypatch):
    """Grad mode is per thread: a request thread starts with it on, and the
    encoder must still run without building a graph."""
    seen = []
    real = worker.task.encode_chord

    def encode_chord(chord):
        seen.append((torch.is_grad_enabled(), torch.is_inference_mode_enabled()))
        return real(chord)

    monkeypatch.setattr(worker.task, "encode_chord", encode_chord)
    chord = _chords(np.random.default_rng(5), 1, 32)
    (got,) = _in_threads([lambda: worker._cond(1, chord)])
    assert isinstance(got, np.ndarray), got
    assert seen == [(False, True)]


def test_http_round_trip(worker):
    with _Http(worker) as srv:
        status, health = srv.call("GET", "/healthz")
        assert status == 200 and health["ok"] and health["warm"]
        status, out = srv.call("POST", "/generate", {"num": 1, "uncond_scale": 1.0, "seed": 3})
        assert status == 200 and _midi(out)[:4] == b"MThd"
        # malformed requests -> 400, and the worker stays alive
        for body in ({"num": 99}, {"num": "many"}, {"seed": 1.5}, b"{not json", b"[1, 2]"):
            status, err = srv.call("POST", "/generate", body)
            assert status == 400 and "error" in err, (body, status, err)
        assert srv.call("POST", "/generate", {"num": 1})[0] == 200
        assert srv.call("GET", "/nowhere")[0] == 404
        status, stats = srv.call("GET", "/stats")
        assert status == 200 and stats["requests"] >= 2 and stats["batch_size"] == 2
        assert stats["warmed_scales"] == [1.0] and "coalesced_batches" not in stats


def test_healthz_reports_warmup_failure(worker):
    worker.warm_error = "RuntimeError: boom"
    try:
        with _Http(worker) as srv:
            status, body = srv.call("GET", "/healthz")
        assert status == 500 and body["ok"] is False and "boom" in body["warm_error"]
    finally:
        worker.warm_error = None


# -- the queue -----------------------------------------------------------------------------


def test_queue_coalesces_concurrent_requests(worker, spy, rqueue):
    rq = rqueue(500.0)
    before = (worker.requests, worker.samples)
    out = _in_threads([lambda: rq.submit(num=1, uncond_scale=1.0)] * 2)
    assert len(spy) == 1 and rq.batches == 1, "expected one coalesced device pass"
    for o in out:
        assert isinstance(o, dict), o
        assert _midi(o)[:4] == b"MThd" and o["num"] == 1 and o["batched_with"] == 1
    assert (worker.requests, worker.samples) == (before[0] + 2, before[1] + 2)


def test_queue_seeded_requests_run_solo(worker, rqueue):
    rq = rqueue(200.0)
    out = _in_threads([lambda: rq.submit(num=1, uncond_scale=1.0, seed=3)] * 2)
    assert rq.batches == 0
    for o in out:
        assert isinstance(o, dict) and "batched_with" not in o, o
    assert out[0]["midi_b64"] == out[1]["midi_b64"]


def test_queue_rejects_bad_request_without_poisoning_group(worker, rqueue):
    rq = rqueue(100.0)
    out = _in_threads([lambda: rq.submit(num=99, uncond_scale=1.0),
                       lambda: rq.submit(num=1, uncond_scale=1.0)])
    assert isinstance(out[0], RequestError), out[0]
    assert isinstance(out[1], dict) and _midi(out[1])[:4] == b"MThd"


def test_queue_fails_a_group_on_device_failure_and_keeps_serving(worker, rqueue, monkeypatch):
    rq = rqueue(300.0)
    real = worker.session.predict
    monkeypatch.setattr(worker.session, "predict", lambda *a, **kw: 1 / 0)
    out = _in_threads([lambda: rq.submit(num=1, uncond_scale=1.0)] * 2)
    assert all(isinstance(o, ZeroDivisionError) for o in out), out
    monkeypatch.setattr(worker.session, "predict", real)
    assert rq.submit(num=1, uncond_scale=1.0)["num"] == 1


def test_queue_holds_over_an_incompatible_request(worker, spy, rqueue):
    """A request of another scale leads the next group, not a lost one."""
    rq = rqueue(500.0)
    out = _in_threads([lambda: rq.submit(num=1, uncond_scale=1.0),
                       lambda: (time.sleep(0.05), rq.submit(num=1, uncond_scale=2.0))[1]])
    assert all(isinstance(o, dict) and "batched_with" not in o for o in out), out
    assert len(spy) == 2 and rq.batches == 0


def test_queue_http_concurrent_clients(worker, rqueue):
    rq = rqueue(500.0)
    with _Http(worker, rq) as srv:
        out = _in_threads([lambda: srv.call("POST", "/generate", {"num": 1})] * 2)
        for status, body in out:
            assert status == 200 and body["num"] == 1
        status, stats = srv.call("GET", "/stats")
        assert stats["coalesced_batches"] >= 1


@pytest.mark.parametrize("long_form", [False, True], ids=["generate", "generate_long"])
def test_a_queued_request_leaves_its_spans_in_order_under_one_id(worker, rqueue, long_form):
    """encode, queued, pass, package and reply follow one another under the
    request's id, and with the wait from the pass's end to the reply's end
    (the caller's waking) they sum to the caller's own time in ``submit``
    within 5 ms."""
    rq = rqueue(50.0)
    before = (worker.passes, worker.padded_rows)
    got = {}

    def call():
        got["thread"] = threading.get_ident()
        t0 = time.time_ns()
        if long_form:
            got["reply"] = rq.submit_long(length=2, num=1, uncond_scale=1.0)
        else:
            got["reply"] = rq.submit(num=1, uncond_scale=1.0)
        got["t"] = (t0, time.time_ns())

    _in_threads([call])
    t0, t1 = got["t"]
    recs = [r for r in tracing.snapshot() if r.start_ns >= t0 and r.end_ns <= t1]
    (enc,) = [r for r in recs if r.name == "serve.encode" and r.thread == got["thread"]]
    mine = {r.name: r for r in recs if r.rid == enc.rid}
    (pas,) = [r for r in recs if r.name == "serve.pass" and enc.rid in r.attrs["rids"]]
    queued, package, reply = mine["serve.queued"], mine["serve.package"], mine["serve.reply"]
    assert queued.attrs["queue"] == rq.qid and package.attrs["samples"] == 1
    assert pas.attrs["rows"] == 1 and pas.attrs["padded"] == worker.batch - 1
    stamps = [enc.start_ns, enc.end_ns, queued.start_ns, queued.end_ns, pas.start_ns,
              pas.end_ns, package.start_ns, package.end_ns, reply.start_ns, reply.end_ns]
    assert stamps == sorted(stamps)
    assert queued.thread == pas.thread == package.thread != enc.thread == reply.thread
    # the pass's span holds the host clock that device_ms reads
    assert got["reply"]["device_ms"] <= pas.ms + 0.05
    pieces = enc.ms + queued.ms + pas.ms + (reply.end_ns - pas.end_ns) / 1e6
    assert abs((t1 - t0) / 1e6 - pieces) < 5.0, ((t1 - t0) / 1e6, pieces)
    assert (worker.passes, worker.padded_rows) == (before[0] + 1, before[1] + worker.batch - 1)


@pytest.mark.parametrize("queued", [False, True], ids=["direct", "queued"])
def test_stats_keeps_its_keys_and_adds_the_counters(worker, rqueue, queued):
    rq = rqueue(10.0) if queued else None
    with _Http(worker, rq) as srv:
        assert srv.call("POST", "/generate", {"num": 1})[0] == 200
        status, stats = srv.call("GET", "/stats")
    assert status == 200
    keys = {"requests", "samples", "last_device_ms", "batch_size", "warmed_scales", "counters"}
    assert set(stats) == keys | ({"coalesced_batches"} if queued else set())
    assert stats["requests"] == worker.requests and stats["samples"] == worker.samples
    counters = stats["counters"]
    for name in ("serve.worker.passes", "serve.worker.padded_rows", "serve.worker.requests",
                 "ops.packed_self_attention.launches", "ops.group_norm_bwd.launches"):
        assert isinstance(counters[name], int), name


# -- long form --------------------------------------------------------------------------------


def test_generate_long_uncond(worker):
    out = worker.generate_long(length=3, num=1, uncond_scale=1.0, seed=11)
    assert out["num"] == 1 and out["length"] == 3 and len(out["pieces"]) == 1
    piece = out["pieces"][0]
    assert _midi(piece)[:4] == b"MThd" and 0.0 <= piece["integrity_err"] <= 1.0
    again = worker.generate_long(length=3, num=1, uncond_scale=1.0, seed=11)
    assert again["pieces"][0]["midi_b64"] == piece["midi_b64"]
    two = worker.generate_long(length=3, num=2, uncond_scale=1.0, seed=12)
    assert len(two["pieces"]) == 2
    assert two["pieces"][0]["midi_b64"] != two["pieces"][1]["midi_b64"]


def test_generate_long_with_chord(worker):
    chord = _chords(np.random.default_rng(6), 1, 3 * 32)
    out = worker.generate_long(length=3, num=1, uncond_scale=5.0, chord=chord.tolist(), seed=5)
    assert out["num"] == 1 and len(out["pieces"]) == 1
    with pytest.raises(RequestError):
        worker.generate_long(length=3, num=1, chord=chord[:, :64].tolist())


@pytest.mark.parametrize("length, num", [(1, 1), (3, 3), (3, 0)])
def test_generate_long_validation(worker, length, num):
    with pytest.raises(RequestError):
        worker.generate_long(length=length, num=num)


def test_generate_long_http(worker):
    with _Http(worker) as srv:
        status, out = srv.call("POST", "/generate_long",
                               {"length": 2, "num": 1, "uncond_scale": 1.0, "seed": 4})
        assert status == 200 and len(out["pieces"]) == 1
        assert _midi(out["pieces"][0])[:4] == b"MThd"
        assert srv.call("POST", "/generate_long", {"length": 1})[0] == 400


def test_queue_coalesces_long_requests(worker, spy, rqueue):
    rq = rqueue(500.0)
    before = (worker.requests, worker.samples)
    out = _in_threads([lambda: rq.submit_long(length=3, num=1, uncond_scale=1.0)] * 2)
    assert spy == [True] and rq.batches == 1
    for o in out:
        assert isinstance(o, dict), o
        assert o["length"] == 3 and o["num"] == 1 and o["batched_with"] == 1
        assert len(o["pieces"]) == 1 and _midi(o["pieces"][0])[:4] == b"MThd"
    assert (worker.requests, worker.samples) == (before[0] + 2, before[1] + 2)


def test_queue_does_not_mix_long_lengths_or_kinds(worker, spy, rqueue):
    rq = rqueue(300.0)
    out = _in_threads([lambda: rq.submit_long(length=2, num=1, uncond_scale=1.0),
                       lambda: rq.submit_long(length=3, num=1, uncond_scale=1.0)])
    assert len(spy) == 2 and rq.batches == 0
    assert {o["length"] for o in out} == {2, 3}
    assert all("batched_with" not in o for o in out)
    spy.clear()
    short, long_ = _in_threads([lambda: rq.submit(num=1, uncond_scale=1.0),
                                lambda: rq.submit_long(length=2, num=1, uncond_scale=1.0)])
    assert sorted(spy) == [False, True]
    assert _midi(short)[:4] == b"MThd" and len(long_["pieces"]) == 1


# -- the CLI's server ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def run_files(pair, tmp_path_factory):
    """A tiny preset yaml, a reference-layout UNet .pt and a chd8bar.pt."""
    _, _, task = pair
    root = tmp_path_factory.mktemp("serve_cli")
    with open(root / "tiny.yaml", "w") as f:
        yaml.safe_dump(dict(TINY), f)
    torch.save({"model": {f"eps_model.{k}": v for k, v in task.unet.state_dict().items()}},
               root / "tiny.pt")
    (root / "pre").mkdir()
    torch.save({"model": {f"chord_enc.{k}": v for k, v in task.chord_enc.state_dict().items()}},
               root / "pre" / "chd8bar.pt")
    return root


def _cli_args(root, *extra):
    return parse_args(["--model", str(root / "tiny.yaml"), "--chkpt_path", str(root / "tiny.pt"),
                       "--pretrained_dir", str(root / "pre"), "--port", "0", "--batch_size", "2",
                       *extra])


def test_server_warms_then_serves(run_files):
    srv = start(_cli_args(run_files, "--device", "cpu", "--ddim", "--ddim_steps", "4",
                          "--warmup_scales", "1,3", "--coalesce_ms", "50"))
    thread = threading.Thread(target=srv.httpd.serve_forever, daemon=True)
    thread.start()
    try:
        srv.warmup.join(JOIN_S)
        assert not srv.warmup.is_alive() and srv.worker.warm_error is None
        conn = http.client.HTTPConnection("127.0.0.1", srv.httpd.server_address[1],
                                          timeout=JOIN_S)
        conn.request("GET", "/healthz")
        assert json.loads(conn.getresponse().read())["warm"] is True
        conn.request("POST", "/generate", body=json.dumps({"num": 2, "uncond_scale": 3.0}))
        resp = conn.getresponse()
        assert resp.status == 200 and json.loads(resp.read())["num"] == 2
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        assert stats["warmed_scales"] == [1.0, 3.0] and stats["requests"] == 1
        assert stats["coalesced_batches"] == 0
        conn.close()
        assert srv.worker.session.sampler_kind == "ddim"
    finally:
        srv.httpd.shutdown()
        srv.httpd.server_close()
        srv.queue.close(JOIN_S)
        thread.join(JOIN_S)


def test_server_takes_bf16_params(run_files):
    srv = start(_cli_args(run_files, "--device", "cpu", "--no_warmup", "--coalesce_ms", "0",
                          "--bf16_params"))
    try:
        assert srv.queue is None and srv.warmup is None and srv.worker.warm
        dtypes = {p.dtype for p in srv.worker.task.unet.parameters()}
        assert dtypes == {torch.bfloat16, torch.float32}
        assert srv.worker.generate(num=1, uncond_scale=1.0)["num"] == 1
    finally:
        srv.httpd.server_close()


def test_server_needs_cuda_unless_given_the_cpu(run_files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        start(_cli_args(run_files, "--no_warmup"))


def test_queue_counts_every_request_under_contention(worker, rqueue, monkeypatch):
    """More client threads than cores, a short switch interval: every caller
    gets its own slice and no count is lost."""
    import sys

    n_threads = 3 * (os.cpu_count() or 4)
    monkeypatch.setattr(worker.session, "predict", lambda cond, *a, **kw: np.broadcast_to(
        cond[:, :1, :1, None], (len(cond), 2, 32, 32)).copy())
    monkeypatch.setattr(GenerationWorker, "_package", staticmethod(
        lambda gen, device_ms, batched_with=0: {"mark": gen[:, 0, 0, 0].tolist(),
                                                "batched_with": batched_with}))
    monkeypatch.setattr(worker, "_cond", lambda num, chord: np.full((num, 1, CHD_Z), chord,
                                                                    np.float32))
    rq = rqueue(5.0)
    before = (worker.requests, worker.samples)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        out = _in_threads([lambda i=i: rq.submit(num=1 + i % 2, uncond_scale=1.0, chord=i)
                           for i in range(n_threads)])
    finally:
        sys.setswitchinterval(interval)
    assert [o["mark"] for o in out] == [[float(i)] * (1 + i % 2) for i in range(n_threads)]
    samples = sum(1 + i % 2 for i in range(n_threads))
    assert (worker.requests, worker.samples) == (before[0] + n_threads, before[1] + samples)
