"""A resident generation worker: load once, serve many (counterpart of the
JAX package's ``serve.py``).

A stdlib HTTP server keeps the checkpoint, the built kernels and cuDNN's
plans resident on the card. Requests are padded to a fixed batch, so every
request after warmup runs the shapes warmup ran.

    python -m polyffusion_tpu_torch.serve --chkpt_path <run dir> [--port 8763] \\
        [--batch_size 8] [--ddim --ddim_steps 50] [--use_ema] [--bf16_params] \\
        [--warmup_scales 1,5] [--coalesce_ms 25] [--device cpu]

Endpoints (JSON in, JSON out):

    GET  /healthz   -> {"ok": true, "model": ..., "warm": true}
                       (500 with "warm_error" once the warmup has died)
    GET  /stats     -> request and sample counts, the last pass's device_ms,
                       the warmed scales, with a queue coalesced_batches, and
                       under "counters" every counter of ``tracing.py``: the
                       worker's passes and padded rows, the kernels' launches
    POST /generate  -> body {"num": 4, "uncond_scale": 1.0, "seed": 123,
                             "chord": [...one (32, 36) one-hot per sample...]}
                       (all optional); reply {"midi_b64": ..., "integrity_err":
                       0.01, "num": 4, "device_ms": ...}
    POST /generate_long -> body {"length": 4, "num": 2, "uncond_scale": 1.0,
                                 "seed": ..., "chord": [...one (length * 32, 36)
                                 matrix per piece...]}
                       reply {"pieces": [{"midi_b64": ...}, ...], ...}

``device_ms`` (the replies' and ``/stats``' ``last_device_ms``) is the
host's milliseconds of a pass including the pull of its result to the host:
the card's work and whatever the host's launches add to it, not a device
clock. The pass's span is ``serve.pass``; a request's other spans are
``serve.encode``, ``serve.queued``, ``serve.package`` and ``serve.reply``
(``tracing.py``), the last from the dispatcher's hand-over to the caller's
thread waking.

A malformed request gets 400, a failure 500. ``chord`` conditions a chord
model; without it the condition is -1s (unconditional), as the reference's
uncond prompts. ``/generate_long`` is the CLI's ``--autoreg --length`` path
(sliding 8-bar windows with a 4-bar overlap), its pieces batched through the
same windows and padded to ``--batch_size``. Runs on the GPU unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import queue
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import tracing
from .config import load_params
from .inference import (
    InferenceSession,
    build_task_for_inference,
    get_autoreg_data,
    load_unet_params,
)
from .utils.midi_io import prmat2c_to_midi_file
from .utils.reprs import check_prmat2c_integrity


_STOP = object()  # ends the queue's dispatcher


class RequestError(ValueError):
    """A malformed request: the server answers 400."""


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise RequestError(msg)


class GenerationWorker:
    """Owns the session and serialises device passes (one card, one lock)."""

    def __init__(self, session: InferenceSession, batch_size: int = 8):
        self.session = session
        self.task = session.task
        self.cfg = session.cfg
        self.batch = batch_size
        self.requests = 0
        self.samples = 0
        self.passes = 0
        self.padded_rows = 0  # rows of the passes' padded batches that no caller asked for
        self.last_device_ms = None
        self.warm = False
        self.warm_error = None  # set if the warmup thread dies
        self.warmed_scales = []
        # the device lock serialises the warmup thread and the dispatchers; it
        # also guards the session's one generator, which every thread shares.
        # The counters have their own lock, so /stats never waits on a pass.
        self._lock = threading.Lock()
        self._stats_lock = threading.Lock()
        for attr in ("requests", "samples", "passes", "padded_rows", "last_device_ms"):
            tracing.register(f"serve.worker.{attr}", self, attr)

    @classmethod
    def from_args(cls, args) -> "GenerationWorker":
        """The worker the CLI's flags describe: the run directory's (or the
        preset's) config, its UNet weights, its frozen encoders."""
        run_params = os.path.join(args.chkpt_path, "params.yaml")
        if args.model is None and os.path.isdir(args.chkpt_path) and os.path.exists(run_params):
            cfg = load_params(run_params)
        else:
            cfg = load_params(args.model or "sdf_chd8bar")
        task = build_task_for_inference(cfg, args.pretrained_dir, device=args.device,
                                        bf16_params=args.bf16_params)
        task.load_unet_state(load_unet_params(args.chkpt_path, use_ema=args.use_ema))
        session = InferenceSession(
            task,
            use_ddim=args.ddim,
            ddim_steps=args.ddim_steps,
            ddim_eta=args.ddim_eta,
            sampler="dpmpp" if args.dpmpp else None,
            dpm_order=args.dpm_order,
            seed=args.seed,
            device=args.device,
        )
        return cls(session, args.batch_size)

    def warmup(self, scales=(1.0,)):
        """One generation at each CFG scale that will be served. The first
        pass builds the kernels (``ops/_build.py``) and cuDNN's plans for the
        scale's UNet batch (``batch`` at scales 0 and 1, twice that for the
        CFG double batch), so no request pays them. Scales accumulate in
        ``warmed_scales``; warmup generations stay out of the counters.

        JAX's worker also warns when a request comes at a scale it did not
        warm, because there each scale compiles its own executable. The port
        compiles nothing per scale: a new scale costs at most the first use
        of a batch size, so it has no such warning."""
        for s in scales:
            t0 = time.perf_counter()
            self.generate(num=1, uncond_scale=float(s), _warmup=True)
            print(f"[serve] warm scale {s}: first batch {time.perf_counter() - t0:.1f}s")
            if float(s) not in self.warmed_scales:
                self.warmed_scales.append(float(s))
        self.warm = True

    def _check_num(self, num: int) -> None:
        _require(1 <= num <= self.batch, f"num must be in [1, {self.batch}], got {num}")

    def _chords(self, chord, shape) -> torch.Tensor:
        _require(self.task.cond_type == "chord",
                 f"chord conditions a chord model; this one is {self.task.cond_type!r}")
        try:
            chord = np.asarray(chord, np.float32)
        except (TypeError, ValueError) as e:
            raise RequestError(f"chord is not a numeric array: {e}") from None
        _require(chord.shape == shape, f"chord shape {chord.shape} != {shape}")
        return torch.from_numpy(chord)

    def _encode(self, chord: torch.Tensor) -> np.ndarray:
        """(N, 32, 36) one-hots -> (N, 1, d_cond) conditions. Under
        ``inference_mode``: grad mode is per thread, and request threads
        start with it on."""
        with torch.inference_mode():
            cond = self.task.encode_chord(chord).float().cpu().numpy()
        _require(cond.shape[-1] == self.cfg.d_cond,
                 f"cond dim {cond.shape[-1]} != d_cond {self.cfg.d_cond}")
        return cond

    def _cond(self, num: int, chord):
        """Validate a request and encode its (num, 1, d_cond) conditions."""
        self._check_num(num)
        if chord is None:
            return -np.ones((num, 1, self.cfg.d_cond), np.float32)
        return self._encode(self._chords(chord, (num, 32, 36)))

    def _sample(self, cond, uncond_scale: float, seed=None, cond_mid=None,
                autoreg: bool = False, rids=None):
        """One device pass on a leading-axis-padded cond; returns (gen,
        device_ms), the host ms of the pass with its pull to the host. Serves
        the 8-bar path and the long-form one (``cond_mid`` and ``autoreg``:
        the padded axis is then the pieces axis). A seed reseeds the
        session's generator, under the device lock. ``rids``: the request ids
        the pass serves, for its span."""
        num = cond.shape[0]
        if num < self.batch:  # pad to the warmed batch
            def pad(a):
                return np.concatenate([a, np.repeat(a[-1:], self.batch - num, axis=0)], axis=0)

            cond = pad(cond)
            if cond_mid is not None:
                cond_mid = pad(cond_mid)
        with tracing.span("serve.lock_wait"):
            self._lock.acquire()
        try:
            with torch.inference_mode():
                if seed is not None:
                    self.session.generator.manual_seed(int(seed))
                with tracing.span("serve.pass", rows=num, padded=self.batch - num, rids=rids):
                    t0 = time.perf_counter()
                    gen = self.session.predict(cond, cond_mid, uncond_scale=uncond_scale,
                                               autoreg=autoreg)[:num]
                    device_ms = (time.perf_counter() - t0) * 1000.0
        finally:
            self._lock.release()
        with self._stats_lock:
            self.last_device_ms = device_ms
        return gen, device_ms

    def _count(self, n_requests: int, n_samples: int):
        """One pass served ``n_requests`` asking for ``n_samples`` rows (or
        pieces) of its padded batch."""
        with self._stats_lock:
            self.requests += n_requests
            self.samples += n_samples
            self.passes += 1
            self.padded_rows += self.batch - n_samples

    @staticmethod
    def _package(gen, device_ms: float, batched_with: int = 0):
        """One request's slice of a device batch -> its reply."""
        err = check_prmat2c_integrity(gen)
        with tempfile.NamedTemporaryFile(suffix=".mid", delete=False) as f:
            path = f.name
        try:
            prmat2c_to_midi_file(gen, path)
            with open(path, "rb") as f:
                midi = f.read()
        finally:
            os.unlink(path)
        out = {
            "midi_b64": base64.b64encode(midi).decode(),
            "integrity_err": round(float(err), 6),
            "num": int(gen.shape[0]),
            "device_ms": round(device_ms, 1),
        }
        if batched_with:
            out["batched_with"] = int(batched_with)
        return out

    def generate(self, num: int, uncond_scale: float, seed=None, chord=None,
                 _warmup: bool = False):
        """Direct (unqueued) generation: one request, one device pass."""
        cond = self._cond(num, chord)
        gen, device_ms = self._sample(cond, uncond_scale, seed)
        if not _warmup:
            self._count(1, num)
        return self._package(gen, device_ms)

    def generate_long(self, length: int, num: int = 1, uncond_scale: float = 1.0,
                      seed=None, chord=None):
        """Long-form generation over ``length`` 8-bar windows (>= 2): 2 length
        - 1 sequential windows, each forcing its first 4 bars to the previous
        window's last 4 (the CLI's ``--autoreg``), the ``num`` pieces batched
        through them. ``chord``: optional (num, length * 32, 36) one-hots; the
        mid windows' conditions come from the same 4-bar roll the CLI uses
        (``get_autoreg_data``)."""
        cond, cond_mid = self._long_conds(length, num, chord)
        gen, device_ms = self._sample(cond, uncond_scale, seed, cond_mid=cond_mid, autoreg=True)
        self._count(1, int(num))
        return self._package_long(gen, length, device_ms)

    def _long_conds(self, length: int, num: int, chord):
        """Validate and encode a long-form request's window and mid-window
        conditions, (num, length, 1, d) and (num, length - 1, 1, d)."""
        _require(length >= 2, f"length must be >= 2 (one window is /generate), got {length}")
        self._check_num(num)
        d = self.cfg.d_cond
        if chord is None:
            return (-np.ones((num, length, 1, d), np.float32),
                    -np.ones((num, length - 1, 1, d), np.float32))
        wins = self._chords(chord, (num, length * 32, 36)).reshape(num, length, 32, 36)
        mids = get_autoreg_data(wins, axis=2, seg_axis=1)[:, : length - 1]
        cond = self._encode(wins.reshape(-1, 32, 36)).reshape(num, length, 1, -1)
        cond_mid = self._encode(mids.reshape(-1, 32, 36)).reshape(num, length - 1, 1, -1)
        return cond, cond_mid

    def _package_long(self, gen, length: int, device_ms: float, batched_with: int = 0):
        """Per-piece MIDI and integrity of a (num, 2 length, C, 64, W) slice."""
        out = {
            "pieces": [self._package(gen[p], device_ms) for p in range(gen.shape[0])],
            "num": int(gen.shape[0]),
            "length": int(length),
            "device_ms": round(device_ms, 1),
        }
        if batched_with:
            out["batched_with"] = int(batched_with)
        return out


class RequestQueue:
    """Coalesces concurrent ``/generate`` and ``/generate_long`` requests into
    one padded device pass.

    Requests of one kind (8-bar or long-form), one CFG scale and, for the long
    form, one length, that carry no seed, are merged up to the padded batch
    within ``coalesce_ms`` of the first arrival; each caller gets its own
    slice, MIDI and integrity score. The long form merges on the pieces axis.
    A seeded request runs alone, so that a seed always gives the same output.
    A request that does not fit is held over to lead the next group. A failed
    device pass fails every caller of its group, and the queue goes on.

    ``timeout_s``: how long a caller waits for its result before it raises
    ``TimeoutError`` (None: as long as it takes)."""

    def __init__(self, worker: GenerationWorker, coalesce_ms: float = 25.0,
                 timeout_s: Optional[float] = None):
        self.worker = worker
        self.coalesce_s = max(0.0, coalesce_ms) / 1000.0
        self.timeout_s = timeout_s
        self.q = queue.Queue()
        self.batches = 0  # device passes that served more than one request
        self.qid = tracing.new_id()  # tells this queue's spans from another's
        tracing.register("serve.queue.batches", self, "batches")
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def close(self, timeout_s: float = 60.0) -> None:
        """Stop the dispatcher once the requests ahead of this call are served."""
        self.q.put(_STOP)
        self._thread.join(timeout_s)

    def submit(self, num: int, uncond_scale: float, seed=None, chord=None):
        """Validate and encode (here, so a malformed request fails alone),
        enqueue, and wait for the result."""
        rid = tracing.new_id()
        with tracing.span("serve.encode", rid=rid):
            cond = self.worker._cond(num, chord)
        return self._enqueue(num, uncond_scale, seed, cond, rid)

    def submit_long(self, length: int, num: int, uncond_scale: float, seed=None, chord=None):
        """The long-form ``submit``: merges on the pieces axis."""
        rid = tracing.new_id()
        with tracing.span("serve.encode", rid=rid):
            cond, cond_mid = self.worker._long_conds(length, num, chord)
        return self._enqueue(num, uncond_scale, seed, cond, rid, cond_mid=cond_mid,
                             length=int(length))

    def _enqueue(self, num, scale, seed, cond, rid, cond_mid=None, length=None):
        item = {
            "rid": rid,
            "t_enq": time.time_ns(),  # the tracing clock: serve.queued starts here
            "num": int(num),
            "scale": float(scale),
            "seed": seed,
            "cond": cond,
            "cond_mid": cond_mid,
            "length": length,  # None: an 8-bar /generate
            "done": threading.Event(),
            "t_reply": None,  # set with done: serve.reply runs from there to this thread's waking
            "result": None,
            "error": None,
        }
        self.q.put(item)
        if not item["done"].wait(self.timeout_s):
            raise TimeoutError(f"no result within {self.timeout_s} s")
        if item["t_reply"] is not None:
            tracing.record("serve.reply", item["t_reply"], time.time_ns(), rid=rid)
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    @staticmethod
    def _compatible(first, nxt, free: int) -> bool:
        return (
            nxt["seed"] is None
            and first["seed"] is None
            and nxt["scale"] == first["scale"]
            and nxt["length"] == first["length"]  # the same kind and length
            and nxt["num"] <= free
        )

    def _loop(self):
        """Form groups and run them. A request's ``serve.queued`` runs from its
        enqueue to its group's closing; ``serve.idle`` is the wait on an empty
        queue, ``serve.coalesce`` the group's forming from its first request."""
        held = None  # a request that did not fit, to lead the next group
        while True:
            if held is None:
                with tracing.span("serve.idle"):
                    first = self.q.get()
            else:
                first, held = held, None
            if first is _STOP:
                return
            t_first = time.time_ns()
            group = [first]
            if first["seed"] is None:
                deadline = time.monotonic() + self.coalesce_s
                free = self.worker.batch - first["num"]
                while free > 0:
                    wait = deadline - time.monotonic()
                    if wait <= 0:
                        break
                    try:
                        nxt = self.q.get(timeout=wait)
                    except queue.Empty:
                        break
                    if nxt is not _STOP and self._compatible(first, nxt, free):
                        group.append(nxt)
                        free -= nxt["num"]
                    else:
                        held = nxt
                        break
            t_closed = time.time_ns()
            rids = [it["rid"] for it in group]
            tracing.record("serve.coalesce", t_first, t_closed, rids=rids, queue=self.qid)
            for it in group:
                tracing.record("serve.queued", it["t_enq"], t_closed, rid=it["rid"],
                               queue=self.qid)
            self._run(group)

    def _run(self, group):
        w = self.worker
        length = group[0]["length"]
        try:
            cond = np.concatenate([it["cond"] for it in group], axis=0)
            cond_mid = None
            if length is not None:  # long form: merged on the pieces axis
                cond_mid = np.concatenate([it["cond_mid"] for it in group], axis=0)
            gen, device_ms = w._sample(cond, group[0]["scale"], group[0]["seed"],
                                       cond_mid=cond_mid, autoreg=length is not None,
                                       rids=[it["rid"] for it in group])
        except BaseException as e:  # a failed pass: fail every caller, keep serving
            for it in group:
                it["error"] = e if isinstance(e, Exception) else RuntimeError(str(e))
                it["done"].set()
            return
        w._count(len(group), int(sum(it["num"] for it in group)))
        if len(group) > 1:
            self.batches += 1
        off = 0
        for it in group:
            sl = gen[off:off + it["num"]]
            off += it["num"]
            try:
                with tracing.span("serve.package", rid=it["rid"], samples=it["num"]):
                    if length is not None:
                        it["result"] = w._package_long(sl, length, device_ms,
                                                       batched_with=len(group) - 1)
                    else:
                        it["result"] = w._package(sl, device_ms, batched_with=len(group) - 1)
            except Exception as e:  # packaging fails per caller
                it["error"] = e
            it["t_reply"] = time.time_ns()
            it["done"].set()


def _field(req: dict, key: str, kind, default):
    try:
        return kind(req.get(key, default))
    except (TypeError, ValueError):
        raise RequestError(f"{key} must be {kind.__name__}, got {req.get(key)!r}") from None


def make_handler(worker: GenerationWorker, rqueue: Optional[RequestQueue] = None):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                err = worker.warm_error
                self._reply(
                    200 if err is None else 500,
                    {
                        "ok": err is None,
                        "model": worker.cfg.get("model_name", "?"),
                        "warm": worker.warm,
                        **({"warm_error": err} if err else {}),
                    },
                )
            elif self.path == "/stats":
                with worker._stats_lock:
                    stats = {
                        "requests": worker.requests,
                        "samples": worker.samples,
                        "last_device_ms": worker.last_device_ms,
                        "batch_size": worker.batch,
                        "warmed_scales": list(worker.warmed_scales),
                    }
                if rqueue is not None:
                    stats["coalesced_batches"] = rqueue.batches
                stats["counters"] = tracing.counters()
                self._reply(200, stats)
            else:
                self._reply(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path not in ("/generate", "/generate_long"):
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                try:
                    req = json.loads(self.rfile.read(n) or b"{}")
                except ValueError as e:
                    raise RequestError(f"body is not JSON: {e}") from None
                _require(isinstance(req, dict), "body must be a JSON object")
                common = dict(num=_field(req, "num", int, 1),
                              uncond_scale=_field(req, "uncond_scale", float, 1.0),
                              seed=req.get("seed"), chord=req.get("chord"))
                _require(common["seed"] is None or isinstance(common["seed"], int),
                         f"seed must be an integer, got {common['seed']!r}")
                if self.path == "/generate_long":
                    call = rqueue.submit_long if rqueue is not None else worker.generate_long
                    out = call(length=_field(req, "length", int, 2), **common)
                else:
                    call = rqueue.submit if rqueue is not None else worker.generate
                    out = call(**common)
                self._reply(200, out)
            except RequestError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # keep the worker alive on a failure
                self._reply(500, {"error": f"{type(e).__name__}: {e}"})

        def log_message(self, fmt, *a):  # a quiet access log
            print(f"[serve] {self.address_string()} {fmt % a}")

    return Handler


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="polyffusion_tpu_torch generation worker")
    p.add_argument("--chkpt_path", required=True,
                   help="run dir of the port's trainer, or a reference .pt/.ckpt")
    p.add_argument("--model", default=None, help="params preset (default: the run dir's yaml)")
    p.add_argument("--pretrained_dir", default=None)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8763)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--ddim", action="store_true")
    p.add_argument("--ddim_steps", type=int, default=None,
                   help="tau grid size (default: 50, or a distilled checkpoint's own grid)")
    p.add_argument("--ddim_eta", type=float, default=0.0)
    p.add_argument("--dpmpp", action="store_true",
                   help="DPM-Solver++ sampler on the --ddim_steps tau grid")
    p.add_argument("--dpm_order", type=int, default=2, choices=[1, 2])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--use_ema", action="store_true")
    p.add_argument("--bf16_params", action="store_true",
                   help="cast the UNet's weights to bf16 for sampling (norms stay fp32)")
    p.add_argument("--no_warmup", action="store_true")
    p.add_argument("--warmup_scales", default="1.0",
                   help="comma-separated CFG scales to warm (kernel builds, cuDNN plans)")
    p.add_argument("--coalesce_ms", type=float, default=25.0,
                   help="window for merging concurrent same-scale requests into one device "
                   "pass (0 disables the queue)")
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    return p.parse_args(argv)


class Server(NamedTuple):
    httpd: ThreadingHTTPServer
    worker: GenerationWorker
    queue: Optional[RequestQueue]
    warmup: Optional[threading.Thread]


def start(args: argparse.Namespace) -> Server:
    """Build the worker, bind the server, and start the warmup in a thread;
    the caller runs ``httpd.serve_forever()``. The server binds before the
    warmup, so that ``/healthz`` (warm: false) tells a warming worker from a
    dead one, and it is threading, so that a request waiting on the device
    lock never holds up the others."""
    worker = GenerationWorker.from_args(args)
    rqueue = RequestQueue(worker, args.coalesce_ms) if args.coalesce_ms > 0 else None
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(worker, rqueue))
    host, port = httpd.server_address[:2]
    print(f"[serve] listening on http://{host}:{port} (batch {args.batch_size}, "
          f"{worker.session.sampler_kind}, warming)")
    thread = None
    if args.no_warmup:
        worker.warm = True
    else:
        scales = [float(s) for s in args.warmup_scales.split(",")]

        def warmup_guarded():
            # a swallowed failure would leave a worker that is never warm:
            # record it, so that /healthz turns red
            try:
                worker.warmup(scales)
            except BaseException as e:
                worker.warm_error = f"{type(e).__name__}: {e}"
                print(f"[serve] FATAL: warmup failed: {worker.warm_error}")
                raise

        thread = threading.Thread(target=warmup_guarded, daemon=True)
        thread.start()
    return Server(httpd, worker, rqueue, thread)


def main(argv=None):
    start(parse_args(argv)).httpd.serve_forever()


if __name__ == "__main__":
    main()
