"""Training steps back to back: the program's step (``train/step.py``) fed
by its ``DeviceFeeder`` from a loader of seeded piano rolls (and chord
progressions where the family is conditioned on them), with timesteps,
noise and a CFG coin drawn from the seed and handed to the step. Set-up
makes ``pool`` batches and their draws, all different, builds the state and
runs the first ``check_steps`` steps, which the reference follows; the same
state then runs the window, cycling through the pool. The rate is the
samples of every step over the window, which ends after a synchronize.

Traffic parameters: ``batch``, ``check_steps``, ``trace_steps``, ``pool``
(at least ``check_steps``), ``reference_block`` (rows per block of the
reference's batch).
"""

from __future__ import annotations

import math
import statistics
import sys
import time
from typing import Dict

import numpy as np
import torch

from .. import inputs
from ..programs import image_shape, train_program
from ..reference import diffusion as ref_diffusion
from ..reference import train as ref_train
from ..reference.precision import strict_fp32
from .common import Outcome, leaf_gap, profiled, release, row_gap, stamp, sync

DRAW_PART = 5
CFG_DROP = 0.2
GRAD_FLOOR = 1e-3  # leaves whose reference gradient is under this share of the median's


def host_batch(cfg, seed: int, i: int, batch: int, fields):
    """Step i's batch as the feeder takes it: (prmat2c, pnotree, chord,
    prmat) host arrays, the fields the task does not read as placeholders."""
    ph = np.zeros((batch, 1), np.float32)
    rolls = inputs.rolls(seed, i, batch, *image_shape(cfg)[1:])
    chord = inputs.chords(seed, i, batch) if "chord" in fields else ph
    return (rolls, ph, chord, ph)


class PooledBatches:
    """An endless loader cycling through ``host_batch`` 0 .. n-1, made once
    in set-up, so that the feeder's thread does the program's work alone."""

    def __init__(self, cfg, seed, batch, fields, n):
        from polyffusion_tpu_torch.data.loader import Batch

        self.pool = [Batch(*host_batch(cfg, seed, i, batch, fields)) for i in range(n)]

    def __iter__(self):
        i = 0
        while True:
            yield self.pool[i % len(self.pool)]
            i += 1


def step_draws(cfg, seed: int, i: int, batch: int, device) -> Dict[str, torch.Tensor]:
    """Step i's per-row timesteps and noise and its CFG coin, on the device."""
    g = inputs.device_generator(device, seed, DRAW_PART, i)
    t = torch.randint(0, int(cfg["n_steps"]), (batch,), generator=g, device=device)
    noise = torch.randn((batch, *image_shape(cfg)), generator=g, device=device)
    drop = torch.rand((), generator=g, device=device) < CFG_DROP
    return {"t": t, "noise": noise, "drop": drop}


def _norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(t.double().norm()) for n, t in tensors.items()}


def _cast_change(after: Dict[str, torch.Tensor], before: Dict[str, torch.Tensor],
                 dtypes: Dict[str, torch.dtype]) -> Dict[str, float]:
    """Per leaf, the norm of the change of its copy in the type it is
    computed in: ||cast(after) - cast(before)||."""
    return {n: float((after[n].detach().to(dtypes[n]).double()
                      - before[n].detach().to(dtypes[n]).double()).norm()) for n in after}


def reference_readings(spec, seed: int, device) -> Dict:
    """The reference's first ``check_steps`` steps from the seed's weights,
    batches and draws, with TF32 off: each step's loss, the norm per leaf of
    the first clipped gradient, of the change of the float32 parameters after
    the last step and of the change of their working copy (the parameters in
    the types the configuration states), and, for a conditioned family, the
    condition of each step."""
    with strict_fp32():
        return _reference_readings(spec, seed, device)


def _reference_readings(spec, seed, device):
    cfg, traffic, fam = spec.config, spec.traffic, spec.family
    batch, n = int(traffic["batch"]), int(traffic["check_steps"])
    models = fam.reference_models(cfg, seed, device)
    model = models[0]
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    batches = []
    for i in range(n):
        rolls, _, chord, _ = host_batch(cfg, seed, i, batch, {"chord"})
        batches.append({"prmat2c": torch.from_numpy(rolls).to(device),
                        "chord": torch.from_numpy(chord).to(device)})
    draws = [step_draws(cfg, seed, i, batch, device) for i in range(n)]
    conds = None
    if hasattr(fam, "reference_condition"):
        conds = [fam.reference_condition(cfg, models, b, d) for b, d in zip(batches, draws)]
    terms = batch * int(np.prod(image_shape(cfg)))
    res = ref_train.train_steps(
        model, fam.reference_step_loss(cfg, models, ref_diffusion.schedule(cfg), batches, draws),
        [(batch, terms)] * n, float(cfg["learning_rate"]), float(cfg["max_grad_norm"]),
        int(traffic["reference_block"]))
    dtypes = ref_train.working_dtypes(model, cfg["precision"])
    return {"loss": res["loss"], "grad": _norms(res["first_grad"]),
            "delta": _norms({k: res["params"][k] - init[k] for k in res["params"]}),
            "work": _cast_change(res["params"], init, dtypes),
            "work_dtype": {n: str(dt) for n, dt in dtypes.items()},
            "cond": conds}


def _whole_gap(got: Dict[str, float], want: Dict[str, float], keep) -> float:
    """|got - want| / want of the norms over all the leaves in ``keep``
    together (per-leaf norms in, the root of their summed squares compared)."""
    g = math.sqrt(sum(got[n] ** 2 for n in keep))
    w = math.sqrt(sum(want[n] ** 2 for n in keep))
    return abs(g - w) / max(w, 1e-30)


def compare(prog: Dict, ref: Dict, limits) -> Dict[str, tuple]:
    """The numbers that decide ``correct``, each with its limit: those of
    ``limits`` among the gaps of the loss, the first gradient and the change
    (by the worst leaf), of the working copy's change (over the leaves
    together: a bf16 copy moves by whole rounding steps, so one small leaf's
    change is a count of a few steps), and of the conditions (a cell leaves
    out a number whose readings separate from no control or fault). A working
    copy in another type than the configuration states, or a condition of
    another shape, reads as infinitely far."""
    loss_gap = max(abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))
    grad_gap, grad_leaf = leaf_gap(prog["grad"], ref["grad"])
    med = statistics.median(ref["grad"].values())
    keep = [k for k, v in ref["grad"].items() if v >= GRAD_FLOOR * med]
    delta_gap, delta_leaf = leaf_gap(prog["delta"], ref["delta"], keep)
    work_gap = _whole_gap(prog["work"], ref["work"], keep)
    off_type = sorted(n for n in ref["work_dtype"] if prog["work_dtype"][n] != ref["work_dtype"][n])
    if off_type:
        print(f"[train] working copy off the configuration's types: {off_type[:5]} "
              f"({len(off_type)} leaves)", file=sys.stderr)
        work_gap = math.inf
    cond_gap = math.nan
    if ref["cond"] is not None and prog["cond"] is not None:
        if len(prog["cond"]) != len(ref["cond"]):
            cond_gap = math.inf
        else:
            cond_gap = max(row_gap(p, r) if p.shape == r.shape else math.inf
                           for p, r in zip(prog["cond"], ref["cond"]))
    print(f"[train] loss gap {loss_gap!r}, gradient gap {grad_gap!r}, change gap "
          f"{delta_gap!r}, working copy gap {work_gap!r}, condition gap {cond_gap!r}; worst "
          f"leaves: gradient {grad_leaf}, change {delta_leaf}; "
          f"{len(ref['grad']) - len(keep)} leaves left out of the changes", file=sys.stderr)
    gaps = {"loss_gap": loss_gap, "grad_gap": grad_gap, "delta_gap": delta_gap,
            "work_gap": work_gap, "cond_gap": cond_gap}
    return {k: (gaps[k], float(limits[k])) for k in gaps if k in limits}


def run(spec, seed: int, seconds: float, trace: bool, device, t0: float) -> Outcome:
    from polyffusion_tpu_torch.data.loader import DeviceFeeder

    cfg, traffic, fam = spec.config, spec.traffic, spec.family
    batch, n_check = int(traffic["batch"]), int(traffic["check_steps"])
    if int(traffic["pool"]) < n_check:
        raise ValueError("the pool must hold a batch for each checked step")
    stamp(t0, "imports")
    prog = train_program(spec, seed, device)
    stamp(t0, "state built")
    names = prog.names
    n_pool = int(traffic["pool"])
    feed = iter(DeviceFeeder(PooledBatches(cfg, seed, batch, prog.fields, n_pool), device,
                             used_fields=prog.fields))
    draws = [prog.noise(step_draws(cfg, seed, i, batch, device)) for i in range(n_pool)]
    count = 0

    def step():
        nonlocal count
        m = prog.step(next(feed), seed, draws[count % n_pool])
        count += 1
        return m

    losses, grad = [], None
    prog.watch_conditions(True)
    for i in range(n_check):
        losses.append(step()["loss"])
        if i == 0:
            grad = {n: (m / (1 - ref_train.B1)).double().norm()
                    for n, m in zip(names, prog.first_moment())}
    conds = prog.conditions
    prog.watch_conditions(False)
    stamp(t0, f"{n_check} steps")
    init = fam.unet_weights(cfg, seed, device)
    working = dict(zip(names, prog.working()))
    readings = {
        "loss": [float(v) for v in losses],
        "grad": {n: float(v) for n, v in grad.items()},
        "delta": _norms({n: m.detach() - init[n] for n, m in zip(names, prog.masters())}),
        "work": _cast_change(working, init, {n: w.dtype for n, w in working.items()}),
        "work_dtype": {n: str(w.dtype) for n, w in working.items()},
        "cond": conds if conds else None,
    }
    del init, working
    sync(device)
    setup_s = time.perf_counter() - t0
    peak = 0
    if torch.device(device).type == "cuda":
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()

    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        step()
    sync(device)
    elapsed = time.perf_counter() - start
    n_window = count - n_check
    e2e = {"train_samples_per_s": batch * n_window / elapsed, "setup_s": setup_s}
    ctx = {"steps": n_window, "units": n_window, "seconds": elapsed, "batch": batch}
    if torch.device(device).type == "cuda":
        ctx["window_peak_bytes"] = torch.cuda.max_memory_allocated()
        peak = max(peak, ctx["window_peak_bytes"])
    slice_ = None
    if trace:
        n_trace = int(traffic["trace_steps"])

        def steps():
            for _ in range(n_trace):
                step()
            return n_trace

        slice_ = profiled(steps, device)
    feed.close()
    del prog, feed
    release(device)

    ref = reference_readings(spec, seed, device)
    print(f"[train] program losses {readings['loss']}, reference {ref['loss']}", file=sys.stderr)
    checks = compare(readings, ref, spec.limits)
    stamp(t0, "reference done")
    return Outcome(e2e, n_window, 0, checks, ctx, peak, slice_)
