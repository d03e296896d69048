"""The training loop: run-directory lifecycle, epochs, validation, checkpoints
(counterpart of ``polyffusion_tpu/train/loop.py``).

- run dir with ``params.yaml`` and a drift warning on resume;
- ``torch.save`` checkpoints under ``chkpts/``: the best ``keep_checkpoints`` by
  val loss (``step_<n>.pt``, listed in ``best.json``) and a rolling ``last.pt``,
  written at every save, for resume (the reference's save_last=True);
- a NaN-loss check (raises, like ``lightning_learner.py:29-33``) at logging
  boundaries only, so that no step waits for the card;
- metrics to stdout and ``metrics.jsonl``, with ``steps_per_sec``;
- an optional ``ParameterScheduler`` (teacher forcing) whose values for the
  current step reach the task's ``draw_noise``; validation runs it in eval
  mode, which pins teacher forcing to its floor;
- ``legacy_checkpoints: true`` (an sdf task): every save also writes the
  reference learner's ``chkpts/weights.pt``, and on a new best val loss
  ``weights_best.pt`` and ``info.txt`` (reference ``learner.py:104-124``);
- ``profile_steps`` (START, STOP): a ``torch.profiler`` window over those
  steps, written as a Chrome trace under ``<output_dir>/profile/`` once it
  closes; each step in it is a ``train_step <n>`` span (``tracing.py``), a
  range of the trace;
- on a mesh (``parallel/``): the state placed by the policy (replicated over
  dp, or ZeRO-3 sharded with the ``fsdp`` config key, or the tp layout on a
  tp mesh). Every rank computes; only rank 0 writes the metrics log,
  ``params.yaml``, the checkpoints and the legacy mirror, the others wait at
  a barrier after each save. A checkpoint holds every tensor whole, so a
  run directory of any placement is a one-process one; ``--resume`` loads it
  into the placed state.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
import yaml

from .. import tracing
from ..config import Params, params_differ, save_params
from ..models.unet import UNetModel
from ..parallel.mesh import barrier, rank
from .state import TrainState, create_state, param_count
from .step import make_eval_step, make_train_step


class MetricsLogger:
    def __init__(self, out_dir: str):
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, record: Dict) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


class Trainer:
    def __init__(
        self,
        task,
        cfg: Params,
        output_dir: str,
        max_steps: Optional[int] = None,
        log_every: int = 100,
        keep_checkpoints: int = 3,
        save_every: int = 1,
        param_scheduler=None,
        profile_steps: Optional[Tuple[int, int]] = None,
        mesh=None,
    ):
        """``task`` must hold fp32 weights (built with ``training=True``); the
        trainer trains ``task.model``, in bf16 over fp32 masters where
        ``task.bf16``. ``save_every``: validate and checkpoint every N epochs
        (default 1, the reference's per-epoch cadence; the final epoch always
        saves). ``param_scheduler``: a ``train.schedulers.ParameterScheduler``
        or None. ``profile_steps``: (START, STOP), the steps traced with
        ``torch.profiler`` (steps START to STOP - 1, counted from 0 as the
        checkpoints count them; traced on rank 0). ``mesh``: the dp (or dp x
        tp) mesh the state is placed on; the config key ``fsdp: true`` shards
        it ZeRO-3 style over dp, and needs a mesh (a one-rank one will do)."""
        self.task = task
        self.cfg = cfg
        self.param_scheduler = param_scheduler
        self.max_steps = max_steps
        self.log_every = log_every
        self.keep_checkpoints = keep_checkpoints
        self.save_every = max(1, int(save_every))
        if profile_steps is not None and not 0 <= profile_steps[0] < profile_steps[1]:
            raise ValueError(f"profile_steps {profile_steps}: need 0 <= START < STOP")
        self.mesh = mesh
        self.rank0 = rank() == 0
        self.profile_steps = profile_steps if self.rank0 else None
        self._profiler = None
        # ZeRO-3 state sharding over dp (parallel/fsdp.py); config: fsdp: true
        self.fsdp = bool(cfg.get("fsdp", False))
        if self.fsdp and mesh is None:
            raise ValueError("fsdp: true needs a dp mesh (parallel.make_mesh; the training "
                             "CLI makes one): it is never ignored")

        self.output_dir = output_dir
        self.ckpt_dir = os.path.join(output_dir, "chkpts")
        if self.rank0:
            os.makedirs(self.ckpt_dir, exist_ok=True)
            params_path = os.path.join(output_dir, "params.yaml")
            if os.path.exists(params_path):
                with open(params_path) as f:
                    old = yaml.safe_load(f)
                for key, old_v, new_v in params_differ(old, cfg):
                    print(f"[params drift] {key}: saved={old_v!r} current={new_v!r}")
            save_params(cfg, params_path)

        # optional parameter EMA (config: ema_decay, e.g. 0.9999)
        self.ema_decay = cfg.get("ema_decay", None)
        self.train_step = make_train_step(task, ema_decay=self.ema_decay, mesh=mesh,
                                          fsdp=self.fsdp)
        self.eval_step = make_eval_step(task, mesh=mesh, fsdp=self.fsdp)
        # the reference learner's checkpoints beside the port's (JAX
        # train/loop.py:128-180); the best val loss of this process decides
        # weights_best.pt, as in JAX
        self.legacy_ckpt = bool(cfg.get("legacy_checkpoints", False))
        self._best_val = float("inf")

    # -- checkpointing ---------------------------------------------------------

    def _best_index(self) -> List[Dict]:
        path = os.path.join(self.ckpt_dir, "best.json")
        if not os.path.exists(path):
            return []
        with open(path) as f:
            return json.load(f)

    def _write(self, obj, name: str) -> None:
        path = os.path.join(self.ckpt_dir, name)
        torch.save(obj, path + ".tmp")
        os.replace(path + ".tmp", path)

    def save(self, state: TrainState, val_loss: float, epoch: int = 0) -> None:
        """Rolling ``last.pt``, and ``step_<n>.pt`` if it is among the best
        ``keep_checkpoints`` val losses (a worse one is not kept); with
        ``legacy_checkpoints``, the reference learner's files too. Every rank
        gathers the state; rank 0 writes, the others wait."""
        ckpt = {**state.state_dict(), "val_loss": float(val_loss)}
        if self.rank0:
            self._save(ckpt, epoch)
        barrier()

    def _save(self, ckpt: Dict, epoch: int) -> None:
        step, val_loss = ckpt["step"], ckpt["val_loss"]
        self._write(ckpt, "last.pt")
        best = [e for e in self._best_index() if e["step"] != step]
        best.append({"step": step, "val_loss": val_loss})
        best.sort(key=lambda e: (e["val_loss"], -e["step"]))
        keep, drop = best[: self.keep_checkpoints], best[self.keep_checkpoints:]
        if any(e["step"] == step for e in keep):
            self._write(ckpt, f"step_{step}.pt")
        for e in drop:
            path = os.path.join(self.ckpt_dir, f"step_{e['step']}.pt")
            if os.path.exists(path):
                os.remove(path)
        with open(os.path.join(self.ckpt_dir, "best.json.tmp"), "w") as f:
            json.dump(keep, f)
        os.replace(os.path.join(self.ckpt_dir, "best.json.tmp"),
                   os.path.join(self.ckpt_dir, "best.json"))
        if self.legacy_ckpt:
            self._save_legacy(ckpt, val_loss, epoch)

    def _save_legacy(self, ckpt: Dict, val_loss: float, epoch: int) -> None:
        """From the gathered checkpoint ``ckpt``: ``weights.pt`` = the
        reference learner's checkpoint of the fp32 masters and Adam state (``convert.torch_export.export_learner_checkpoint``);
        on a new best val loss also ``weights_best.pt`` and ``info.txt``
        (reference ``learner.write_epoch_info``, learner.py:108-111). The
        layout holds the sdf UNet only: another task prints that it skipped."""
        from ..convert.torch_export import export_learner_checkpoint

        if not hasattr(self.task, "schedule"):
            print("[legacy ckpt] skipped: task has no diffusion schedule (SDF only)")
            return
        if not isinstance(self.task.model, UNetModel):
            # the plain DDPM family has a schedule but not the sdf UNet
            print("[legacy ckpt] skipped: the learner layout holds the sdf UNet only (SDF only)")
            return
        is_best = val_loss < self._best_val
        kwargs = dict(
            schedule=self.task.schedule,
            opt_state=ckpt["opt_state"],
            step=ckpt["step"],
            epoch=epoch,
            learning_rate=float(self.cfg.learning_rate),
            fp16=False,
        )
        params = ckpt["params"]
        export_learner_checkpoint(params, os.path.join(self.ckpt_dir, "weights.pt"), **kwargs)
        if is_best:
            self._best_val = val_loss
            export_learner_checkpoint(params, os.path.join(self.ckpt_dir, "weights_best.pt"),
                                      **kwargs)
            with open(os.path.join(self.ckpt_dir, "info.txt"), "w") as f:
                f.write(str(epoch))
                f.write(str(val_loss))

    def try_restore(self, state: TrainState) -> TrainState:
        """Load ``last.pt``, which every save writes. It is read to the CPU: the
        optimizer moves its moments to the masters' device itself and keeps its
        step counts on the host, so that no update waits for the card."""
        path = os.path.join(self.ckpt_dir, "last.pt")
        if not os.path.exists(path):
            return state
        state.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
        self._print(f"[resume] restored checkpoint at step {state.step}")
        return state

    # -- the loop ---------------------------------------------------------------

    def fit(self, train_dl, val_dl, seed: int = 0, resume: bool = True,
            init_params: Optional[Dict[str, torch.Tensor]] = None) -> TrainState:
        """``init_params``: fp32 weights by parameter name, loaded strictly into
        ``task.model`` before the state is made (a distillation student starts
        from its teacher); a restored checkpoint still wins."""
        cfg = self.cfg
        if init_params is not None:
            with torch.no_grad():
                self.task.model.float().load_state_dict(init_params, strict=True)
        state = create_state(
            self.task.model,
            cfg.learning_rate,
            cfg.get("max_grad_norm", 10.0),
            bf16=self.task.bf16,
            ema_decay=self.ema_decay,
            mesh=self.mesh,
            fsdp=self.fsdp,
        )
        self._print(f"[model] {param_count(self.task.model) / 1e6:.2f}M trainable params")
        if resume:
            state = self.try_restore(state)
        logger = MetricsLogger(self.output_dir) if self.rank0 else None
        try:
            self._fit(state, train_dl, val_dl, seed, logger)
        finally:
            if logger is not None:
                logger.close()
        return state

    def _print(self, line: str) -> None:
        if self.rank0:
            print(line)

    def _log(self, logger: Optional[MetricsLogger], record: Dict) -> None:
        if logger is not None:
            logger.log(record)

    def _fit(self, state: TrainState, train_dl, val_dl, seed: int,
             logger: Optional[MetricsLogger]) -> None:
        max_epoch = int(self.cfg.get("max_epoch", 1))
        done = False
        window_t0, window_step0 = time.perf_counter(), state.step
        for epoch in range(max_epoch):
            if done:
                break
            if self.param_scheduler is not None:
                self.param_scheduler.train()
            for batch in train_dl:
                if self.profile_steps and state.step == self.profile_steps[0]:
                    self._start_profile()
                if self._profiler is not None:
                    with tracing.span(f"train_step {state.step}"):
                        metrics = self.train_step(state, batch, seed,
                                                  sched=self._sched(state.step))
                    if state.step == self.profile_steps[1]:
                        t0 = time.perf_counter()
                        self._stop_profile()
                        window_t0 += time.perf_counter() - t0  # writing it is not training time
                else:
                    metrics = self.train_step(state, batch, seed, sched=self._sched(state.step))
                if state.step % self.log_every == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}  # waits for the card
                    if not math.isfinite(metrics["loss"]):
                        raise RuntimeError(f"non-finite loss at step {state.step}: {metrics}")
                    now = time.perf_counter()
                    sps = (state.step - window_step0) / max(now - window_t0, 1e-9)
                    window_t0, window_step0 = now, state.step
                    self._print(f"epoch {epoch} step {state.step} loss {metrics['loss']:.5f} "
                                f"({sps:.2f} it/s)")
                    self._log(logger, {"step": state.step, "epoch": epoch, "steps_per_sec": sps,
                                       **{f"train/{k}": v for k, v in metrics.items()}})
                if self.max_steps is not None and state.step >= self.max_steps:
                    done = True
                    break

            if done or epoch == max_epoch - 1 or (epoch + 1) % self.save_every == 0:
                val_loss = self.validate(state, val_dl, epoch, logger)
                self.save(state, val_loss, epoch)
                # validation is not training time
                window_t0, window_step0 = time.perf_counter(), state.step
        if self._profiler is not None:  # the run ended inside the window
            self._stop_profile()

    def _start_profile(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.task.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._profiler = profile(activities=activities)
        self._profiler.start()

    def _stop_profile(self) -> None:
        """Close the window (waiting for the card, so that the trace holds its
        kernels) and write the Chrome trace (JAX's ``[profile]`` line)."""
        if self.task.device.type == "cuda":
            torch.cuda.synchronize(self.task.device)
        prof, self._profiler = self._profiler, None
        prof.stop()
        out = os.path.join(self.output_dir, "profile")
        os.makedirs(out, exist_ok=True)
        start, stop = self.profile_steps
        prof.export_chrome_trace(os.path.join(out, f"trace_steps_{start}_{stop}.json"))
        print(f"[profile] trace written to {out}")

    def _sched(self, step: int) -> Optional[Dict[str, float]]:
        return None if self.param_scheduler is None else self.param_scheduler.step(step)

    def validate(self, state: TrainState, val_dl, epoch: int,
                 logger: Optional[MetricsLogger]) -> float:
        if self.param_scheduler is not None:
            self.param_scheduler.eval()
        sched = self._sched(state.step)
        agg: Dict[str, float] = {}
        n = 0
        for batch in val_dl:
            for k, v in self.eval_step(batch, sched).items():
                agg[k] = agg.get(k, 0.0) + float(v)
            n += 1
        if n == 0:
            # empty val split: a large sentinel that stays JSON-serializable
            return 1e30
        mean = {k: v / n for k, v in agg.items()}
        self._print(f"epoch {epoch} val loss {mean['loss']:.5f}")
        self._log(logger, {"step": state.step, "epoch": epoch,
                           **{f"val/{k}": v for k, v in mean.items()}})
        return mean["loss"]
