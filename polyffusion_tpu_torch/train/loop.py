"""The training loop: run-directory lifecycle, epochs, validation, checkpoints
(counterpart of ``polyffusion_tpu/train/loop.py``, one device).

- run dir with ``params.yaml`` and a drift warning on resume;
- ``torch.save`` checkpoints under ``chkpts/``: the best ``keep_checkpoints`` by
  val loss (``step_<n>.pt``, listed in ``best.json``) and a rolling ``last.pt``,
  written at every save, for resume (the reference's save_last=True);
- a NaN-loss check (raises, like ``lightning_learner.py:29-33``) at logging
  boundaries only, so that no step waits for the card;
- metrics to stdout and ``metrics.jsonl``, with ``steps_per_sec``;
- an optional ``ParameterScheduler`` (teacher forcing) whose values for the
  current step reach the task's ``draw_noise``; validation runs it in eval
  mode, which pins teacher forcing to its floor.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Dict, List, Optional

import torch
import yaml

from ..config import Params, params_differ, save_params
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
    ):
        """``task`` must hold fp32 weights (built with ``training=True``); the
        trainer trains ``task.model``, in bf16 over fp32 masters where
        ``task.bf16``. ``save_every``: validate and checkpoint every N epochs
        (default 1, the reference's per-epoch cadence; the final epoch always
        saves). ``param_scheduler``: a ``train.schedulers.ParameterScheduler``
        or None."""
        self.task = task
        self.cfg = cfg
        self.param_scheduler = param_scheduler
        self.max_steps = max_steps
        self.log_every = log_every
        self.keep_checkpoints = keep_checkpoints
        self.save_every = max(1, int(save_every))

        os.makedirs(output_dir, exist_ok=True)
        self.output_dir = output_dir
        self.ckpt_dir = os.path.join(output_dir, "chkpts")
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
        self.train_step = make_train_step(task, ema_decay=self.ema_decay)
        self.eval_step = make_eval_step(task)

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

    def save(self, state: TrainState, val_loss: float) -> None:
        """Rolling ``last.pt``, and ``step_<n>.pt`` if it is among the best
        ``keep_checkpoints`` val losses (a worse one is not kept)."""
        ckpt = {**state.state_dict(), "val_loss": float(val_loss)}
        self._write(ckpt, "last.pt")
        best = [e for e in self._best_index() if e["step"] != state.step]
        best.append({"step": state.step, "val_loss": float(val_loss)})
        best.sort(key=lambda e: (e["val_loss"], -e["step"]))
        keep, drop = best[: self.keep_checkpoints], best[self.keep_checkpoints:]
        if any(e["step"] == state.step for e in keep):
            self._write(ckpt, f"step_{state.step}.pt")
        for e in drop:
            path = os.path.join(self.ckpt_dir, f"step_{e['step']}.pt")
            if os.path.exists(path):
                os.remove(path)
        with open(os.path.join(self.ckpt_dir, "best.json.tmp"), "w") as f:
            json.dump(keep, f)
        os.replace(os.path.join(self.ckpt_dir, "best.json.tmp"),
                   os.path.join(self.ckpt_dir, "best.json"))

    def try_restore(self, state: TrainState) -> TrainState:
        """Load ``last.pt``, which every save writes. It is read to the CPU: the
        optimizer moves its moments to the masters' device itself and keeps its
        step counts on the host, so that no update waits for the card."""
        path = os.path.join(self.ckpt_dir, "last.pt")
        if not os.path.exists(path):
            return state
        state.load_state_dict(torch.load(path, map_location="cpu", weights_only=True))
        print(f"[resume] restored checkpoint at step {state.step}")
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
        )
        print(f"[model] {param_count(self.task.model) / 1e6:.2f}M trainable params")
        if resume:
            state = self.try_restore(state)
        logger = MetricsLogger(self.output_dir)
        try:
            self._fit(state, train_dl, val_dl, seed, logger)
        finally:
            logger.close()
        return state

    def _fit(self, state: TrainState, train_dl, val_dl, seed: int, logger: MetricsLogger) -> None:
        max_epoch = int(self.cfg.get("max_epoch", 1))
        done = False
        window_t0, window_step0 = time.perf_counter(), state.step
        for epoch in range(max_epoch):
            if done:
                break
            if self.param_scheduler is not None:
                self.param_scheduler.train()
            for batch in train_dl:
                metrics = self.train_step(state, batch, seed, sched=self._sched(state.step))
                if state.step % self.log_every == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}  # waits for the card
                    if not math.isfinite(metrics["loss"]):
                        raise RuntimeError(f"non-finite loss at step {state.step}: {metrics}")
                    now = time.perf_counter()
                    sps = (state.step - window_step0) / max(now - window_t0, 1e-9)
                    window_t0, window_step0 = now, state.step
                    print(f"epoch {epoch} step {state.step} loss {metrics['loss']:.5f} "
                          f"({sps:.2f} it/s)")
                    logger.log({"step": state.step, "epoch": epoch, "steps_per_sec": sps,
                                **{f"train/{k}": v for k, v in metrics.items()}})
                if self.max_steps is not None and state.step >= self.max_steps:
                    done = True
                    break

            if done or epoch == max_epoch - 1 or (epoch + 1) % self.save_every == 0:
                val_loss = self.validate(state, val_dl, epoch, logger)
                self.save(state, val_loss)
                # validation is not training time
                window_t0, window_step0 = time.perf_counter(), state.step

    def _sched(self, step: int) -> Optional[Dict[str, float]]:
        return None if self.param_scheduler is None else self.param_scheduler.step(step)

    def validate(self, state: TrainState, val_dl, epoch: int, logger: MetricsLogger) -> float:
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
        print(f"epoch {epoch} val loss {mean['loss']:.5f}")
        logger.log({"step": state.step, "epoch": epoch, **{f"val/{k}": v for k, v in mean.items()}})
        return mean["loss"]
