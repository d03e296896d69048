"""Train and eval steps on one device (counterpart of the single-device part of
``polyffusion_tpu/train/step.py``).

The JAX step is one jitted XLA program over a donated state; here it is eager
PyTorch that updates the state in place: forward and backward on the module's
working copy, gradients onto the fp32 masters, clip, Adam, refresh of the
working copy, EMA. No step waits for the card: the metrics stay on the device
until the caller reads them.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .state import TrainState


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of one step's randomness, seeded from (seed, step): the
    counterpart of ``jax.random.fold_in(rng, state.step)``, so that a resumed
    run draws what a straight run draws without saving generator state."""
    return torch.Generator(device=device).manual_seed(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))


def make_train_step(task, ema_decay: Optional[float] = None):
    """Returns ``step_fn(state, batch, seed, noise=None, sched=None) ->
    metrics``: one update of ``state`` in place. ``noise`` (the task's
    randomness, e.g. ``StepNoise``) replaces what the step would draw from
    ``step_generator(seed, state.step)``; ``sched`` (the step's scheduled
    values, e.g. teacher-forcing rates) reaches the task's ``draw_noise``.

    ``ema_decay``: when set (and ``state.ema`` is populated), the step also
    keeps an fp32 exponential moving average of the masters, taken after the
    update: e * d + p * (1 - d)."""

    def step(state: TrainState, batch, seed: int, noise=None, sched=None) -> Dict[str, torch.Tensor]:
        if noise is None:
            noise = task.draw_noise(batch, step_generator(seed, state.step, task.device), sched)
        weights = state.weights
        weights.zero_grad()
        loss, metrics = task.loss_fn(batch, noise)
        loss.backward()
        weights.grads_to_masters()
        metrics = dict(metrics)
        metrics["grad_norm"] = state.optimizer.step()
        weights.refresh()
        if ema_decay is not None and state.ema is not None:
            d = float(ema_decay)
            with torch.no_grad():
                torch._foreach_mul_(state.ema, d)
                torch._foreach_add_(state.ema, weights.masters, alpha=1.0 - d)
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return step


def make_eval_step(task):
    """Deterministic eval step: ``eval_fn(batch, sched=None) -> metrics``, each
    batch with the randomness of ``step_generator(0, 0)`` (the JAX eval step
    takes one fixed key), so the same coins for every batch at the same
    ``sched``, without gradients."""

    def step(batch, sched=None) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            noise = task.draw_noise(batch, step_generator(0, 0, task.device), sched)
            _, metrics = task.loss_fn(batch, noise)
        return dict(metrics)

    return step
