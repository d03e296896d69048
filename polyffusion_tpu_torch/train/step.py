"""Train and eval steps (counterpart of ``polyffusion_tpu/train/step.py``).

The JAX step is one jitted XLA program over a donated state; here it is eager
PyTorch that updates the state in place: forward and backward on the module's
working copy, gradients onto the fp32 masters, clip, Adam, refresh of the
working copy, EMA. No step waits for the card: the metrics stay on the device
until the caller reads them.

On a mesh (the state placed by ``train.state.create_state(mesh=...)``) each
rank holds its rows of the global batch and draws the global step noise from
``step_generator(seed, step)``, keeping its rows, so that a dp step equals the
one-process step of the whole batch. The fp32 master gradients are averaged
over dp after ``grads_to_masters`` (FSDP2 reduce-scatters its sharded ones in
fp32 itself), the clip counts each logical element once, and the metrics are
means over the global batch. A loss that is already the global batch's on
every rank (a masked mean summed over the task's batch group, e.g. the
PianoTree decoder's) gives each rank the same metrics and a gradient share
summed over the group, so this averaging gives the global-batch step too.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from ..models.unet import INT8_MODES
from ..parallel.mesh import (
    DP,
    all_reduce_mean_,
    batch_sharding,
    dp_group,
    global_view,
    keep_rows,
    local,
)
from ..parallel.tp import TP
from .state import TrainState


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """The generator of one step's randomness, seeded from (seed, step): the
    counterpart of ``jax.random.fold_in(rng, state.step)``, so that a resumed
    run draws what a straight run draws without saving generator state."""
    return torch.Generator(device=device).manual_seed(((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF))


def _check(task, mesh, fsdp: bool) -> None:
    """JAX's refusals (``train/step.py:79-90``), fsdp without a mesh, and a
    UNet on a sampling-only int8 route (its convolutions have no gradient)."""
    if getattr(task, "gn_conv", None) in INT8_MODES:
        raise ValueError(f"gn_conv={task.gn_conv!r} is sampling-only (no gradient): train "
                         "with 'unfused' or 'fused'")
    if mesh is None:
        if fsdp:
            raise ValueError("fsdp=True needs a dp mesh (parallel.make_mesh)")
        return
    tp = TP in (mesh.mesh_dim_names or ())
    if getattr(task, "has_frozen", False) and tp:
        raise ValueError("distillation (frozen-teacher tasks) on a tp mesh is unimplemented")
    if fsdp and tp:
        raise ValueError(
            "fsdp=True is not supported on a tp mesh: tp shards params by the "
            "Megatron policy; combine dp-axis fsdp with tp is unimplemented. "
            "Drop 'fsdp: true' or use a dp-only mesh.")


def _draw(task, batch, generator, sched, shard):
    """The step's noise: drawn for the global batch, this rank's rows kept."""
    if shard is None:
        return task.draw_noise(batch, generator, sched)
    return keep_rows(task.draw_noise(global_view(batch, shard.count), generator, sched), shard)


def _global_means(metrics: Dict[str, torch.Tensor], mesh, skip=()) -> Dict[str, torch.Tensor]:
    """Each metric's mean over dp: its value for the global batch."""
    keys = [k for k in metrics if k not in skip]
    if mesh is None or not keys:
        return metrics
    vals = [torch.as_tensor(metrics[k], dtype=torch.float32).reshape(1) for k in keys]
    all_reduce_mean_(vals, dp_group(mesh), batch_sharding(mesh).count)
    return {**metrics, **{k: v[0] for k, v in zip(keys, vals)}}


def _reduce_gradients(masters, mesh) -> None:
    """Average the master gradients over dp, except FSDP2's (reduced)."""
    with torch.no_grad():
        grads = [local(m.grad) for m in masters if m.grad is not None and not (
            isinstance(m, DTensor) and DP in m.device_mesh.mesh_dim_names)]
        all_reduce_mean_(grads, dp_group(mesh), batch_sharding(mesh).count)


def make_train_step(task, ema_decay: Optional[float] = None, mesh=None,
                    fsdp: bool = False):
    """Returns ``step_fn(state, batch, seed, noise=None, sched=None) ->
    metrics``: one update of ``state`` in place. ``noise`` (the task's
    randomness, e.g. ``StepNoise``) replaces what the step would draw from
    ``step_generator(seed, state.step)``; ``sched`` (the step's scheduled
    values, e.g. teacher-forcing rates) reaches the task's ``draw_noise``,
    with the step's number as ``"global_step"`` (the autoencoder's
    discriminator gate reads it).

    ``ema_decay``: when set (and ``state.ema`` is populated), the step also
    keeps an fp32 exponential moving average of the masters, taken after the
    update: e * d + p * (1 - d).

    ``mesh``: the mesh the state was placed on. ``batch`` is then this
    rank's rows and ``noise``, where given, the global batch's (each rank
    keeps its rows). ``fsdp``: the state is ZeRO-3 sharded. Raises JAX's
    ``ValueError`` for a distillation task or ``fsdp`` on a tp mesh."""
    _check(task, mesh, fsdp)
    shard = None if mesh is None else batch_sharding(mesh)

    def step(state: TrainState, batch, seed: int, noise=None, sched=None) -> Dict[str, torch.Tensor]:
        if noise is None:
            # the step's number reaches the task as JAX's sched_params["global_step"]
            sched = {**(sched or {}), "global_step": state.step}
            noise = _draw(task, batch, step_generator(seed, state.step, task.device), sched, shard)
        elif shard is not None:
            noise = keep_rows(noise, shard)
        weights = state.weights
        weights.zero_grad()
        loss, metrics = task.loss_fn(batch, noise)
        loss.backward()
        weights.grads_to_masters()
        if mesh is not None:
            _reduce_gradients(weights.masters, mesh)
        metrics = dict(metrics)
        metrics["grad_norm"] = state.optimizer.step()
        weights.refresh()
        if ema_decay is not None and state.ema is not None:
            d = float(ema_decay)
            with torch.no_grad():
                ema = [local(e) for e in state.ema]
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, [local(m) for m in weights.masters], alpha=1.0 - d)
        state.step += 1
        return _global_means({k: v.detach() for k, v in metrics.items()}, mesh, ("grad_norm",))

    return step


def make_eval_step(task, mesh=None, fsdp: bool = False):
    """Deterministic eval step: ``eval_fn(batch, sched=None) -> metrics``, each
    batch with the randomness of ``step_generator(0, 0)`` (the JAX eval step
    takes one fixed key), so the same coins for every batch at the same
    ``sched``, without gradients. ``mesh``: ``batch`` is this rank's rows and
    the metrics are means over the global batch (the module keeps its
    placement, ``fsdp`` or not)."""
    _check(None, mesh, fsdp)
    shard = None if mesh is None else batch_sharding(mesh)

    def step(batch, sched=None) -> Dict[str, torch.Tensor]:
        # JAX's eval step hands the loss no step, which the autoencoder reads
        # as past its discriminator gate
        sched = {**(sched or {}), "global_step": math.inf}
        with torch.no_grad():
            noise = _draw(task, batch, step_generator(0, 0, task.device), sched, shard)
            _, metrics = task.loss_fn(batch, noise)
        return _global_means({k: v.detach() for k, v in metrics.items()}, mesh)

    return step
