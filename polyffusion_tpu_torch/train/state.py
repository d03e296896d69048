"""Train state and optimizer (counterpart of ``polyffusion_tpu/train/state.py``).

The optimizer matches the JAX package's ``optax.chain(clip_by_global_norm(max),
adam(lr))``: plain Adam per config lr (reference ``train_ldm.py:138-140``) after a
global-norm gradient clip. Mixed precision is bf16 compute over fp32 master
parameters (``utils/precision.py:MasterWeights``). The JAX state is an
immutable pytree donated to each step; here the step updates it in place.

On a mesh (``parallel/``) the state is placed by the policy: replicated over
dp (rank 0's weights broadcast), ZeRO-3 sharded (``fsdp``) or in the tp
layout. Sharded parameters are DTensors, and the masters, both Adam moments
and the EMA copy made from them are sharded alike. ``state_dict`` gathers
every tensor whole, so that a checkpoint of any placement is the one-process
format, and ``load_state_dict`` takes each rank's piece of one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from ..parallel.fsdp import shard_state_fsdp
from ..parallel.mesh import (
    dp_group,
    dp_size,
    full,
    local,
    local_chunk,
    replicated,
    set_batch_group,
    sharded_square_sums,
)
from ..parallel.tp import shard_state
from ..utils.precision import MasterWeights


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """In place, as optax's ``clip_by_global_norm``: g * max_norm / norm when
    norm >= max_norm, else g unchanged (``torch.nn.utils.clip_grad_norm_``
    divides by norm + 1e-6 and scales below the threshold too). Returns the
    norm before clipping. Never waits for the card. Sharded gradients
    (DTensors) count each element of the logical gradient once: their shards'
    squares are summed over the ranks that hold them."""
    norm = sharded_square_sums(grads).sqrt()
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    with torch.no_grad():
        torch._foreach_mul_([local(g) for g in grads], factor)
    return norm


class Optimizer:
    """Global-norm clip, then Adam (b1 0.9, b2 0.999, eps 1e-8: optax's
    defaults), over a list of fp32 parameters whose ``.grad`` is set. DTensor
    parameters form an Adam group of their own (a fused update does not mix
    DTensors and plain tensors); ``state_dict`` is the one-group format
    whatever the groups."""

    def __init__(self, params: List[nn.Parameter], learning_rate: float, max_grad_norm: float = 10.0):
        self.params = params
        self.max_grad_norm = float(max_grad_norm)
        kinds = [[p for p in params if not isinstance(p, DTensor)],
                 [p for p in params if isinstance(p, DTensor)]]
        groups = [{"params": g} for g in kinds if g]
        self.adam = torch.optim.Adam(groups, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
        # each parameter's number in Adam's own (group-major) order
        order = {id(p): i for i, p in enumerate(p for g in groups for p in g["params"])}
        self._pos = [order[id(p)] for p in params]

    def step(self) -> torch.Tensor:
        """Clip and update; returns the unclipped gradients' global norm. A
        parameter that the loss never reached (the DDPM attention's unused
        ``norm``, which JAX's tree does not hold) takes a zero gradient: Adam
        then leaves it as it is."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_([p.grad for p in self.params], self.max_grad_norm)
        self.adam.step()
        return norm

    def state_dict(self) -> Dict:
        """Adam's state in the one-group format, each moment whole (gathered
        where it is sharded: a collective)."""
        sd = self.adam.state_dict()
        group = {k: v for k, v in sd["param_groups"][0].items() if k != "params"}
        state = {i: {k: full(v) for k, v in sd["state"][pos].items()}
                 for i, pos in enumerate(self._pos) if pos in sd["state"]}
        return {"state": state,
                "param_groups": [{**group, "params": list(range(len(self.params)))}]}

    def load_state_dict(self, sd: Dict) -> None:
        """From the one-group format: each rank takes its piece of each moment."""
        hyper = {k: v for k, v in sd["param_groups"][0].items() if k != "params"}
        groups, start = [], 0
        for g in self.adam.param_groups:
            groups.append({**hyper, "params": list(range(start, start + len(g["params"])))})
            start += len(g["params"])
        state = {}
        for i, entry in sd["state"].items():
            p = self.params[int(i)]
            state[self._pos[int(i)]] = {k: _like(v, p) if k != "step" else v
                                        for k, v in entry.items()}
        self.adam.load_state_dict({"state": state, "param_groups": groups})


def _like(whole: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``whole`` laid out as ``p``: its piece, as a DTensor, where ``p`` is one."""
    if not isinstance(p, DTensor):
        return whole
    piece = local_chunk(whole, p).to(p.to_local().device)
    return DTensor.from_local(piece, p.device_mesh, p.placements, run_check=False)


def make_optimizer(params: List[nn.Parameter], learning_rate: float, max_grad_norm: float = 10.0):
    return Optimizer(params, learning_rate, max_grad_norm)


@dataclass
class TrainState:
    step: int
    weights: MasterWeights  # the module's working copy and the fp32 masters
    optimizer: Optimizer
    # exponential moving average of the masters (fp32); None unless the run
    # sets the ``ema_decay`` config key (the reference has no EMA)
    ema: Optional[List[torch.Tensor]] = None

    def _names(self) -> List[str]:
        return [n for n, _ in self.weights.module.named_parameters()]

    def params(self) -> Dict[str, torch.Tensor]:
        """The fp32 master parameters by the module's parameter names, whole
        (gathered where sharded: a collective)."""
        return {n: full(m) for n, m in zip(self._names(), self.weights.masters)}

    def state_dict(self) -> Dict:
        """Every tensor whole (a collective on a mesh): the one-process format."""
        names = self._names()
        return {
            "step": self.step,
            "params": {n: full(m).detach() for n, m in zip(names, self.weights.masters)},
            "opt_state": self.optimizer.state_dict(),
            "ema": None if self.ema is None else {n: full(e) for n, e in zip(names, self.ema)},
        }

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> None:
        names = self._names()
        if set(sd["params"]) != set(names):
            raise KeyError("checkpoint parameters do not match the model's")
        for n, m in zip(names, self.weights.masters):
            local(m).copy_(local_chunk(sd["params"][n], m))
        self.weights.refresh()
        self.optimizer.load_state_dict(sd["opt_state"])
        if self.ema is not None and sd.get("ema") is not None:
            for n, e in zip(names, self.ema):
                local(e).copy_(local_chunk(sd["ema"][n], e))
        self.step = int(sd["step"])


def place(module: nn.Module, mesh: DeviceMesh, fsdp: bool = False, bf16: bool = False) -> nn.Module:
    """In place: ``module`` laid out on ``mesh`` by the policy. Rank 0's
    weights are broadcast, batch statistics are taken over the global batch
    (``parallel.mesh.set_batch_group``), then the parameters are ZeRO-3
    sharded over dp (``fsdp``), put in the tp layout on a tp mesh, or left
    replicated."""
    replicated(module)
    set_batch_group(module, dp_group(mesh) if dp_size(mesh) > 1 else None)
    if fsdp:
        return shard_state_fsdp(module, mesh, torch.bfloat16 if bf16 else None)
    return shard_state(module, mesh)


def create_state(
    module: nn.Module,
    learning_rate: float,
    max_grad_norm: float = 10.0,
    bf16: bool = False,
    ema_decay: Optional[float] = None,
    mesh: Optional[DeviceMesh] = None,
    fsdp: bool = False,
) -> TrainState:
    """Masters from ``module``'s fp32 weights (which become the bf16 working
    copy when ``bf16``), Adam over the masters, and an fp32 EMA copy of them
    when ``ema_decay`` is set. ``mesh``: place ``module`` on it first
    (``place``; ``fsdp`` shards the state ZeRO-3 style)."""
    if fsdp and mesh is None:
        raise ValueError("fsdp=True needs a dp mesh (parallel.make_mesh)")
    if mesh is not None:
        place(module, mesh, fsdp, bf16)
    weights = MasterWeights(module, bf16, fsdp=fsdp)
    return TrainState(
        step=0,
        weights=weights,
        optimizer=make_optimizer(weights.masters, learning_rate, max_grad_norm),
        ema=[m.detach().clone() for m in weights.masters] if ema_decay else None,
    )


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
