"""Train state and optimizer (counterpart of ``polyffusion_tpu/train/state.py``).

The optimizer matches the JAX package's ``optax.chain(clip_by_global_norm(max),
adam(lr))``: plain Adam per config lr (reference ``train_ldm.py:138-140``) after a
global-norm gradient clip. Mixed precision is bf16 compute over fp32 master
parameters (``utils/precision.py:MasterWeights``). The JAX state is an
immutable pytree donated to each step; here the step updates it in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch
from torch import nn

from ..utils.precision import MasterWeights


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, fp32, on the device."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm([t.float() for t in tensors])), 2
    )


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """In place, as optax's ``clip_by_global_norm``: g * max_norm / norm when
    norm >= max_norm, else g unchanged (``torch.nn.utils.clip_grad_norm_``
    divides by norm + 1e-6 and scales below the threshold too). Returns the
    norm before clipping. Never waits for the card."""
    norm = global_norm(grads)
    factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, factor)
    return norm


class Optimizer:
    """Global-norm clip, then Adam (b1 0.9, b2 0.999, eps 1e-8: optax's
    defaults), over a list of fp32 parameters whose ``.grad`` is set."""

    def __init__(self, params: List[nn.Parameter], learning_rate: float, max_grad_norm: float = 10.0):
        self.params = params
        self.max_grad_norm = float(max_grad_norm)
        self.adam = torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)

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
        return self.adam.state_dict()

    def load_state_dict(self, sd: Dict) -> None:
        self.adam.load_state_dict(sd)


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

    def params(self) -> Dict[str, torch.Tensor]:
        """The fp32 master parameters by the module's parameter names."""
        names = [n for n, _ in self.weights.module.named_parameters()]
        return dict(zip(names, self.weights.masters))

    def state_dict(self) -> Dict:
        names = [n for n, _ in self.weights.module.named_parameters()]
        return {
            "step": self.step,
            "params": {n: m.detach() for n, m in zip(names, self.weights.masters)},
            "opt_state": self.optimizer.state_dict(),
            "ema": None if self.ema is None else dict(zip(names, self.ema)),
        }

    @torch.no_grad()
    def load_state_dict(self, sd: Dict) -> None:
        names = [n for n, _ in self.weights.module.named_parameters()]
        if set(sd["params"]) != set(names):
            raise KeyError("checkpoint parameters do not match the model's")
        for n, m in zip(names, self.weights.masters):
            m.copy_(sd["params"][n])
        self.weights.refresh()
        self.optimizer.load_state_dict(sd["opt_state"])
        if self.ema is not None and sd.get("ema") is not None:
            for n, e in zip(names, self.ema):
                e.copy_(sd["ema"][n])
        self.step = int(sd["step"])


def create_state(
    module: nn.Module,
    learning_rate: float,
    max_grad_norm: float = 10.0,
    bf16: bool = False,
    ema_decay: Optional[float] = None,
) -> TrainState:
    """Masters from ``module``'s fp32 weights (which become the bf16 working
    copy when ``bf16``), Adam over the masters, and an fp32 EMA copy of them
    when ``ema_decay`` is set."""
    weights = MasterWeights(module, bf16)
    return TrainState(
        step=0,
        weights=weights,
        optimizer=make_optimizer(weights.masters, learning_rate, max_grad_norm),
        ema=[m.detach().clone() for m in weights.masters] if ema_decay else None,
    )


def param_count(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
