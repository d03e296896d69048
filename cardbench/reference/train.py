"""The training step, plain PyTorch in float32: the diffusion loss over the
batch, its gradient, a clip of the global norm to ``max_grad_norm`` (g times
max / norm where the norm is at least max, optax's ``clip_by_global_norm``)
and Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected) on float32 parameters.

The batch's mean is taken over blocks of rows, each block's backward run
before the next block's forward, so that a large batch fits."""

from __future__ import annotations

from typing import Callable, Dict, List

import torch
from torch import nn

B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    def __init__(self, params: List[torch.Tensor], lr: float, max_grad_norm: float):
        self.params, self.lr, self.max_norm = params, lr, max_grad_norm
        self.m = [torch.zeros_like(p) for p in params]
        self.v = [torch.zeros_like(p) for p in params]
        self.count = 0
        self.first_grads = None  # the clipped gradient of the first step

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> float:
        norm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads)).item()
        factor = self.max_norm / norm if norm >= self.max_norm else 1.0
        grads = [g * factor for g in grads]
        if self.first_grads is None:
            self.first_grads = [g.clone() for g in grads]
        self.count += 1
        c1, c2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(B1).add_(g, alpha=1 - B1)
            v.mul_(B2).addcmul_(g, g, value=1 - B2)
            p.sub_(self.lr * (m / c1) / ((v / c2).sqrt() + EPS))
        return norm


def one_step(model: nn.Module, opt: Adam, step_loss: Callable, i: int, n_rows: int,
             n_terms: int, block: int) -> float:
    """Step i: ``step_loss(model, i, rows)`` summed over blocks of ``block``
    rows, over ``n_terms``, its gradient, the clip and Adam; returns the loss."""
    params = [p for p in model.parameters()]
    for p in params:
        p.grad = None
    total = 0.0
    for lo in range(0, n_rows, block):
        part = step_loss(model, i, slice(lo, min(lo + block, n_rows))) / n_terms
        part.backward()
        total += float(part.detach())
    opt.step([p.grad if p.grad is not None else torch.zeros_like(p) for p in params])
    return total


def train_steps(model: nn.Module, step_loss: Callable, batches, lr: float,
                max_grad_norm: float, block: int) -> Dict:
    """``len(batches)`` steps from ``model``'s weights. ``step_loss(model,
    i, rows)`` is the sum of step i's loss terms over the batch's ``rows``
    (a slice); each step's loss is that sum over all rows over the count of
    terms, which ``batches[i]`` (the number of terms) gives. Returns the
    losses, the first clipped gradient per leaf and the parameters after the
    last step, by name."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    opt = Adam([p.data for p in params], lr, max_grad_norm)
    losses = [one_step(model, opt, step_loss, i, n_rows, n_terms, block)
              for i, (n_rows, n_terms) in enumerate(batches)]
    return {
        "loss": losses,
        "first_grad": dict(zip(names, opt.first_grads)),
        "params": {n: p.detach().clone() for n, p in zip(names, params)},
    }


NORMS = (nn.GroupNorm, nn.LayerNorm)


def working_dtypes(model: nn.Module, precision: str) -> Dict[str, torch.dtype]:
    """The type each parameter is computed in, by name, as the configuration
    states it: in a ``bf16`` configuration bfloat16, except a norm's scale and
    shift, which stay float32 (the softmax and the norms' statistics are
    float32 too); float32 in any other."""
    out = {}
    for prefix, mod in model.named_modules():
        keep = precision != "bf16" or isinstance(mod, NORMS)
        for name, _ in mod.named_parameters(recurse=False):
            out[f"{prefix}.{name}" if prefix else name] = (
                torch.float32 if keep else torch.bfloat16)
    return out
