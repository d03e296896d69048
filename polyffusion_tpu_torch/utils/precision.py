"""Parameter precision for sampling and training (counterpart of
``polyffusion_tpu/utils/precision.py`` and of flax's ``dtype=bf16`` over fp32
params in the JAX package's training).

Sampling re-reads every weight on each of the ~100 UNet evaluations of a
DDIM-50 + CFG request, so the weights are cast to bf16 once. Norm scales and
biases stay fp32: the fp32 statistics of the GroupNorms and LayerNorms consume
them. Since the port's modules compute in the dtype of their weights, this
cast is also what puts the model in bf16, as the JAX package's compute dtype
does (flax casts every non-norm weight and bias to it at use).
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..models.unet import GroupNorm32

NORM_TYPES = (GroupNorm32, nn.GroupNorm, nn.LayerNorm)


def cast_sampling_params(module: nn.Module) -> nn.Module:
    """In place: every floating-point parameter to bf16, except those of norm
    modules, which stay fp32."""
    for mod in module.modules():
        keep = torch.float32 if isinstance(mod, NORM_TYPES) else torch.bfloat16
        for param in mod.parameters(recurse=False):
            if param.is_floating_point():
                param.data = param.data.to(keep)
    return module


class MasterWeights:
    """fp32 master copies of a module's parameters, for training at bf16
    compute as the JAX package trains: the optimizer updates the fp32 masters;
    forward and backward run on the module itself, whose weights are a bf16
    working copy (norm scales and biases fp32, as in ``cast_sampling_params``);
    the working copy's gradients are cast to fp32 onto the masters, and after
    each update the working copy is refreshed from them. A gradient of a cast
    is the cast of the gradient, so this is what ``jax.grad`` through flax's
    at-use casts computes (``torch.autocast`` is not: it keeps its own op lists).

    With ``bf16=False`` the masters are the module's own parameters and
    nothing is copied."""

    def __init__(self, module: nn.Module, bf16: bool):
        for name, p in module.named_parameters():
            if p.is_floating_point() and p.dtype != torch.float32:
                raise ValueError(f"training needs fp32 weights, {name} is {p.dtype}: build "
                                 "the task with training=True")
        self.module = module
        self.working: List[nn.Parameter] = list(module.parameters())
        if bf16:
            self.masters = [nn.Parameter(p.detach().clone()) for p in self.working]
            cast_sampling_params(module)
        else:
            self.masters = self.working

    @property
    def shared(self) -> bool:
        return self.masters is self.working

    def zero_grad(self) -> None:
        for p in self.working:
            p.grad = None

    def grads_to_masters(self) -> None:
        if not self.shared:
            for m, p in zip(self.masters, self.working):
                m.grad = p.grad.float()

    @torch.no_grad()
    def refresh(self) -> None:
        """Working copy <- masters, cast to each working parameter's dtype."""
        if not self.shared:
            torch._foreach_copy_(self.working, self.masters)
