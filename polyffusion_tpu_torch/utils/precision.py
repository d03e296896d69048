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
from torch.distributed.tensor import DTensor

from ..models.unet import GroupNorm32

NORM_TYPES = (GroupNorm32, nn.GroupNorm, nn.LayerNorm)


def keeps_fp32(mod: nn.Module) -> bool:
    """Whether ``mod``'s own parameters stay fp32 in a bf16 model: a norm's,
    and those of modules whose ``keep_fp32`` is true (the discriminator's
    batch norms, the autoencoder's ``logvar``: parameters the JAX package
    uses uncast)."""
    return isinstance(mod, NORM_TYPES) or getattr(mod, "keep_fp32", False)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _cast(mod: nn.Module, name: str, param: nn.Parameter, dtype: torch.dtype) -> None:
    if isinstance(param, DTensor):
        # a DTensor's ``.data`` cannot change dtype: register a cast copy
        mod.register_parameter(name, nn.Parameter(param.detach().to(dtype),
                                                  requires_grad=param.requires_grad))
    else:
        param.data = param.data.to(dtype)


def cast_sampling_params(module: nn.Module, skip=frozenset()) -> nn.Module:
    """In place: every floating-point parameter to bf16, except those of the
    modules ``keeps_fp32`` picks, which stay fp32, and those in ``skip``."""
    for mod in module.modules():
        keep = torch.float32 if keeps_fp32(mod) else torch.bfloat16
        for name, param in list(mod.named_parameters(recurse=False)):
            if param.is_floating_point() and param not in skip:
                _cast(mod, name, param, keep)
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
    nothing is copied. ``fsdp``: the module's DTensor parameters are FSDP2's
    sharded ones, which are their own masters (FSDP2 casts them at each
    gather); the others are handled as above."""

    def __init__(self, module: nn.Module, bf16: bool, fsdp: bool = False):
        for name, p in module.named_parameters():
            if p.is_floating_point() and p.dtype != torch.float32:
                raise ValueError(f"training needs fp32 weights, {name} is {p.dtype}: build "
                                 "the task with training=True")
        self.module = module
        self.working: List[nn.Parameter] = list(module.parameters())
        if bf16:
            own = {p for p in self.working if fsdp and isinstance(p, DTensor)}
            self.masters = [p if p in own else nn.Parameter(p.detach().clone())
                            for p in self.working]
            cast_sampling_params(module, skip=own)
            self.working = list(module.parameters())  # a cast DTensor is a new parameter
        else:
            self.masters = self.working

    @property
    def shared(self) -> bool:
        return self.masters is self.working

    def _pairs(self):
        return [(m, p) for m, p in zip(self.masters, self.working) if m is not p]

    def zero_grad(self) -> None:
        for p in self.working:
            p.grad = None

    def grads_to_masters(self) -> None:
        for m, p in self._pairs():
            m.grad = None if p.grad is None else p.grad.float()

    @torch.no_grad()
    def refresh(self) -> None:
        """Working copy <- masters, cast to each working parameter's dtype."""
        pairs = self._pairs()
        if pairs:
            torch._foreach_copy_([_local(p) for _, p in pairs], [_local(m) for m, _ in pairs])
