"""Parameter precision for sampling (counterpart of
``polyffusion_tpu/utils/precision.py``).

Sampling re-reads every weight on each of the ~100 UNet evaluations of a
DDIM-50 + CFG request, so the weights are cast to bf16 once. Norm scales and
biases stay fp32: the fp32 statistics of the GroupNorms and LayerNorms consume
them. Since the port's modules compute in the dtype of their weights, this
cast is also what puts the model in bf16, as the JAX package's compute dtype
does (flax casts every non-norm weight and bias to it at use).
"""

from __future__ import annotations

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
