"""Symmetric int8 weight quantization (counterpart of
``polyffusion_tpu/ops/quant.py:quantize_weight``, for the port's (O, C, kh, kw)
convolution weights).

Only the weight half of the JAX module is here: the fused int8 kernel
(``ops/fused_gn_conv.py``) quantizes its activations itself. The JAX package's
XLA int8 route (``quantize_act``, ``int8_conv``) is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, C, kh, kw) float -> (int8 of the same shape, (O,) fp32 scales):
    per output channel, scale = max(amax over (C, kh, kw), 1e-8) / 127 and
    q = clip(round(w / scale), -127, 127), rounding half to even as
    ``jnp.round`` does."""
    w32 = w.float()
    amax = torch.clamp(w32.abs().amax(dim=(1, 2, 3)), min=1e-8)
    scale = amax / 127.0
    q = torch.clamp(torch.round(w32 / scale[:, None, None, None]), -127, 127)
    return q.to(torch.int8), scale
