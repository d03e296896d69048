"""Bidirectional GRU (counterpart of ``polyffusion_tpu/models/gru.py:BiGRU``).

``nn.GRU`` already has the semantics the JAX package rebuilt on ``lax.scan``:
gates packed r | z | n, the hidden bias applied inside the reset product. Its
parameter names (``weight_ih_l0``, ``weight_hh_l0_reverse``, ...) are the
reference checkpoints' names.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn


class BiGRU(nn.GRU):
    """One bidirectional batch-first layer returning (outputs (B, T, 2H),
    final state (B, 2H) = [forward | backward])."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True, bidirectional=True)

    def forward(self, xs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        outs, h = super().forward(xs)
        return outs, torch.cat([h[0], h[1]], dim=-1)
