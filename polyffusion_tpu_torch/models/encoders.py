"""Conditioning encoders (counterpart of ``polyffusion_tpu/models/encoders.py``;
only ``ChordEncoder`` so far)."""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from .gru import BiGRU


class ChordEncoder(nn.Module):
    """bi-GRU VAE encoder over chord one-hots (B, 32, 36) -> N(mu, sigma).
    Returns (mean, std); parameter names are the reference ``RnnEncoder``'s."""

    def __init__(self, input_dim: int = 36, hidden_dim: int = 512, z_dim: int = 512):
        super().__init__()
        self.gru = BiGRU(input_dim, hidden_dim)
        self.linear_mu = nn.Linear(hidden_dim * 2, z_dim)
        self.linear_var = nn.Linear(hidden_dim * 2, z_dim)

    def forward(self, chord: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _, final = self.gru(chord)
        return self.linear_mu(final), torch.exp(self.linear_var(final))
