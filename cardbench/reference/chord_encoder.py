"""The chord VAE's encoder, plain PyTorch in float32 (Polyffusion's
``dl_modules/chord_enc.py`` ``RnnEncoder``): a bidirectional GRU over the
(B, 32, 36) chord one-hots, its two final states concatenated, the mean a
linear map of them. The diffusion model is conditioned on the mean, (B, 1,
z_dim)."""

from __future__ import annotations

import torch
from torch import nn

from .layers import Linear


class ChordEncoder(nn.Module):
    def __init__(self, input_dim: int = 36, hidden_dim: int = 512, z_dim: int = 512):
        super().__init__()
        self.gru = nn.GRU(input_dim, hidden_dim, batch_first=True, bidirectional=True)
        self.linear_mu = Linear(hidden_dim * 2, z_dim)
        self.linear_var = Linear(hidden_dim * 2, z_dim)

    def forward(self, chord: torch.Tensor) -> torch.Tensor:
        """The condition (B, 1, z_dim): the posterior's mean."""
        _, h = self.gru(chord.float())
        final = torch.cat([h[0], h[1]], dim=-1)
        return self.linear_mu(final)[:, None, :]


def build(cfg) -> ChordEncoder:
    return ChordEncoder(cfg["chd_input_dim"], cfg["chd_hidden_dim"], cfg["chd_z_dim"])
