"""Bidirectional GRU (counterpart of ``polyffusion_tpu/models/gru.py:BiGRU``).

``nn.GRU`` already has the semantics the JAX package rebuilt on ``lax.scan``:
gates packed r | z | n, the hidden bias applied inside the reset product. Its
parameter names (``weight_ih_l0``, ``weight_hh_l0_reverse``, ...) are the
reference checkpoints' names.

With ``lengths`` the layer runs JAX's masked scan (``gru_scan`` :34-65) on the
same parameters: a step at or past a sequence's length leaves its state as it
was, in both directions, so the final state is the state at the length (the
zero initial state for length 0). ``pack_padded_sequence`` gives the same
final states but wants the lengths on the host (a wait for the card at every
call) and refuses length 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class BiGRU(nn.GRU):
    """One bidirectional batch-first layer returning (outputs (B, T, 2H),
    final state (B, 2H) = [forward | backward])."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True, bidirectional=True)

    def forward(
        self, xs: torch.Tensor, lengths: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        if lengths is None:
            outs, h = super().forward(xs)
            return outs, torch.cat([h[0], h[1]], dim=-1)
        lengths = lengths.to(xs.device)
        out_f, h_f = self._masked_scan(xs, lengths, "", reverse=False)
        out_b, h_b = self._masked_scan(xs, lengths, "_reverse", reverse=True)
        return torch.cat([out_f, out_b], dim=-1), torch.cat([h_f, h_b], dim=-1)

    def _masked_scan(self, xs, lengths, sfx: str, reverse: bool):
        """One direction over (B, T, in): the states after each step (B, T, H)
        and the final state (B, H)."""
        w_hh, b_hh = getattr(self, f"weight_hh_l0{sfx}"), getattr(self, f"bias_hh_l0{sfx}")
        gi = F.linear(xs, getattr(self, f"weight_ih_l0{sfx}"), getattr(self, f"bias_ih_l0{sfx}"))
        n_steps = xs.shape[1]
        h = xs.new_zeros(xs.shape[0], self.hidden_size)
        outs = [h] * n_steps
        for t in (reversed(range(n_steps)) if reverse else range(n_steps)):
            i_r, i_z, i_n = gi[:, t].chunk(3, dim=-1)
            h_r, h_z, h_n = F.linear(h, w_hh, b_hh).chunk(3, dim=-1)
            r = torch.sigmoid(i_r + h_r)
            z = torch.sigmoid(i_z + h_z)
            n = torch.tanh(i_n + r * h_n)
            h = torch.where((t < lengths)[:, None], (1.0 - z) * n + z * h, h)
            outs[t] = h
        return torch.stack(outs, dim=1), h


def gru_cell(gru: nn.GRU, x: torch.Tensor, h: torch.Tensor, sfx: str = "") -> torch.Tensor:
    """One step of ``gru``'s layer 0 (``sfx`` "_reverse" for its backward
    direction) from state ``h``: JAX ``gru_cell_apply`` (:22-32) on the same
    parameters, for decoders that feed each step's output back as the next
    input."""
    return torch.gru_cell(x, h, *(getattr(gru, f"{name}_l0{sfx}") for name in
                                  ("weight_ih", "weight_hh", "bias_ih", "bias_hh")))
