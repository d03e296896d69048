"""PolyDis, the chord/texture disentangled VAE (counterpart of
``polyffusion_tpu/models/polydis.py``). Only its KL term is ported, for the
PianoTree VAE's pretraining; PolyDis itself is ``ROADMAP.md`` item 12."""

from __future__ import annotations

import torch


def kl_with_standard_normal(mu: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """mean KL(N(mu, std) || N(0, 1)) (JAX :25-28, reference utils kl_with_normal)."""
    var = std**2
    return torch.mean(0.5 * (var + mu**2 - 1.0 - torch.log(var)))
