"""Conditioning encoders (counterpart of ``polyffusion_tpu/models/encoders.py``;
only ``ChordEncoder`` and its loader so far)."""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import chord_encoder_state_from_jax
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


def _chord_encoder_state(pretrained_dir: str) -> Dict[str, torch.Tensor]:
    """The chord encoder's state dict from ``<pretrained_dir>/chd8bar.npz`` (a
    JAX parameter tree flattened to "a/b/c" keys, as the JAX package's
    converter writes it for ``--kind chd8bar``) or
    ``chd8bar.pt`` (a reference chord-VAE checkpoint: a state dict, or one
    under ``model`` / ``state_dict``, with the encoder under ``chord_enc.``)."""
    npz_path = os.path.join(pretrained_dir, "chd8bar.npz")
    if os.path.exists(npz_path):
        tree: Dict = {}
        with np.load(npz_path) as f:
            for key in f.files:
                *path, leaf = key.split("/")
                node = tree
                for part in path:
                    node = node.setdefault(part, {})
                node[leaf] = f[key]
        return chord_encoder_state_from_jax(tree.get("chord_enc", tree))
    pt_path = os.path.join(pretrained_dir, "chd8bar.pt")
    if not os.path.exists(pt_path):
        raise FileNotFoundError(
            f"pretrained chord encoder not found: {npz_path} or {pt_path} (the "
            "reference's chd8bar checkpoint, or its conversion by the JAX package)"
        )
    obj = torch.load(pt_path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in obj.items()}
    enc = {k[len("chord_enc."):]: v for k, v in sd.items() if k.startswith("chord_enc.")}
    return enc or sd


def build_frozen_encoders(cfg, pretrained_dir: Optional[str] = None) -> Dict[str, nn.Module]:
    """The frozen encoders ``cfg`` needs (``cond_type``/``use_enc``), weights
    loaded from ``pretrained_dir``: ``{"chord_enc": ChordEncoder}`` for a chord
    condition with ``use_enc``, else ``{}``. JAX run directories of a
    ``chd_8bar`` training are not read yet."""
    cond_type = cfg.get("cond_type", "chord")
    if cond_type != "chord":
        raise NotImplementedError(f"cond_type {cond_type!r}: the port has chord only")
    if not cfg.get("use_enc", False):
        return {}
    if not pretrained_dir:
        raise FileNotFoundError(
            "this config needs the pretrained chord encoder: pass --pretrained_dir "
            "with chd8bar.pt or chd8bar.npz"
        )
    enc = ChordEncoder(cfg.get("chd_input_dim", 36), cfg.get("chd_hidden_dim", 512),
                       cfg.get("chd_z_dim", 512))
    enc.load_state_dict(_chord_encoder_state(pretrained_dir), strict=True)
    return {"chord_enc": enc}
