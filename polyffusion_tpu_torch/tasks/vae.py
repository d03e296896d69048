"""What the two VAE pretraining tasks (``chd_8bar``, ``pnotree_vae``) share:
the trainable module that holds an encoder and a decoder under the reference
VAE's names, and its seeded initialisation."""

from __future__ import annotations

import torch
from torch import nn

from ..models.unet import init_weights_


class VAE(nn.Module):
    """An encoder and a decoder as submodules ``<enc_name>``, ``<dec_name>``,
    so that the state dict is the reference VAE's (``chord_enc.*``,
    ``chord_dec.*``)."""

    def __init__(self, enc_name: str, enc: nn.Module, dec_name: str, dec: nn.Module):
        super().__init__()
        self.add_module(enc_name, enc)
        self.add_module(dec_name, dec)


def init_vae_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """``init_weights_`` for the Linear and GRU layers, then U(0, 1), the
    reference's ``torch.rand``, for the learned inputs that modules hold
    themselves (``init_input``, ``dec_init_input``, ``dur_sos_token``)."""
    init_weights_(module, generator)
    with torch.no_grad():
        for m in module.modules():
            if not isinstance(m, (nn.Linear, nn.GRU)):
                for p in m.parameters(recurse=False):
                    p.uniform_(0.0, 1.0, generator=generator)
    return module
