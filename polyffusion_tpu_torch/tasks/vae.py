"""What the two VAE pretraining tasks (``chd_8bar``, ``pnotree_vae``) share:
the trainable module that holds an encoder and a decoder under the reference
VAE's names (its seeded initialisation is ``models.unet.init_vae_weights_``)."""

from __future__ import annotations

from torch import nn


class VAE(nn.Module):
    """An encoder and a decoder as submodules ``<enc_name>``, ``<dec_name>``,
    so that the state dict is the reference VAE's (``chord_enc.*``,
    ``chord_dec.*``)."""

    def __init__(self, enc_name: str, enc: nn.Module, dec_name: str, dec: nn.Module):
        super().__init__()
        self.add_module(enc_name, enc)
        self.add_module(dec_name, dec)
