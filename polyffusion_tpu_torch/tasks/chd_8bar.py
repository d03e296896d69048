"""The chord-VAE pretraining task (counterpart of
``polyffusion_tpu/tasks/chd_8bar.py``; reference ``models/model_chd_8bar.py``).

Encode the chord one-hots to N(mu, sigma), draw a reparameterised sample,
decode autoregressively with scheduled teacher forcing; the loss is the CE of
root, chroma and bass. Like the reference, no KL term
(``model_chd_8bar.py:41-48``). Its run directory is what
``build_frozen_encoders`` reads as ``<pretrained_dir>/chd8bar/``.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..data.loader import decompress_batch
from ..device import DeviceLike, resolve_device
from ..models.encoders import ChordDecoder, ChordEncoder, chord_recon_loss
from ..models.unet import init_vae_weights_
from .vae import VAE


class ChordNoise(NamedTuple):
    """One loss evaluation's randomness: the reparameterisation noise (B, z)
    and the decoder's teacher-forcing coins (n_step,) bool."""

    z: torch.Tensor
    tf: torch.Tensor


class Chd8BarTask:
    name = "chd_8bar"
    used_batch_fields = frozenset({"chord"})
    # the preset says bf16: true, but JAX's Chd8BarTask never reads it: the
    # chord VAE trains in fp32
    bf16 = False

    def __init__(self, cfg, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        """``generator``: a CPU generator from which the weights are drawn;
        without it they keep torch's default init."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = VAE(
            "chord_enc",
            ChordEncoder(cfg.get("chd_input_dim", 36), cfg.get("chd_hidden_dim", 512),
                         cfg.get("chd_z_dim", 512)),
            "chord_dec",
            ChordDecoder(cfg.get("chd_input_dim", 36), cfg.get("chd_z_input_dim", 512),
                         cfg.get("chd_hidden_dim", 512), cfg.get("chd_z_dim", 512),
                         cfg.get("chd_n_step", 32)),
        )
        if generator is not None:
            init_vae_weights_(self.model, generator)
        self.model.to(self.device).train()

    def draw_noise(self, batch, generator: torch.Generator,
                   sched: Optional[Dict[str, float]] = None) -> ChordNoise:
        """The noise, then one coin a decoder step, true with probability
        ``sched["tfr_chd"]`` (0.5 without it, as JAX), from ``generator``."""
        tfr = (sched or {}).get("tfr_chd", 0.5)
        dev = generator.device
        z = torch.randn((batch[2].shape[0], self.model.chord_enc.linear_mu.out_features),
                        generator=generator, device=dev)
        tf = torch.rand((self.model.chord_dec.n_step,), generator=generator, device=dev) < tfr
        return ChordNoise(z, tf)

    def loss_fn(self, batch, noise: ChordNoise) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        chord = decompress_batch(batch)[2].to(self.device, torch.float32)  # (B, 32, 36)
        mu, std = self.model.chord_enc(chord)
        z = mu + std * noise.z.to(self.device)
        total, root, chroma, bass = chord_recon_loss(
            chord, *self.model.chord_dec(z, noise.tf.to(self.device), chord))
        return total, {"loss": total, "root": root, "chroma": chroma, "bass": bass}
