"""The PianoTree-VAE pretraining task (counterpart of
``polyffusion_tpu/tasks/pnotree_vae.py``): the encoder that ``sdf_pnotree``
freezes. The reference never trains it; it loads a PianoTree VAE pretrained
in the PolyDis project (``utils.py:19-45``). A random encoder's embeddings
collapse, so a diffusion model trained against it learns to ignore the
condition: pretrain here, then hand the run directory to
``build_frozen_encoders`` as ``<pretrained_dir>/pnotree/``.

Loss (reference PolyDis ``model.py:79-152``, the pnotree branch): the
teacher-forced 3-level reconstruction CE (pitch + duration, pad-masked) +
beta * KL(N(mu, std) || N(0, 1)). Each (B, 128, 20, 6) batch trains as 4B
2-bar segments, the windows ``SDFTask.encode_pnotree`` encodes.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..data.loader import decompress_batch
from ..device import DeviceLike, resolve_device
from ..models.encoders import PianoTreeEncoder
from ..models.pianotree_dec import PianoTreeDecoder, pianotree_recon_loss
from ..models.polydis import kl_with_standard_normal
from ..models.unet import init_vae_weights_
from .vae import VAE

SEG_STEPS = 32  # a 2-bar segment, in 16th-note steps


class PianoTreeNoise(NamedTuple):
    """One loss evaluation's randomness: the reparameterisation noise (4B, z),
    the time-level coins (32,) and the note-level coins (32, 19), bool."""

    z: torch.Tensor
    tf1: torch.Tensor
    tf2: torch.Tensor

    ROWS = ("z",)  # per-row draws, segment-major (a dp rank keeps its rows: parallel/mesh.py)


class PnoTreeVAETask:
    name = "pnotree_vae"
    used_batch_fields = frozenset({"pnotree"})
    bf16 = False  # JAX's PnoTreeVAETask reads no bf16 either

    def __init__(self, cfg, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        """The encoder and decoder at the reference's widths, as JAX's
        (:39-44): only z is a preset key (``pnt_z_dim``)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.beta = cfg.get("beta", 0.1)
        z = cfg.get("pnt_z_dim", 512)
        self.model = VAE("pnotree_enc", PianoTreeEncoder(z_size=z),
                         "pnotree_dec", PianoTreeDecoder(z_size=z))
        if generator is not None:
            init_vae_weights_(self.model, generator)
        self.model.to(self.device).train()

    def draw_noise(self, batch, generator: torch.Generator,
                   sched: Optional[Dict[str, float]] = None) -> PianoTreeNoise:
        """The noise, then the time-level and the note-level coins, true with
        probability ``sched["tfr_pnt1"]`` and ``["tfr_pnt2"]`` (0.5 without
        them, as JAX), from ``generator``."""
        sched = sched or {}
        dec, dev = self.model.pnotree_dec, generator.device
        b, t = batch[1].shape[:2]
        z = torch.randn((b * (t // SEG_STEPS), self.model.pnotree_enc.linear_mu.out_features),
                        generator=generator, device=dev)
        tf1 = torch.rand((dec.num_step,), generator=generator, device=dev)
        tf2 = torch.rand((dec.num_step, dec.max_simu_note - 1), generator=generator, device=dev)
        return PianoTreeNoise(z, tf1 < sched.get("tfr_pnt1", 0.5), tf2 < sched.get("tfr_pnt2", 0.5))

    def loss_fn(self, batch, noise: PianoTreeNoise) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        pnotree = decompress_batch(batch)[1].to(self.device)  # (B, 128, 20, 6)
        b, t = pnotree.shape[:2]
        x = pnotree.reshape(b * (t // SEG_STEPS), SEG_STEPS, *pnotree.shape[2:])
        enc, dec = self.model.pnotree_enc, self.model.pnotree_dec
        mu, std = enc(x)
        z = mu + std * noise.z.to(self.device)
        embedded, lengths = dec.emb_x(x)
        pitch, dur = dec(z, embedded, lengths, noise.tf1.to(self.device),
                         noise.tf2.to(self.device))
        recon, pitch_loss, dur_loss = pianotree_recon_loss(x, pitch, dur, group=dec.batch_group)
        kl = kl_with_standard_normal(mu, std)
        total = recon + self.beta * kl
        return total, {"loss": total, "recon": recon, "pitch": pitch_loss, "dur": dur_loss,
                       "kl": kl}
