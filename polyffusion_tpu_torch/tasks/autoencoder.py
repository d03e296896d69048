"""The autoencoder training task (counterpart of the JAX package's
``tasks/autoencoder.py``; reference ``models/model_autoencoder.py`` +
``train/train_autoencoder.py``).

The 2-channel prmat2c is padded to ``in_channels`` and the KL autoencoder
trained against a PatchGAN discriminator: the autoencoder ``ae``, the
discriminator ``disc`` and the output log-variance ``logvar`` are one module,
trained by one Adam, the generator and discriminator losses summed with
their gradients kept apart (the discriminator's parameters frozen in the
generator's loss, the reconstructions detached in the discriminator's), as
the JAX package's one-optimizer step does.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn
from torch.func import functional_call

from ..convert import reference_state
from ..data.loader import decompress_batch
from ..device import DeviceLike, resolve_device
from ..models.autoencoder import Autoencoder
from ..models.losses import (
    NLayerDiscriminator,
    adaptive_disc_weight,
    ae_discriminator_loss,
    ae_generator_loss,
)
from ..models.lpips import LPIPS, lpips_state_from_torch
from ..models.unet import init_weights_
from ..utils.precision import cast_sampling_params


class AENoise(NamedTuple):
    """One loss evaluation's inputs besides the batch: the reparameterisation
    noise (B, emb_channels, h, w) and the global step that gates the
    discriminator (+inf: past every gate, as JAX's loss without a step)."""

    eps: torch.Tensor
    global_step: float


class AutoencoderModel(nn.Module):
    """The task's trainable module: the autoencoder, the discriminator and
    the scalar output log-variance (the JAX task's ``ae``, ``disc`` and
    ``logvar``; reference ``contperceptual.py`` keeps ``logvar``)."""

    keep_fp32 = True  # its own parameter, logvar, stays fp32 in a bf16 model

    def __init__(self, ae: Autoencoder, disc: NLayerDiscriminator):
        super().__init__()
        self.ae = ae
        self.disc = disc
        self.logvar = nn.Parameter(torch.zeros(()))


class AutoencoderTask:
    name = "autoencoder"
    used_batch_fields = frozenset({"prmat2c"})

    def __init__(self, cfg, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        """``generator``: a CPU generator from which the weights are drawn;
        without it they keep torch's default init. ``lpips_path``: an LPIPS
        checkpoint in the reference's layout (or torchvision ``features.*``
        keys with the ``lin*`` heads), which switches the perceptual term on
        at ``perceptual_weight``."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.bf16 = bool(cfg.get("bf16", False))
        ae = Autoencoder(
            channels=cfg.get("channels", 64),
            channel_multipliers=tuple(cfg.get("channel_multipliers", (1, 2, 4, 4))),
            n_resnet_blocks=cfg.get("n_res_blocks", 2),
            in_channels=cfg.get("in_channels", 3),
            out_channels=cfg.get("out_channels", 3),
            z_channels=cfg.get("z_channels", 4),
            emb_channels=cfg.get("emb_channels", 4),
        )
        self.model = AutoencoderModel(ae, NLayerDiscriminator(ae.in_channels))
        if generator is not None:
            init_weights_(self.model, generator)
        self.model.to(self.device).train()
        self.disc_start = int(cfg.get("disc_start", 50001))
        self.kl_weight = float(cfg.get("kl_weight", 1e-6))
        self.disc_weight = float(cfg.get("disc_weight", 0.5))
        self.adaptive = bool(cfg.get("adaptive_disc_weight", True))
        # the LPIPS term (reference contperceptual.py:28-29, weight 1.0), on only
        # where weights are given: nothing is downloaded
        self.perceptual_weight = float(cfg.get("perceptual_weight", 1.0))
        self.lpips = None
        if cfg.get("lpips_path"):
            self.lpips = LPIPS()
            self.lpips.load_state_dict(lpips_state_from_torch(reference_state(cfg.lpips_path)),
                                       strict=True)
            if self.bf16:
                cast_sampling_params(self.lpips)
            self.lpips.to(self.device).eval().requires_grad_(False)

    @property
    def ae(self) -> Autoencoder:
        """The autoencoder: its reference checkpoint (``convert.reference_state``)
        or ``convert.autoencoder_state_from_jax``'s dict loads strictly."""
        return self.model.ae

    def pad_channels(self, prmat2c: torch.Tensor) -> torch.Tensor:
        """(B, 2, H, W) -> (B, in_channels, H, W), zeros after the roll's
        channels (``model_autoencoder.py:18-24``)."""
        extra = self.ae.in_channels - prmat2c.shape[1]
        if extra <= 0:
            return prmat2c
        return torch.cat([prmat2c, prmat2c.new_zeros((prmat2c.shape[0], extra,
                                                      *prmat2c.shape[2:]))], dim=1)

    def draw_noise(self, batch, generator: torch.Generator, sched=None) -> AENoise:
        """The reparameterisation noise from ``generator`` on its device, at
        the global step of ``sched`` (the train step's; +inf without one)."""
        b, _, h, w = batch[0].shape
        f = 2 ** self.ae.n_down
        eps = torch.randn((b, self.ae.emb_channels, h // f, w // f), generator=generator,
                          device=generator.device)
        return AENoise(eps, (sched or {}).get("global_step", math.inf))

    def _frozen_disc(self, x: torch.Tensor) -> torch.Tensor:
        """The discriminator with its parameters detached: a gradient reaches
        ``x`` only."""
        disc = self.model.disc
        return functional_call(disc, {k: p.detach() for k, p in disc.named_parameters()}, (x,))

    def adaptive_weight(self, x: torch.Tensor, recon: torch.Tensor) -> torch.Tensor:
        """The generator's weight from the gradient norms of the NLL (without
        the LPIPS term) and of the generator loss at the decoder's last conv
        weight, through this forward's graph (JAX recomputes the same decode
        from the same z); detached, as JAX's ``stop_gradient``."""
        last = self.ae.decoder.conv_out.weight
        logvar = self.model.logvar.detach()
        nll = torch.sum(torch.abs(x - recon) / torch.exp(logvar) + logvar) / x.shape[0]
        g = -torch.mean(self._frozen_disc(recon))
        (nll_grad,) = torch.autograd.grad(nll, last, retain_graph=True)
        (g_grad,) = torch.autograd.grad(g, last, retain_graph=True)
        return adaptive_disc_weight(nll_grad, g_grad, self.disc_weight)

    def loss_fn(self, batch, noise: AENoise) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The generator's and the discriminator's losses, summed. Gradients
        stay on even under ``no_grad`` (validation): the adaptive weight is a
        gradient, and JAX's eval step computes it too."""
        step = noise.global_step
        with torch.enable_grad():
            x = self.pad_channels(decompress_batch(batch)[0].to(self.device, torch.float32))
            recon, moments = self.ae(x, noise.eps.to(self.device))
            recon = recon.float()
            disc_weight = self.adaptive_weight(x, recon) if self.adaptive else self.disc_weight
            p_loss = None
            if self.lpips is not None and self.perceptual_weight > 0:
                p_loss = self.lpips(x, recon).float()
            g_loss, g_metrics = ae_generator_loss(
                x, recon, moments, self._frozen_disc, step, logvar=self.model.logvar,
                disc_start=self.disc_start, kl_weight=self.kl_weight, disc_weight=disc_weight,
                p_loss=p_loss, perceptual_weight=self.perceptual_weight)
            if p_loss is not None:
                g_metrics["p_loss"] = p_loss.mean()
            d_loss, d_metrics = ae_discriminator_loss(x, recon, self.model.disc, step,
                                                      disc_start=self.disc_start)
            total = g_loss + d_loss
        return total, {"loss": total, **g_metrics, **d_metrics}
