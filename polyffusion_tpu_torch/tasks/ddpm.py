"""The unconditional DDPM task (counterpart of the JAX package's
``tasks/ddpm.py``; reference ``models/model_ddpm.py`` + ``ddpm/__init__.py``):
the plain UNet's eps prediction under the linear beta schedule (1e-4 ->
0.02), trained by the eps-MSE loss on ``q_sample``."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..data.loader import decompress_batch
from ..device import DeviceLike, resolve_device
from ..diffusion.gaussian import diffusion_loss, draw_t_noise
from ..diffusion.schedule import NoiseSchedule, make_schedule
from ..models.ddpm_unet import DDPMUNet
from ..models.unet import init_weights_
from ..utils.precision import cast_sampling_params


class DDPMNoise(NamedTuple):
    """One loss evaluation's randomness: per-sample timesteps t (B,) in [0,
    T) and the noise eps, the image's shape."""

    t: torch.Tensor
    noise: torch.Tensor


class DDPMTask:
    name = "ddpm"
    used_batch_fields = frozenset({"prmat2c"})

    def __init__(self, cfg, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None, training: bool = False):
        """``generator``: a CPU generator from which the weights are drawn;
        without it they keep torch's default init. As ``SDFTask``: fp32
        weights, cast for sampling where the config says ``bf16`` unless
        ``training`` (then they stay fp32, the trainer's masters). The UNet
        has JAX's two blocks a level (its ``DDPMTask`` reads no ``n_blocks``)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.training = training
        self.bf16 = bool(cfg.get("bf16", False))
        self.unet = DDPMUNet(
            image_channels=cfg.get("image_channels", 2),
            n_channels=cfg.get("n_channels", 64),
            ch_mults=tuple(cfg.get("channel_multipliers", (1, 2, 2, 4))),
            is_attn=tuple(cfg.get("is_attention", (False, False, False, True))),
        )
        if generator is not None:
            init_weights_(self.unet, generator)
        # beta = linspace(1e-4, 0.02) (ddpm/__init__.py:25)
        self.schedule = make_schedule(cfg.get("n_steps", 1000), 1e-4, 0.02, kind="linear")
        self._schedule_dev = NoiseSchedule(
            *(torch.from_numpy(a).to(self.device) for a in self.schedule))
        self._place()

    def _place(self) -> None:
        if self.bf16 and not self.training:
            cast_sampling_params(self.unet)
        self.unet.to(self.device).train(self.training)

    def load_unet_state(self, state_dict) -> None:
        """Strictly load fp32 UNet weights (``convert.ddpm_unet_state_from_jax``,
        a reference checkpoint, a run directory's parameters)."""
        self.unet.float()
        self.unet.load_state_dict(state_dict, strict=True)
        self._place()

    @property
    def model(self) -> DDPMUNet:
        return self.unet

    def draw_noise(self, batch, generator: torch.Generator, sched=None) -> DDPMNoise:
        """t, then the noise, from ``generator`` on its device (``sched``
        steers nothing here)."""
        return DDPMNoise(*draw_t_noise(self.schedule.n_steps, tuple(batch[0].shape), generator))

    def loss_fn(self, batch, noise: DDPMNoise) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        x0 = decompress_batch(batch)[0].to(self.device, torch.float32)
        loss = diffusion_loss(self.apply_eps, self._schedule_dev, x0, None,
                              noise.t.to(self.device), noise.noise.to(self.device))
        return loss, {"loss": loss}

    def apply_eps(self, x: torch.Tensor, t: torch.Tensor, cond=None) -> torch.Tensor:
        """eps on NCHW ``x`` (fp32 out); ``cond`` is ignored, as JAX's."""
        del cond
        return self.unet(x, t)
