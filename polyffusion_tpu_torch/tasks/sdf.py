"""The Polyffusion-SDF task, chord condition only (counterpart of
``polyffusion_tpu/tasks/sdf.py``): the condition is the mean of a frozen chord
VAE (or the raw one-hot), with classifier-free-guidance dropout to -1s, and the
loss is the eps-MSE diffusion loss."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..data.loader import decompress_batch
from ..device import DeviceLike, resolve_device
from ..diffusion.gaussian import diffusion_loss, draw_t_noise
from ..diffusion.schedule import NoiseSchedule, make_schedule
from ..models.encoders import ChordEncoder
from ..models.unet import UNetModel, init_weights_
from ..utils.precision import cast_sampling_params

CFG_DROP = 0.2  # the reference's random.random() < 0.2, one coin per batch


class StepNoise(NamedTuple):
    """The randomness of one loss evaluation: per-sample timesteps, the
    noise, and the batch's CFG-dropout coin (a 0-d bool tensor)."""

    t: torch.Tensor
    noise: torch.Tensor
    drop: torch.Tensor


class SDFTask:
    def __init__(
        self,
        cfg,
        chord_enc: Optional[ChordEncoder] = None,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
        training: bool = False,
        gn_conv: str = "unfused",
    ):
        """``generator``: a CPU generator from which the UNet's weights are
        drawn; without it they keep torch's default init. ``chord_enc`` keeps
        the weights it comes with (it is frozen: pretrained, or random made by
        the caller).
        Weights are made in fp32 and, for a ``bf16`` preset, cast for sampling
        (``utils/precision.py``) after any ``load_unet_state``, unless
        ``training``: then they stay fp32, the trainer's master weights.
        ``gn_conv``: the UNet's GroupNorm-SiLU-conv route ("unfused", "fused",
        or for sampling "int8", whose int8 weights are made whenever the
        weights are placed)."""
        self.device = resolve_device(device)
        self.training = training
        self.cfg = cfg
        self.cond_type = cfg.get("cond_type", "chord")
        if self.cond_type != "chord":
            raise NotImplementedError(f"cond_type {self.cond_type!r}: the port has chord only")
        self.cond_mode = cfg.get("cond_mode", "cond")
        self.use_enc = bool(cfg.get("use_enc", False))
        if self.use_enc and chord_enc is None:
            raise ValueError("use_enc needs a chord encoder")
        if training and gn_conv == "int8":
            raise ValueError("gn_conv='int8' is sampling-only (no gradient): train with "
                             "'unfused' or 'fused'")
        self.unet = UNetModel(
            in_channels=cfg.in_channels,
            out_channels=cfg.out_channels,
            channels=cfg.channels,
            n_res_blocks=cfg.n_res_blocks,
            attention_levels=tuple(cfg.attention_levels),
            channel_multipliers=tuple(cfg.channel_multipliers),
            n_heads=cfg.n_heads,
            tf_layers=cfg.tf_layers,
            d_cond=cfg.d_cond,
            gn_conv=gn_conv,
        )
        self.chord_enc = chord_enc
        if generator is not None:
            init_weights_(self.unet, generator)
        self.schedule = make_schedule(cfg.n_steps, cfg.linear_start, cfg.linear_end)
        # the tables the loss indexes, on the device once
        self._schedule_dev = NoiseSchedule(
            *(torch.from_numpy(a).to(self.device) for a in self.schedule)
        )
        self._place()

    def _place(self) -> None:
        if self.cfg.get("bf16", False) and not self.training:
            cast_sampling_params(self.unet)
        self.unet.to(self.device).train(self.training)
        self.unet.prepare_gn_conv()
        if self.chord_enc is not None:
            self.chord_enc.to(self.device).eval().requires_grad_(False)

    def load_unet_state(self, state_dict) -> None:
        """Strictly load fp32 UNet weights (e.g. from ``convert.unet_state_from_jax``)."""
        self.unet.float()
        self.unet.load_state_dict(state_dict, strict=True)
        self._place()

    # -- conditioning ---------------------------------------------------------

    @torch.no_grad()
    def encode_chord(self, chord: torch.Tensor) -> torch.Tensor:
        """(B, 32, 36) one-hot -> (B, 1, d). The encoder is frozen; no_grad
        (not inference_mode) keeps the result usable in a training graph."""
        chord = chord.to(self.device, torch.float32)
        if self.use_enc:
            mean, _ = self.chord_enc(chord)
            return mean[:, None, :]
        return chord.reshape(chord.shape[0], 1, -1)

    def encode_cond(
        self,
        batch,
        generator: Optional[torch.Generator] = None,
        drop: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Condition + CFG dropout per ``cond_mode``. ``batch`` is (prmat2c,
        pnotree, chord, prmat). In the mix modes the condition becomes -1s where
        ``drop`` (a 0-d bool tensor) is true, or, without ``drop``, with
        probability 0.2 from ``generator``; with neither there is no dropout.
        The choice is made on the device: it never waits for the card."""
        cond = self.encode_chord(batch[2])
        if self.cond_mode == "uncond":
            return -torch.ones_like(cond)
        if self.cond_mode in ("mix", "mix2"):
            if drop is None and generator is not None:
                drop = self.draw_drop(generator)
            if drop is not None:
                return torch.where(drop.to(cond.device), -torch.ones_like(cond), cond)
        return cond

    @staticmethod
    def draw_drop(generator: torch.Generator) -> torch.Tensor:
        return torch.rand((), generator=generator, device=generator.device) < CFG_DROP

    # -- training ---------------------------------------------------------------

    @property
    def used_batch_fields(self):
        """Batch fields the loss reads: the feeder sends placeholders for the
        rest (``data/loader.py:DeviceFeeder``)."""
        return {"prmat2c", "chord"}

    def draw_noise(self, batch, generator: torch.Generator) -> StepNoise:
        """The CFG coin, then t and the noise, from ``generator`` on the device."""
        drop = self.draw_drop(generator)
        t, noise = draw_t_noise(self.schedule.n_steps, tuple(batch[0].shape), generator)
        return StepNoise(t, noise, drop)

    def loss_fn(self, batch, noise: StepNoise) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """eps-MSE loss of a (possibly compressed) batch for the given t, noise
        and coin; the UNet runs in the dtype of its weights."""
        batch = decompress_batch(batch)
        cond = self.encode_cond(batch, drop=noise.drop)
        x0 = batch[0].to(self.device, torch.float32)
        loss = diffusion_loss(self.apply_eps, self._schedule_dev, x0, cond, noise.t, noise.noise)
        return loss, {"loss": loss}

    # -- the net ----------------------------------------------------------------

    def apply_eps(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """eps prediction on NCHW ``x`` (fp32 out)."""
        return self.unet(x, t, cond)
