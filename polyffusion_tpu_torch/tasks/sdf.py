"""The Polyffusion-SDF task, chord condition only (counterpart of
``polyffusion_tpu/tasks/sdf.py``): the condition is the mean of a frozen chord
VAE (or the raw one-hot), with classifier-free-guidance dropout to -1s."""

from __future__ import annotations

from typing import Optional

import torch

from ..device import DeviceLike, resolve_device
from ..diffusion.schedule import make_schedule
from ..models.encoders import ChordEncoder
from ..models.unet import UNetModel, init_weights_
from ..utils.precision import cast_sampling_params


class SDFTask:
    def __init__(
        self,
        cfg,
        chord_enc: Optional[ChordEncoder] = None,
        *,
        device: DeviceLike = None,
        generator: Optional[torch.Generator] = None,
    ):
        """``generator``: a CPU generator from which the UNet's (and the chord
        encoder's) weights are drawn; without it they keep torch's default init.
        Weights are made in fp32 and, for a ``bf16`` preset, cast for sampling
        (``utils/precision.py``) after any ``load_unet_state``."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.cond_type = cfg.get("cond_type", "chord")
        if self.cond_type != "chord":
            raise NotImplementedError(f"cond_type {self.cond_type!r}: the port has chord only")
        self.cond_mode = cfg.get("cond_mode", "cond")
        self.use_enc = bool(cfg.get("use_enc", False))
        if self.use_enc and chord_enc is None:
            raise ValueError("use_enc needs a chord encoder")
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
        )
        self.chord_enc = chord_enc
        if generator is not None:
            init_weights_(self.unet, generator)
            if chord_enc is not None:
                init_weights_(chord_enc, generator)
        self.schedule = make_schedule(cfg.n_steps, cfg.linear_start, cfg.linear_end)
        self._place()

    def _place(self) -> None:
        if self.cfg.get("bf16", False):
            cast_sampling_params(self.unet)
        self.unet.to(self.device).eval()
        if self.chord_enc is not None:
            self.chord_enc.to(self.device).eval()

    def load_unet_state(self, state_dict) -> None:
        """Strictly load fp32 UNet weights (e.g. from ``convert.unet_state_from_jax``)."""
        self.unet.float()
        self.unet.load_state_dict(state_dict, strict=True)
        self._place()

    # -- conditioning ---------------------------------------------------------

    @torch.inference_mode()
    def encode_chord(self, chord: torch.Tensor) -> torch.Tensor:
        """(B, 32, 36) one-hot -> (B, 1, d)."""
        chord = chord.to(self.device, torch.float32)
        if self.use_enc:
            mean, _ = self.chord_enc(chord)
            return mean[:, None, :]
        return chord.reshape(chord.shape[0], 1, -1)

    def encode_cond(self, batch, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Condition + CFG dropout per ``cond_mode``. ``batch`` is (prmat2c,
        pnotree, chord, prmat); ``generator=None`` disables the dropout (one coin
        for the whole batch, p = 0.2, as in the reference)."""
        cond = self.encode_chord(batch[2])
        if self.cond_mode == "uncond":
            return -torch.ones_like(cond)
        if self.cond_mode in ("mix", "mix2") and generator is not None:
            coin = torch.rand((), generator=generator, device=generator.device)
            if coin.item() < 0.2:
                return -torch.ones_like(cond)
        return cond

    # -- the net ----------------------------------------------------------------

    def apply_eps(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """eps prediction on NCHW ``x`` (fp32 out)."""
        return self.unet(x, t, cond)
