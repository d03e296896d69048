"""Sampling with the UNet of Stable Diffusion XL base (``params/sdxl_base.yaml``):
a condition given as embeddings, the output of text encoders that run once a
request outside this package.

The condition is the pair (context, y): the text tokens (B, n_ctx, d_cond)
that every cross-attention reads, and the vector y (B, adm_in_channels) that
the UNet's ``label_emb`` adds to the time embedding, made by ``encode_cond``
from the pooled text vector and the six size and crop ids (original size,
crop top-left, target size), each a ``size_embed_dim``-wide cos-first
sinusoid (sgm's ``ConcatTimestepEmbedderND``). The CFG unconditional pair is
SDXL-base's ``force_zeros_for_empty_prompt``: the text tokens and the pooled
vector zeros, the size and crop ids kept. Images are latents (B, 4, H, W),
returned as the sampler leaves them.

The UNet is built on the meta device and materialised where it runs,
uninitialised, in the types it samples in (bf16 weights, fp32 norms, for a
``bf16`` preset); ``load_unet_state`` then fills it. No weight is drawn or
held on the CPU. There is no training here: the task has no loss.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..diffusion.schedule import make_schedule
from ..models.unet import UNetModel, timestep_embedding
from ..utils.precision import cast_sampling_params

Condition = Tuple[torch.Tensor, torch.Tensor]


def make_unet(cfg) -> UNetModel:
    """A new UNet of an SDXL config (on the current default device)."""
    return UNetModel(
        in_channels=cfg.in_channels,
        out_channels=cfg.out_channels,
        channels=cfg.channels,
        n_res_blocks=cfg.n_res_blocks,
        attention_levels=tuple(cfg.attention_levels),
        channel_multipliers=tuple(cfg.channel_multipliers),
        tf_layers=tuple(cfg.tf_layers),
        d_cond=cfg.d_cond,
        d_head=cfg.d_head,
        linear_proj=cfg.linear_proj,
        adm_in_channels=cfg.adm_in_channels,
        ln_eps=cfg.ln_eps,
        gelu=cfg.gelu,
    )


class SDXLTask:
    """The sampling side of a task (what ``InferenceSession`` reads) for an
    SDXL config; ``state_dict``: the UNet's fp32 weights in the published
    names, loaded strictly (else call ``load_unet_state`` before sampling)."""

    concat_blurry = False

    def __init__(self, cfg, state_dict=None, *, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.bf16 = bool(cfg.get("bf16", False))
        self.schedule = make_schedule(cfg.n_steps, cfg.linear_start, cfg.linear_end)
        with torch.device("meta"):
            unet = make_unet(cfg)
        if self.bf16:
            cast_sampling_params(unet)
        self.unet = unet.to_empty(device=self.device).eval().requires_grad_(False)
        if state_dict is not None:
            self.load_unet_state(state_dict)

    @torch.no_grad()
    def load_unet_state(self, state_dict) -> None:
        """Strictly load UNet weights; each is rounded to its parameter's type."""
        self.unet.load_state_dict(state_dict, strict=True)

    def encode_cond(self, context, pooled, size_ids) -> Condition:
        """(context (B, n_ctx, d_cond), pooled (B, pooled_dim), size ids (B, 6))
        -> (context, y) on the device, fp32."""
        context = torch.as_tensor(context, dtype=torch.float32).to(self.device)
        pooled = torch.as_tensor(pooled, dtype=torch.float32).to(self.device)
        ids = torch.as_tensor(size_ids).to(self.device)
        emb = timestep_embedding(ids.reshape(-1), self.cfg.size_embed_dim)
        return context, torch.cat([pooled, emb.reshape(pooled.shape[0], -1)], dim=1)

    def uncond_condition(self, cond: Condition) -> Condition:
        """The CFG unconditional pair: zeros for the text tokens and the pooled
        text part of y, y's size and crop part as given."""
        context, y = cond
        p = self.cfg.pooled_dim
        return torch.zeros_like(context), torch.cat([torch.zeros_like(y[:, :p]), y[:, p:]], 1)

    def apply_eps(self, x: torch.Tensor, t: torch.Tensor, cond: Condition) -> torch.Tensor:
        """eps prediction on NCHW ``x`` (fp32 out) under the pair (context, y)."""
        context, y = cond
        return self.unet(x, t, context, y=y)
