"""The UNet of Stable Diffusion XL base 1.0, plain PyTorch in float32
(Stability-AI/generative-models, ``sgm/modules/diffusionmodules/openaimodel.py``
and ``sgm/modules/attention.py`` under ``configs/inference/sd_xl_base.yaml``;
``stabilityai/stable-diffusion-xl-base-1.0``, ``unet/config.json``; arXiv
2307.01952), and DDIM with classifier-free guidance over its two-part
condition. Parameter names are the sgm checkpoint's, so one state dict loads
strictly here and into the program.

The published model: 4 latent channels; widths 320 x [1, 2, 4], two
ResBlocks a level; no attention at level 0; transformer depth 2 at level 1,
10 at level 2 and 10 in the middle block; heads of 64 channels; proj_in and
proj_out Linear layers over the (B, HW, C) tokens; cross-attention over
(B, 77, 2048) text tokens; a ``label_emb`` MLP 2816 -> 1280 -> 1280 on the
vector condition y (the pooled text vector, 1280, and six size and crop ids,
256-wide sinusoids each), added to the time embedding; GroupNorm of 32 groups
at eps 1e-5 (1e-6 before a transformer), LayerNorm at eps 1e-5, GEGLU with
the exact GELU.

Departures of the program from this description, which the comparison
absorbs: its GroupNorm statistics are one-pass, in float32, with the affine
folded in float32 and applied in the activation type; its LayerNorms run in
float32 and round to the activation type; its self-attention on the card is
one kernel whose softmax P is rounded to bfloat16 before P V. It computes in
bfloat16 (norm scales float32), the configuration's precision.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from . import diffusion as ref_diffusion
from .layers import Conv2d, Linear, group_norm
from .sdf_unet import (
    BasicTransformerBlock,
    DownSample,
    ResBlock,
    UpSample,
    _norm,
    time_step_embedding,
)


class SpatialTransformer(nn.Module):
    """GroupNorm, then Linear proj_in on the (B, HW, C) tokens, the blocks,
    Linear proj_out, back to (B, C, H, W), plus the input."""

    def __init__(self, channels: int, n_heads: int, n_layers: int, d_cond: int):
        super().__init__()
        self.norm = _norm(channels, eps=1e-6)
        self.proj_in = Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, n_heads, channels // n_heads, d_cond)
            for _ in range(n_layers))
        self.proj_out = Linear(channels, channels)

    def forward(self, x, cond):
        b, c, h, w = x.shape
        x_in = x
        x = group_norm(x, self.norm).permute(0, 2, 3, 1).reshape(b, h * w, c)
        x = self.proj_in(x)
        for block in self.transformer_blocks:
            x = block(x, cond)
        x = self.proj_out(x).reshape(b, h, w, c).permute(0, 3, 1, 2)
        return x + x_in


class TimestepEmbedSequential(nn.Sequential):
    def forward(self, x, t_emb, cond):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, t_emb)
            elif isinstance(layer, SpatialTransformer):
                x = layer(x, cond)
            else:
                x = layer(x)
        return x


class UNetModel(nn.Module):
    """eps(x (B, C, H, W), t (B,), cond (B, n_ctx, d_cond), y (B, adm)) ->
    (B, C, H, W)."""

    def __init__(self, in_channels: int = 4, out_channels: int = 4, channels: int = 320,
                 n_res_blocks: int = 2, channel_multipliers: Sequence[int] = (1, 2, 4),
                 tf_layers: Sequence[int] = (0, 2, 10),
                 d_head: int = 64, d_cond: int = 2048, adm_in_channels: int = 2816):
        super().__init__()
        self.channels = channels
        levels = len(channel_multipliers)
        d_time_emb = channels * 4
        self.time_embed = nn.Sequential(Linear(channels, d_time_emb), nn.SiLU(),
                                        Linear(d_time_emb, d_time_emb))
        self.label_emb = nn.Sequential(nn.Sequential(Linear(adm_in_channels, d_time_emb),
                                                     nn.SiLU(), Linear(d_time_emb, d_time_emb)))

        def transformer(ch, depth):
            return SpatialTransformer(ch, ch // d_head, depth, d_cond)

        self.input_blocks = nn.ModuleList(
            [TimestepEmbedSequential(Conv2d(in_channels, channels, 3, padding=1))])
        skip_channels = [channels]
        widths = [channels * m for m in channel_multipliers]
        ch = channels
        for i in range(levels):
            for _ in range(n_res_blocks):
                layers = [ResBlock(ch, d_time_emb, widths[i])]
                ch = widths[i]
                if tf_layers[i]:
                    layers.append(transformer(ch, tf_layers[i]))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                skip_channels.append(ch)
            if i != levels - 1:
                self.input_blocks.append(TimestepEmbedSequential(DownSample(ch)))
                skip_channels.append(ch)
        self.middle_block = TimestepEmbedSequential(
            ResBlock(ch, d_time_emb), transformer(ch, tf_layers[-1]), ResBlock(ch, d_time_emb))
        self.output_blocks = nn.ModuleList()
        for i in reversed(range(levels)):
            for j in range(n_res_blocks + 1):
                layers = [ResBlock(ch + skip_channels.pop(), d_time_emb, widths[i])]
                ch = widths[i]
                if tf_layers[i]:
                    layers.append(transformer(ch, tf_layers[i]))
                if i != 0 and j == n_res_blocks:
                    layers.append(UpSample(ch))
                self.output_blocks.append(TimestepEmbedSequential(*layers))
        self.out = nn.Sequential(_norm(ch), nn.SiLU(), Conv2d(ch, out_channels, 3, padding=1))

    def forward(self, x, time_steps, cond, y):
        t_emb = self.time_embed(time_step_embedding(time_steps, self.channels))
        t_emb = t_emb + self.label_emb(y.float())
        h = x.float()
        skips = []
        for block in self.input_blocks:
            h = block(h, t_emb, cond)
            skips.append(h)
        h = self.middle_block(h, t_emb, cond)
        for block in self.output_blocks:
            h = block(torch.cat([h, skips.pop()], dim=1), t_emb, cond)
        norm, _, conv = self.out
        return conv(torch.nn.functional.silu(group_norm(h, norm)))


def build(cfg) -> UNetModel:
    """The UNet of an SDXL configuration (a dict of the config file)."""
    return UNetModel(in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
                     channels=cfg["channels"], n_res_blocks=cfg["n_res_blocks"],
                     channel_multipliers=tuple(cfg["channel_multipliers"]),
                     tf_layers=tuple(cfg["tf_layers"]),
                     d_head=cfg["d_head"], d_cond=cfg["d_cond"],
                     adm_in_channels=cfg["adm_in_channels"])


def vector_condition(cfg, pooled: torch.Tensor, size_ids: torch.Tensor) -> torch.Tensor:
    """y (B, adm): the pooled text vector, then each size or crop id as a
    ``size_embed_dim``-wide cos-first sinusoid (sgm's
    ``ConcatTimestepEmbedderND``, diffusers' ``add_time_ids``)."""
    b = pooled.shape[0]
    emb = time_step_embedding(size_ids.reshape(-1), cfg["size_embed_dim"]).reshape(b, -1)
    return torch.cat([pooled.float(), emb.to(pooled.device)], dim=1)


def unconditional(cfg, context: torch.Tensor, y: torch.Tensor):
    """The CFG unconditional pair of SDXL-base (``force_zeros_for_empty_prompt``):
    the text tokens and the pooled text vector zeros, the size and crop ids
    kept."""
    p = cfg["pooled_dim"]
    return torch.zeros_like(context), torch.cat([torch.zeros_like(y[:, :p]), y[:, p:]], dim=1)


@torch.no_grad()
def generate(unet, tab, cfg, context, y, noise, n_ddim: int, scale: float):
    """DDIM (eta 0) with CFG from ``noise`` (B, C, H, W) under the pair
    (context, y), as ``diffusion.generate`` does for one condition; each eps
    is e_u + s (e_c - e_u) with the unconditional pair of ``unconditional``."""
    steps, alpha, alpha_prev = ref_diffusion.ddim_tables(tab, n_ddim)
    last = len(steps) - 1
    x = float(np.sqrt(1.0 - alpha[last])) * noise
    u_ctx, u_y = unconditional(cfg, context, y)
    c_in, y_in = torch.cat([u_ctx, context]), torch.cat([u_y, y])
    for i in range(last, -1, -1):
        t = torch.full((x.shape[0],), int(steps[i]), dtype=torch.long, device=x.device)
        e = unet(torch.cat([x, x]), torch.cat([t, t]), c_in, y_in)
        e_u, e_c = e.float().chunk(2)
        e = e_u + scale * (e_c - e_u)
        pred_x0 = (x - float(np.sqrt(1.0 - alpha[i])) * e) / float(np.sqrt(alpha[i]))
        x = float(np.sqrt(alpha_prev[i])) * pred_x0 + float(np.sqrt(1.0 - alpha_prev[i])) * e
    return x
