"""The Polyffusion conditional UNet, plain PyTorch in float32 (Polyffusion,
aik2mlj/polyffusion, ``stable_diffusion/model/unet.py`` and
``unet_attention.py``, after labml's Stable Diffusion). Parameter names are
the published model's, so one state dict loads strictly here and into the
program.

Departures of the program from this description, which the comparison
absorbs: its GeGLU uses the tanh approximation of GELU and its LayerNorms
epsilon 1e-6 (flax's), where the published model has the exact GELU and
torch's 1e-5; its GroupNorm statistics are one-pass.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, Linear, attention, group_norm
from .precision import Precision


def time_step_embedding(time_steps: torch.Tensor, channels: int, max_period: int = 10000):
    half = channels // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=time_steps.device) / half)
    args = time_steps.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _norm(channels: int, eps: float = 1e-5) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=eps)


class ResBlock(nn.Module):
    def __init__(self, channels: int, d_t_emb: int, out_channels: int = None):
        super().__init__()
        out = out_channels or channels
        self.in_layers = nn.Sequential(_norm(channels), nn.SiLU(),
                                       Conv2d(channels, out, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), Linear(d_t_emb, out))
        self.out_layers = nn.Sequential(_norm(out), nn.SiLU(), nn.Identity(),
                                        Conv2d(out, out, 3, padding=1))
        self.skip_connection = nn.Identity() if out == channels else Conv2d(channels, out, 1)

    def forward(self, x, t_emb):
        n0, _, c0 = self.in_layers
        h = c0(F.silu(group_norm(x, n0)))
        h = h + self.emb_layers(t_emb)[:, :, None, None]
        n1, _, _, c1 = self.out_layers
        return self.skip_connection(x) + c1(F.silu(group_norm(h, n1)))


class CrossAttention(nn.Module):
    attn_prec = Precision("fp32")

    def __init__(self, d_model: int, d_cond: int, n_heads: int, d_head: int):
        super().__init__()
        d_attn = n_heads * d_head
        self.n_heads, self.d_head = n_heads, d_head
        self.to_q = Linear(d_model, d_attn, bias=False)
        self.to_k = Linear(d_cond, d_attn, bias=False)
        self.to_v = Linear(d_cond, d_attn, bias=False)
        self.to_out = nn.Sequential(Linear(d_attn, d_model))

    def forward(self, x, cond=None):
        cond = x if cond is None else cond
        b, s, _ = x.shape
        q = self.to_q(x).view(b, s, self.n_heads, self.d_head)
        k = self.to_k(cond).view(b, cond.shape[1], self.n_heads, self.d_head)
        v = self.to_v(cond).view(b, cond.shape[1], self.n_heads, self.d_head)
        out = attention(q, k, v, self.d_head ** -0.5, self.attn_prec)
        return self.to_out(out.reshape(b, s, -1))


class GeGLU(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.proj = Linear(d_in, d_out * 2)

    def forward(self, x):
        val, gate = self.proj(x).chunk(2, dim=-1)
        return val * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, d_model: int):
        super().__init__()
        self.net = nn.Sequential(GeGLU(d_model, d_model * 4), nn.Identity(),
                                 Linear(d_model * 4, d_model))

    def forward(self, x):
        return self.net(x)


class BasicTransformerBlock(nn.Module):
    def __init__(self, d_model: int, n_heads: int, d_head: int, d_cond: int):
        super().__init__()
        self.attn1 = CrossAttention(d_model, d_model, n_heads, d_head)
        self.norm1 = nn.LayerNorm(d_model)
        self.attn2 = CrossAttention(d_model, d_cond, n_heads, d_head)
        self.norm2 = nn.LayerNorm(d_model)
        self.ff = FeedForward(d_model)
        self.norm3 = nn.LayerNorm(d_model)

    def forward(self, x, cond):
        x = self.attn1(self.norm1(x)) + x
        x = self.attn2(self.norm2(x), cond) + x
        return self.ff(self.norm3(x)) + x


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, n_heads: int, n_layers: int, d_cond: int):
        super().__init__()
        self.norm = _norm(channels, eps=1e-6)
        self.proj_in = Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(channels, n_heads, channels // n_heads, d_cond)
            for _ in range(n_layers))
        self.proj_out = Conv2d(channels, channels, 1)

    def forward(self, x, cond):
        b, c, h, w = x.shape
        x_in = x
        x = self.proj_in(group_norm(x, self.norm))
        x = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            x = block(x, cond)
        x = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        return self.proj_out(x) + x_in


class DownSample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.op = Conv2d(channels, channels, 3, stride=2, padding=1)

    def forward(self, x):
        return self.op(x)


class UpSample(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


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
    """eps(x (B, C, H, W), t (B,), cond (B, n_cond, d_cond)) -> (B, C, H, W)."""

    def __init__(self, in_channels: int = 2, out_channels: int = 2, channels: int = 64,
                 n_res_blocks: int = 2, attention_levels: Sequence[int] = (2, 3),
                 channel_multipliers: Sequence[int] = (1, 2, 4, 4), n_heads: int = 4,
                 tf_layers: int = 1, d_cond: int = 512):
        super().__init__()
        self.channels = channels
        levels = len(channel_multipliers)
        d_time_emb = channels * 4
        self.time_embed = nn.Sequential(Linear(channels, d_time_emb), nn.SiLU(),
                                        Linear(d_time_emb, d_time_emb))
        self.input_blocks = nn.ModuleList(
            [TimestepEmbedSequential(Conv2d(in_channels, channels, 3, padding=1))])
        skip_channels = [channels]
        widths = [channels * m for m in channel_multipliers]
        ch = channels
        for i in range(levels):
            for _ in range(n_res_blocks):
                layers = [ResBlock(ch, d_time_emb, widths[i])]
                ch = widths[i]
                if i in attention_levels:
                    layers.append(SpatialTransformer(ch, n_heads, tf_layers, d_cond))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                skip_channels.append(ch)
            if i != levels - 1:
                self.input_blocks.append(TimestepEmbedSequential(DownSample(ch)))
                skip_channels.append(ch)
        self.middle_block = TimestepEmbedSequential(
            ResBlock(ch, d_time_emb), SpatialTransformer(ch, n_heads, tf_layers, d_cond),
            ResBlock(ch, d_time_emb))
        self.output_blocks = nn.ModuleList()
        for i in reversed(range(levels)):
            for j in range(n_res_blocks + 1):
                layers = [ResBlock(ch + skip_channels.pop(), d_time_emb, widths[i])]
                ch = widths[i]
                if i in attention_levels:
                    layers.append(SpatialTransformer(ch, n_heads, tf_layers, d_cond))
                if i != 0 and j == n_res_blocks:
                    layers.append(UpSample(ch))
                self.output_blocks.append(TimestepEmbedSequential(*layers))
        self.out = nn.Sequential(_norm(ch), nn.SiLU(), Conv2d(ch, out_channels, 3, padding=1))

    def forward(self, x, time_steps, cond):
        t_emb = self.time_embed(time_step_embedding(time_steps, self.channels))
        h = x.float()
        skips = []
        for block in self.input_blocks:
            h = block(h, t_emb, cond)
            skips.append(h)
        h = self.middle_block(h, t_emb, cond)
        for block in self.output_blocks:
            h = block(torch.cat([h, skips.pop()], dim=1), t_emb, cond)
        norm, _, conv = self.out
        return conv(F.silu(group_norm(h, norm)))


def build(cfg) -> UNetModel:
    """The UNet of an ``sdf*`` configuration (a dict of the config file)."""
    return UNetModel(in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
                     channels=cfg["channels"], n_res_blocks=cfg["n_res_blocks"],
                     attention_levels=tuple(cfg["attention_levels"]),
                     channel_multipliers=tuple(cfg["channel_multipliers"]),
                     n_heads=cfg["n_heads"], tf_layers=cfg["tf_layers"], d_cond=cfg["d_cond"])
