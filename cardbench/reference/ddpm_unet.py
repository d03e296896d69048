"""The unconditional DDPM UNet of Polyffusion's baseline, plain PyTorch in
float32 (``ddpm/unet.py``, after labml's DDPM): residual blocks with an
additive time embedding, one-head self-attention blocks without a norm (the
module defines one and never applies it), transposed-conv upsampling, a final
norm of 8 groups. Parameter names are the published model's."""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d, ConvTranspose2d, Linear, attention, group_norm
from .precision import Precision


class TimeEmbedding(nn.Module):
    def __init__(self, n_channels: int):
        super().__init__()
        self.n_channels = n_channels
        self.lin1 = Linear(n_channels // 4, n_channels)
        self.lin2 = Linear(n_channels, n_channels)

    def forward(self, t):
        half_dim = self.n_channels // 8
        emb = math.log(10_000) / (half_dim - 1)
        emb = torch.exp(torch.arange(half_dim, device=t.device, dtype=torch.float32) * -emb)
        emb = t.float()[:, None] * emb[None, :]
        emb = torch.cat((emb.sin(), emb.cos()), dim=1)
        return self.lin2(F.silu(self.lin1(emb)))


class ResidualBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, time_channels: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(32, in_channels)
        self.conv1 = Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = nn.GroupNorm(32, out_channels)
        self.conv2 = Conv2d(out_channels, out_channels, 3, padding=1)
        self.shortcut = (Conv2d(in_channels, out_channels, 1) if in_channels != out_channels
                         else nn.Identity())
        self.time_emb = Linear(time_channels, out_channels)

    def forward(self, x, t):
        h = self.conv1(F.silu(group_norm(x, self.norm1)))
        h = h + self.time_emb(t)[:, :, None, None]
        h = self.conv2(F.silu(group_norm(h, self.norm2)))
        return h + self.shortcut(x)


class AttentionBlock(nn.Module):
    attn_prec = Precision("fp32")

    def __init__(self, n_channels: int):
        super().__init__()
        self.norm = nn.GroupNorm(32, n_channels)  # defined, never applied
        self.projection = Linear(n_channels, n_channels * 3)
        self.output = Linear(n_channels, n_channels)

    def forward(self, x):
        b, c, h, w = x.shape
        seq = x.view(b, c, -1).permute(0, 2, 1)
        q, k, v = self.projection(seq).view(b, -1, 1, 3 * c).chunk(3, dim=-1)
        res = attention(q, k, v, c ** -0.5, self.attn_prec).reshape(b, -1, c)
        res = self.output(res) + seq
        return res.permute(0, 2, 1).reshape(b, c, h, w)


class DownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, time_channels: int, has_attn: bool):
        super().__init__()
        self.res = ResidualBlock(in_channels, out_channels, time_channels)
        self.attn = AttentionBlock(out_channels) if has_attn else nn.Identity()

    def forward(self, x, t):
        return self.attn(self.res(x, t))


class Downsample(nn.Module):
    def __init__(self, n_channels: int):
        super().__init__()
        self.conv = Conv2d(n_channels, n_channels, 3, stride=2, padding=1)

    def forward(self, x, t):
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, n_channels: int):
        super().__init__()
        self.conv = ConvTranspose2d(n_channels, n_channels, 4, 2, 1)

    def forward(self, x):
        return self.conv(x)


class DDPMUNet(nn.Module):
    def __init__(self, image_channels: int = 2, n_channels: int = 64,
                 ch_mults: Sequence[int] = (1, 2, 2, 4),
                 is_attn: Sequence[bool] = (False, False, False, True), n_blocks: int = 2):
        super().__init__()
        n_res = len(ch_mults)
        time_ch = n_channels * 4
        self.image_proj = Conv2d(image_channels, n_channels, 3, padding=1)
        self.time_emb = TimeEmbedding(time_ch)
        down = []
        in_ch = out_ch = n_channels
        for i in range(n_res):
            out_ch = in_ch * ch_mults[i]
            for _ in range(n_blocks):
                down.append(DownBlock(in_ch, out_ch, time_ch, is_attn[i]))
                in_ch = out_ch
            if i < n_res - 1:
                down.append(Downsample(in_ch))
        self.down = nn.ModuleList(down)
        self.middle = nn.Module()
        self.middle.res1 = ResidualBlock(out_ch, out_ch, time_ch)
        self.middle.attn = AttentionBlock(out_ch)
        self.middle.res2 = ResidualBlock(out_ch, out_ch, time_ch)
        up = []
        in_ch = out_ch
        for i in reversed(range(n_res)):
            out_ch = in_ch
            for _ in range(n_blocks):
                up.append(DownBlock(in_ch + out_ch, out_ch, time_ch, is_attn[i]))
            out_ch = in_ch // ch_mults[i]
            up.append(DownBlock(in_ch + out_ch, out_ch, time_ch, is_attn[i]))
            in_ch = out_ch
            if i > 0:
                up.append(Upsample(in_ch))
        self.up = nn.ModuleList(up)
        self.norm = nn.GroupNorm(8, n_channels)
        self.final = Conv2d(in_ch, image_channels, 3, padding=1)

    def forward(self, x, t, cond=None):
        t = self.time_emb(t)
        x = self.image_proj(x.float())
        h = [x]
        for m in self.down:
            x = m(x, t)
            h.append(x)
        x = self.middle.res2(self.middle.attn(self.middle.res1(x, t)), t)
        for m in self.up:
            if isinstance(m, Upsample):
                x = m(x)
            else:
                x = m(torch.cat((x, h.pop()), dim=1), t)
        return self.final(F.silu(group_norm(x, self.norm)))


def build(cfg) -> DDPMUNet:
    return DDPMUNet(image_channels=cfg["image_channels"], n_channels=cfg["n_channels"],
                    ch_mults=tuple(cfg["channel_multipliers"]),
                    is_attn=tuple(cfg["is_attention"]))
