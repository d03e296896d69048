"""The plain (unconditional) DDPM UNet, the reference's second model family
(counterpart of the JAX package's ``models/ddpm_unet.py``; reference
``ddpm/unet.py``): additive time-embedding residual blocks, single-head
self-attention blocks, transposed-conv upsampling. NCHW.

The module tree and parameter names are the reference ``UNet``'s
(``image_proj``, ``time_emb.lin1``, ``down.{k}.res.conv1``, ``down.{k}.attn.projection``,
``middle.res1``, ``up.{k}.conv``, ``norm``, ``final``), so a reference checkpoint
loads with a strict ``load_state_dict``. Reference quirks kept, as the JAX
package keeps them:

- the time embedding is sine-first with ``half_dim = n_channels // 8`` and
  the denominator ``half_dim - 1`` (``ddpm/unet.py:61-82``);
- ``AttentionBlock`` defines a GroupNorm that its forward never applies (so
  the state dict carries ``*.attn.norm.*``) and adds the residual before
  reshaping (``ddpm/unet.py:180-214``);
- the up path has ``n_blocks + 1`` blocks a level, the last of which narrows
  the channels (``ddpm/unet.py:385-398``);
- the final norm has 8 groups, every other one 32.

The compute dtype is the dtype of the weights (``utils/precision.py``); the
norms' statistics and the attention softmax run in fp32, and the output is
fp32. The attention is a plain product (one head as wide as the block, 256 or
1024 channels at the preset's widths): the JAX package computes it outside any
Pallas kernel too.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .unet import GroupNorm32


def ddpm_time_embedding(t: torch.Tensor, n_channels: int) -> torch.Tensor:
    """Sinusoidal embedding of width ``n_channels // 4``, sine first, with the
    denominator ``half_dim - 1`` (``ddpm/unet.py:61-75``). Always fp32."""
    half_dim = n_channels // 8
    emb = math.log(10000) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=t.device) * -emb)
    emb = t.float()[:, None] * emb[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)


class TimeEmbedding(nn.Module):
    def __init__(self, n_channels: int):
        super().__init__()
        self.n_channels = n_channels
        self.lin1 = nn.Linear(n_channels // 4, n_channels)
        self.lin2 = nn.Linear(n_channels, n_channels)

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        emb = ddpm_time_embedding(t, self.n_channels).to(self.lin1.weight.dtype)
        return self.lin2(F.silu(self.lin1(emb)))


def _conv3x3(c_in: int, c_out: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, stride=stride, padding=1)


class ResidualBlock(nn.Module):
    """norm -> swish -> conv, + time, norm -> swish -> conv, + shortcut (a 1x1
    conv only where the widths differ; ``ddpm/unet.py:85-144``)."""

    def __init__(self, in_channels: int, out_channels: int, time_channels: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = _conv3x3(in_channels, out_channels)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = _conv3x3(out_channels, out_channels)
        self.shortcut = (nn.Conv2d(in_channels, out_channels, 1) if in_channels != out_channels
                         else nn.Identity())
        self.time_emb = nn.Linear(time_channels, out_channels)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = h + self.time_emb(t_emb).to(h.dtype)[:, :, None, None]
        h = self.conv2(F.silu(self.norm2(h)))
        return h + self.shortcut(x)


class AttentionBlock(nn.Module):
    """One head as wide as the block (the preset's): a projection to q | k |
    v, fp32 logits and softmax, an output projection, + residual. No
    pre-norm: ``norm`` is kept for the reference's state dict only and never
    applied."""

    def __init__(self, n_channels: int):
        super().__init__()
        self.norm = nn.GroupNorm(32, n_channels)  # unused, as in the reference
        self.projection = nn.Linear(n_channels, n_channels * 3)
        self.output = nn.Linear(n_channels, n_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        seq = x.reshape(b, c, h * w).transpose(1, 2)  # (B, HW, C)
        q, k, v = self.projection(seq).chunk(3, dim=-1)
        attn = torch.einsum("bic,bjc->bij", q.float(), k.float()) * c**-0.5
        res = torch.einsum("bij,bjc->bic", attn.softmax(dim=2).to(v.dtype), v).to(seq.dtype)
        return (self.output(res) + seq).transpose(1, 2).reshape(b, c, h, w)


class DownBlock(nn.Module):
    """A residual block and, at an attention level, an attention block; the
    up path's blocks (the reference's ``UpBlock``) are the same two parts,
    handed the skip concat's width."""

    def __init__(self, in_channels: int, out_channels: int, time_channels: int, has_attn: bool):
        super().__init__()
        self.res = ResidualBlock(in_channels, out_channels, time_channels)
        self.attn = AttentionBlock(out_channels) if has_attn else nn.Identity()

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        return self.attn(self.res(x, t_emb))


class Downsample(nn.Module):
    def __init__(self, n_channels: int):
        super().__init__()
        self.conv = _conv3x3(n_channels, n_channels, stride=2)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        del t_emb  # the down path hands every module the time embedding
        return self.conv(x)


class Upsample(nn.Module):
    """ConvTranspose (4, 4), stride 2, padding 1 (``ddpm/unet.py:288-301``)."""

    def __init__(self, n_channels: int):
        super().__init__()
        self.conv = nn.ConvTranspose2d(n_channels, n_channels, 4, 2, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class DDPMUNet(nn.Module):
    """The unconditional UNet (``ddpm/unet.py:320-446``): ``x`` (B,
    image_channels, H, W), ``t`` (B,) -> eps (B, image_channels, H, W) in fp32."""

    def __init__(
        self,
        image_channels: int = 2,
        n_channels: int = 64,
        ch_mults: Sequence[int] = (1, 2, 2, 4),
        is_attn: Sequence[bool] = (False, False, False, True),
        n_blocks: int = 2,
    ):
        super().__init__()
        n_res = len(ch_mults)
        time_ch = n_channels * 4
        self.image_proj = _conv3x3(image_channels, n_channels)
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

        self.norm = GroupNorm32(n_channels, groups=8)
        self.final = _conv3x3(in_ch, image_channels)

    def forward(self, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        dtype = self.final.weight.dtype
        t_emb = self.time_emb(t)
        x = self.image_proj(x.to(dtype))
        skips = [x]
        for m in self.down:
            x = m(x, t_emb)
            skips.append(x)
        mid = self.middle
        x = mid.res2(mid.attn(mid.res1(x, t_emb)), t_emb)
        for m in self.up:
            if isinstance(m, Upsample):
                x = m(x)
            else:
                x = m(torch.cat([x, skips.pop()], dim=1), t_emb)
        return self.final(F.silu(self.norm(x))).float()
