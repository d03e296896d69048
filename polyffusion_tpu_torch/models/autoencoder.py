"""The KL autoencoder (VQGAN-style), the reference's optional first-stage model
(counterpart of the JAX package's ``models/autoencoder.py``; reference
``stable_diffusion/model/autoencoder.py``). NCHW.

The module tree and parameter names are the reference's
(``encoder.down.{i}.block.{j}.norm1``, ``encoder.down.{i}.downsample.conv``,
``encoder.mid.block_1``, ``encoder.mid.attn_1.q``, ``encoder.norm_out``,
``decoder.up.{i}.upsample.conv``, ``quant_conv``, ``post_quant_conv``), so a
reference checkpoint loads strictly. The GroupNorms are the JAX package's
(32 groups, eps 1e-5, fp32 statistics; ``models/unet.py:GroupNorm32``). The
compute dtype is the dtype of the weights; the attention's logits and
softmax run in fp32. Randomness is an argument: the forward takes its
reparameterisation noise.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .unet import GroupNorm32


def _conv3x3(c_in: int, c_out: int) -> nn.Conv2d:
    return nn.Conv2d(c_in, c_out, 3, padding=1)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = GroupNorm32(in_channels)
        self.conv1 = _conv3x3(in_channels, out_channels)
        self.norm2 = GroupNorm32(out_channels)
        self.conv2 = _conv3x3(out_channels, out_channels)
        self.nin_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                             if in_channels != out_channels else nn.Identity())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return self.nin_shortcut(x) + h


class AttnBlock(nn.Module):
    """Single-head attention over the positions with 1x1-conv projections
    (``autoencoder.py:327-380``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.norm = GroupNorm32(channels)
        self.q = nn.Conv2d(channels, channels, 1)
        self.k = nn.Conv2d(channels, channels, 1)
        self.v = nn.Conv2d(channels, channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        xn = self.norm(x)
        q, k, v = (m(xn).reshape(b, c, h * w) for m in (self.q, self.k, self.v))
        attn = torch.einsum("bci,bcj->bij", q.float(), k.float()) * c**-0.5
        attn = attn.softmax(dim=2)
        out = torch.einsum("bij,bcj->bci", attn.to(v.dtype), v).to(x.dtype)
        return x + self.proj_out(out.reshape(b, c, h, w))


class DownSample(nn.Module):
    """Pad (0, 1) at the bottom and right, then a stride-2 conv without
    padding (``autoencoder.py:406-426``): not ``padding=1``."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class UpSample(nn.Module):
    """Nearest x2, then a conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = _conv3x3(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


def _mid(channels: int) -> nn.Module:
    mid = nn.Module()
    mid.block_1 = ResnetBlock(channels, channels)
    mid.attn_1 = AttnBlock(channels)
    mid.block_2 = ResnetBlock(channels, channels)
    return mid


def _run_mid(mid: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return mid.block_2(mid.attn_1(mid.block_1(x)))


class Encoder(nn.Module):
    def __init__(self, channels: int = 64, channel_multipliers: Sequence[int] = (1, 2, 4, 4),
                 n_resnet_blocks: int = 2, in_channels: int = 3, z_channels: int = 4):
        super().__init__()
        ch_list = [m * channels for m in [1] + list(channel_multipliers)]
        n_res = len(channel_multipliers)
        self.conv_in = _conv3x3(in_channels, channels)
        self.down = nn.ModuleList()
        ch = channels
        for i in range(n_res):
            level = nn.Module()
            blocks = []
            for _ in range(n_resnet_blocks):
                blocks.append(ResnetBlock(ch, ch_list[i + 1]))
                ch = ch_list[i + 1]
            level.block = nn.ModuleList(blocks)
            level.downsample = DownSample(ch) if i != n_res - 1 else nn.Identity()
            self.down.append(level)
        self.mid = _mid(ch)
        self.norm_out = GroupNorm32(ch)
        self.conv_out = _conv3x3(ch, 2 * z_channels)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(img.to(self.conv_in.weight.dtype))
        for level in self.down:
            for block in level.block:
                x = block(x)
            x = level.downsample(x)
        x = _run_mid(self.mid, x)
        return self.conv_out(F.silu(self.norm_out(x)))


class Decoder(nn.Module):
    def __init__(self, channels: int = 64, channel_multipliers: Sequence[int] = (1, 2, 4, 4),
                 n_resnet_blocks: int = 2, out_channels: int = 3, z_channels: int = 4):
        super().__init__()
        ch_list = [m * channels for m in channel_multipliers]
        ch = ch_list[-1]
        self.conv_in = _conv3x3(z_channels, ch)
        self.mid = _mid(ch)
        levels = []
        for i in reversed(range(len(channel_multipliers))):
            level = nn.Module()
            blocks = []
            for _ in range(n_resnet_blocks + 1):
                blocks.append(ResnetBlock(ch, ch_list[i]))
                ch = ch_list[i]
            level.block = nn.ModuleList(blocks)
            level.upsample = UpSample(ch) if i != 0 else nn.Identity()
            levels.insert(0, level)
        self.up = nn.ModuleList(levels)  # up[i] is level i, run from the last
        self.norm_out = GroupNorm32(ch)
        self.conv_out = _conv3x3(ch, out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.conv_in(z.to(self.conv_in.weight.dtype))
        x = _run_mid(self.mid, x)
        for level in reversed(self.up):
            for block in level.block:
                x = block(x)
            x = level.upsample(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class Autoencoder(nn.Module):
    """The KL autoencoder with its quant convs (``autoencoder.py:27-109``)."""

    def __init__(self, channels: int = 64, channel_multipliers: Sequence[int] = (1, 2, 4, 4),
                 n_resnet_blocks: int = 2, in_channels: int = 3, out_channels: int = 3,
                 z_channels: int = 4, emb_channels: int = 4):
        super().__init__()
        self.in_channels = in_channels
        self.emb_channels = emb_channels
        self.n_down = len(channel_multipliers) - 1
        self.encoder = Encoder(channels, channel_multipliers, n_resnet_blocks, in_channels,
                               z_channels)
        self.decoder = Decoder(channels, channel_multipliers, n_resnet_blocks, out_channels,
                               z_channels)
        self.quant_conv = nn.Conv2d(2 * z_channels, 2 * emb_channels, 1)
        self.post_quant_conv = nn.Conv2d(emb_channels, z_channels, 1)

    def encode_moments(self, img: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, log_var), each (B, emb_channels, H / 2^n, W / 2^n); log_var
        clipped to [-30, 20]."""
        mean, log_var = self.quant_conv(self.encoder(img)).chunk(2, dim=1)
        return mean, log_var.clamp(-30.0, 20.0)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.post_quant_conv(z.to(self.post_quant_conv.weight.dtype)))

    def forward(self, img: torch.Tensor, eps: torch.Tensor):
        """-> (reconstruction, (mean, log_var)), decoded from z = mean + std
        eps for the given noise ``eps``, the moments' shape."""
        mean, log_var = self.encode_moments(img)
        return self.decode(gaussian_sample(mean, log_var, eps)), (mean, log_var)


def gaussian_sample(mean: torch.Tensor, log_var: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    return mean + torch.exp(0.5 * log_var) * eps.to(mean.dtype)
