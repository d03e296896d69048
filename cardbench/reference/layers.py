"""Convolutions and linear layers whose operands and results take the
reference's precision (``precision.py``), and the plain float32 norms and
attention the reference models share."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .precision import Precision

_FP32 = Precision("fp32")


class Linear(nn.Linear):
    prec = _FP32

    def forward(self, x):
        p = self.prec
        return p(F.linear(p(x), p(self.weight), self.bias))


class Conv2d(nn.Conv2d):
    prec = _FP32

    def forward(self, x):
        p = self.prec
        return p(self._conv_forward(p(x), p(self.weight), self.bias))


class ConvTranspose2d(nn.ConvTranspose2d):
    prec = _FP32

    def forward(self, x):
        p = self.prec
        return p(F.conv_transpose2d(p(x), p(self.weight), self.bias, self.stride, self.padding))


def set_precision(model: nn.Module, kind: str) -> nn.Module:
    """Every layer above in ``model`` rounds to ``kind``."""
    prec = Precision(kind)
    for m in model.modules():
        if isinstance(m, (Linear, Conv2d, ConvTranspose2d)):
            m.prec = prec
        if hasattr(m, "attn_prec"):
            m.attn_prec = prec
    return model


def group_norm(x: torch.Tensor, norm: nn.GroupNorm) -> torch.Tensor:
    """Two-pass float32 GroupNorm."""
    return F.group_norm(x.float(), norm.num_groups, norm.weight, norm.bias, norm.eps)


def attention(q, k, v, scale: float, prec: Precision) -> torch.Tensor:
    """(B, Tq, H, D) x (B, Tk, H, D) -> (B, Tq, H, D): float32 logits and
    softmax, products in ``prec``."""
    logits = torch.einsum("bihd,bjhd->bhij", prec(q), prec(k)) * scale
    w = prec(logits.float().softmax(dim=-1))
    return prec(torch.einsum("bhij,bjhd->bihd", w, prec(v)))
