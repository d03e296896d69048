"""Space-to-depth (1 x 2 along W) convolutions for the UNet's level 0
(counterpart of ``polyffusion_tpu/ops/s2d.py``), over NCHW activations and
(O, I, kh, kw) weights.

W's parity is folded into the channels: ``X'[b, s*C + c, h, j] = x[b, c, h,
2j + s]``, a (B, 2C, H, W/2) tensor (JAX's NHWC channel order, so the two
compare after a transpose). Every conv then runs as an exact conv over the
folded layout with a structured kernel made from the same weights:

    y = conv3x3(x, W)  <=>  s2d(y) = conv3x3(s2d(x), W')
    W'[t*O + o, s*C + c, kh, bw + 1] = W[o, c, kh, dw + 1],  dw = 2 bw + s - t,
                                                           zero where |dw| > 1.

Half of W' is zero, so a folded conv does twice the multiply-adds of the
plain one; on the TPU it fills 128-lane tiles at C = 64. The entry kernel
takes the plain input to a folded output (stride 2 along W), the exit kernel a
folded input to the plain stride-2 output (the DownSample).

In NHWC ``to_s2d`` is a reshape; in NCHW it is a copy. The kernel maps are
gathers from the weights by fixed index maps (cached per device; the weights
never are), so gradients reach the plain weights through autograd.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def to_s2d(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, 2C, H, W/2): channel ``s*C + c`` at column j is
    channel c at column 2j + s."""
    b, c, h, w = x.shape
    if w % 2:
        raise ValueError(f"to_s2d folds the width in pairs, got width {w}")
    return x.view(b, c, h, w // 2, 2).permute(0, 4, 1, 2, 3).reshape(b, 2 * c, h, w // 2)


def from_s2d(x: torch.Tensor) -> torch.Tensor:
    """(B, 2C, H, J) -> (B, C, H, 2J); the inverse of ``to_s2d``."""
    b, c2, h, j = x.shape
    if c2 % 2:
        raise ValueError(f"from_s2d needs an even channel count, got {c2}")
    return x.view(b, 2, c2 // 2, h, j).permute(0, 2, 3, 4, 1).reshape(b, c2 // 2, h, 2 * j)


def fold_channel_vec(v: torch.Tensor) -> torch.Tensor:
    """A per-channel vector (..., C) -> its folded twin (..., 2C): folded
    channel ``s*C + c`` is channel c, so the vector is tiled twice."""
    return v.repeat(*([1] * (v.dim() - 1)), 2)


def unfold_channel_sums(s: torch.Tensor) -> torch.Tensor:
    """Per-folded-channel sums (..., 2C) -> per-channel sums (..., C): both
    parities of a channel add to its statistic."""
    c = s.shape[-1] // 2
    return s[..., :c] + s[..., c:]


def _kernel_taps(kind: str, kw: int) -> np.ndarray:
    """The plain kernel's column tap behind each folded kernel element (``kw``
    where the element is zero), indexed as the ``_gather`` of ``kind`` reads
    it: "s2d" (t, s, bw), "entry" (t, e), "exit" (s, bw)."""
    if kind == "s2d":
        lo, kw2 = -(kw // 2), (kw if kw == 3 else 1)
        taps = np.full((2, 2, kw2), kw, np.int64)
        for t in range(2):
            for s in range(2):
                for bw in range(kw2):
                    dw = 2 * (bw + lo) + s - t
                    if lo <= dw <= kw // 2:
                        taps[t, s, bw] = dw - lo
        return taps
    if kind == "entry":  # input column 2j + e, e in -1 .. 2, for output parity t
        taps = np.full((2, 4), kw, np.int64)
        for t in range(2):
            for e in range(-1, 3):
                if -1 <= e - t <= 1:
                    taps[t, e + 1] = e - t + 1
        return taps
    taps = np.full((2, 2), kw, np.int64)  # exit: block j - 1 + bw, parity s
    for s in range(2):
        for bw in range(-1, 1):
            if -1 <= 2 * bw + s <= 1:
                taps[s, bw + 1] = 2 * bw + s + 1
    return taps


@functools.lru_cache(maxsize=None)
def _taps_on(kind: str, kw: int, device: torch.device) -> torch.Tensor:
    # a normal tensor even when first made under inference_mode: the cached
    # map serves later autograd calls too
    with torch.inference_mode(False):
        return torch.from_numpy(_kernel_taps(kind, kw)).to(device)


def _gather(w: torch.Tensor, kind: str) -> torch.Tensor:
    """(O, I, kh, kw, *taps' shape): w's column taps by the fixed map, a zero
    column where the folded element is zero."""
    return F.pad(w, (0, 1))[:, :, :, _taps_on(kind, w.shape[3], w.device)]


def s2d_kernel(w: torch.Tensor) -> torch.Tensor:
    """(O, I, kh, kw) stride-1 "same" kernel, kw 1 or 3 -> (2O, 2I, kh, kw)
    folded kernel (block diagonal for a 1 x 1)."""
    o, i, kh, kw = w.shape
    if kw not in (1, 3):
        raise ValueError(f"s2d_kernel takes 1- or 3-wide kernels, got {kw}")
    g = _gather(w, "s2d")  # (O, I, kh, t, s, bw)
    return g.permute(3, 0, 4, 1, 2, 5).reshape(2 * o, 2 * i, kh, g.shape[-1])


def s2d_entry_kernel(w: torch.Tensor) -> torch.Tensor:
    """(O, I, kh, 3) -> (2O, I, kh, 4): plain input, folded output. Use with
    stride (1, 2) and padding (kh // 2, 1): output block j covers columns 2j
    and 2j + 1 and reads columns 2j - 1 .. 2j + 2."""
    o, i, kh, kw = w.shape
    if kw != 3:
        raise ValueError(f"s2d_entry_kernel takes 3-wide kernels, got {kw}")
    return _gather(w, "entry").permute(3, 0, 1, 2, 4).reshape(2 * o, i, kh, 4)


def s2d_exit_stride2_kernel(w: torch.Tensor) -> torch.Tensor:
    """(O, I, kh, 3) -> (O, 2I, kh, 2): folded input, the plain stride-(2, 2)
    output (the DownSample). Use with stride (2, 1) over (H, blocks) after
    padding H by kh // 2 on both sides and the blocks by one on the left:
    output column j reads columns 2j - 1 .. 2j + 1, blocks j - 1 (parity 1)
    and j (both)."""
    o, i, kh, kw = w.shape
    if kw != 3:
        raise ValueError(f"s2d_exit_stride2_kernel takes 3-wide kernels, got {kw}")
    return _gather(w, "exit").permute(0, 3, 1, 2, 4).reshape(o, 2 * i, kh, 2)


def upsample2x_s2d(x_s2d: torch.Tensor) -> torch.Tensor:
    """The 2x nearest upsample of a folded tensor, folded: (B, 2C, H, J),
    folded from (B, C, H, 2J) -> (B, 2C, 2H, 2J), folded from (B, C, 2H, 4J).
    Output block m holds column m of the input at both parities, so the
    upsample along W is the unfolded tensor tiled over the parities; along H a
    plain repeat."""
    x = from_s2d(x_s2d)
    b, c, h, w = x.shape
    return x[:, None, :, :, None, :].expand(b, 2, c, h, 2, w).reshape(b, 2 * c, 2 * h, w)


def np_reference_s2d_roundtrip(x: np.ndarray) -> np.ndarray:
    """Host-side check: ``to_s2d`` then ``from_s2d`` in NumPy (NCHW), the
    identity."""
    b, c, h, w = x.shape
    folded = x.reshape(b, c, h, w // 2, 2).transpose(0, 4, 1, 2, 3).reshape(b, 2 * c, h, w // 2)
    return folded.reshape(b, 2, c, h, w // 2).transpose(0, 2, 3, 4, 1).reshape(b, c, h, w)
