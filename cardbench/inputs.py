"""Everything a run feeds both sides, drawn from ``--seed``: the weights, the
chord progressions, the piano rolls and the noise. The same seed gives the
same inputs; nothing here reads the program's state."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
from torch import nn

# chord qualities as pitch-class sets over the root
QUALITIES = ((0, 4, 7), (0, 3, 7), (0, 4, 7, 10), (0, 4, 7, 11), (0, 3, 7, 10), (0, 3, 6),
             (0, 5, 7))


def mix(seed: int, *parts: int) -> int:
    """A 63-bit seed for one use of ``seed`` (a request, a step, the weights)."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), *[int(p) for p in parts]])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def rng(seed: int, *parts: int) -> np.random.Generator:
    return np.random.default_rng(mix(seed, *parts))


def device_generator(device, seed: int, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(mix(seed, *parts))


@torch.no_grad()
def weights(model: nn.Module, seed: int, device) -> Dict[str, torch.Tensor]:
    """A float32 state dict of ``model`` (any device, meta too) drawn on
    ``device`` in one call: each Linear or convolution weight and bias
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (torch's default bounds, fan_in the size
    of ``weight[0]``), a GRU's U(-1/sqrt(hidden), 1/sqrt(hidden)), norms'
    scales 1 and shifts 0."""
    bounds = {}
    for prefix, m in model.named_modules():
        pre = f"{prefix}." if prefix else ""
        if isinstance(m, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
            b = 1.0 / math.sqrt(m.weight[0].numel())
            for name, _ in m.named_parameters(recurse=False):
                bounds[pre + name] = b
        elif isinstance(m, nn.GRU):
            for name, _ in m.named_parameters(recurse=False):
                bounds[pre + name] = 1.0 / math.sqrt(m.hidden_size)
    params = dict(model.named_parameters())
    total = sum(params[n].numel() for n in bounds)
    flat = torch.rand(total, generator=device_generator(device, seed, 0), device=device)
    out, off = {}, 0
    for name, p in params.items():
        if name in bounds:
            out[name] = ((flat[off:off + p.numel()] * 2 - 1) * bounds[name]).view(p.shape)
            off += p.numel()
        elif name.endswith("weight"):
            out[name] = torch.ones(p.shape, device=device)
        else:
            out[name] = torch.zeros(p.shape, device=device)
    return out


def chords(seed: int, index: int, n: int, n_beats: int = 32) -> np.ndarray:
    """(n, n_beats, 36) chord one-hots (root, chroma, bass), one progression
    a row: a chord every 2 or 4 beats, random roots and qualities, the bass on
    the root or an inversion."""
    g = rng(seed, 1, index)
    out = np.zeros((n, n_beats, 36), np.float32)
    for row in range(n):
        beat = 0
        while beat < n_beats:
            span = int(g.choice((2, 4)))
            root = int(g.integers(12))
            pcs = QUALITIES[int(g.integers(len(QUALITIES)))]
            bass = pcs[int(g.integers(len(pcs)))] if g.random() < 0.2 else 0
            sl = slice(beat, min(beat + span, n_beats))
            out[row, sl, root] = 1
            for pc in pcs:
                out[row, sl, 12 + (root + pc) % 12] = 1
            out[row, sl, 24 + bass] = 1
            beat += span
    return out


def rolls(seed: int, index: int, n: int, steps: int = 128, pitches: int = 128) -> np.ndarray:
    """(n, 2, steps, pitches) 0/1 piano rolls (onset, sustain) in the piano's
    range: onsets at a density of about 3 notes a beat, durations 1-8 steps."""
    g = rng(seed, 2, index)
    onset = np.zeros((n, steps, pitches), bool)
    lo, hi = (21, 109) if pitches >= 109 else (0, pitches)  # a small test roll: every pitch
    onset[:, :, lo:hi] = g.random((n, steps, hi - lo)) < 0.0085
    dur = g.integers(1, 9, size=onset.shape)
    sustain = np.zeros_like(onset)
    for k in range(1, 8):
        sustain[:, k:] |= (onset & (dur > k))[:, :-k]
    sustain &= ~onset
    return np.stack([onset, sustain], axis=1).astype(np.float32)
