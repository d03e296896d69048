"""Symbolic-music representations (pure NumPy, host-side): the part of the JAX
package's ``utils/reprs.py`` that the port needs, copied.

nmat
    Note matrix ``(N, 3)`` of ``(onset, pitch, duration)``; onset/duration are in
    16th-note bins, pitch is MIDI pitch 0-127.
prmat2c
    The diffusion "image": ``(2, n_step, 128)`` float32 with an onset channel and a
    sustain channel over (time-step, pitch).  8 bars = 128 steps.
"""

from __future__ import annotations

import numpy as np


def _as_nmat(nmat) -> np.ndarray:
    a = np.asarray(nmat, dtype=np.int64)
    if a.size == 0:
        return np.zeros((0, 3), dtype=np.int64)
    return a.reshape(-1, a.shape[-1])[:, :3]


def nmat_to_prmat2c(nmat, n_step: int = 32, use_track=None) -> np.ndarray:
    """Note matrix -> 2-channel onset/sustain piano-roll image.

    Matches reference ``utils.py:220-237``: onset pixel at ``(o, p)``; sustain pixels at
    ``(o+1 .. o+d-1, p)`` clipped to ``n_step``.  ``use_track`` selects sub-nmats when
    ``nmat`` is a per-track list.
    """
    pr = np.zeros((2, n_step, 128), dtype=np.float32)
    if use_track is not None:
        mats = [_as_nmat(nmat[t]) for t in use_track]
        nm = np.concatenate(mats, axis=0) if mats else np.zeros((0, 3), np.int64)
    else:
        nm = _as_nmat(nmat)
    if nm.shape[0] == 0:
        return pr
    o, p, d = nm[:, 0], nm[:, 1], nm[:, 2]
    keep = (o >= 0) & (o < n_step)
    o, p, d = o[keep], p[keep], d[keep]
    if o.size == 0:
        return pr
    pr[0, o, p] = 1.0
    sus_len = np.maximum(np.minimum(o + d, n_step) - (o + 1), 0)
    total = int(sus_len.sum())
    if total:
        starts = np.repeat(o + 1, sus_len)
        base = np.repeat(np.cumsum(sus_len) - sus_len, sus_len)
        offs = np.arange(total, dtype=np.int64) - base
        pr[1, starts + offs, np.repeat(p, sus_len)] = 1.0
    return pr


def sustain_run_lengths(sustain_bin: np.ndarray) -> np.ndarray:
    """For each (t, p): number of consecutive sustain==1 steps starting at t.

    ``run[t] = sustain[t] * (run[t+1] + 1)`` scanned from the end (vectorized over pitch).
    """
    n_step = sustain_bin.shape[0]
    run = np.zeros_like(sustain_bin)
    nxt = np.zeros(sustain_bin.shape[1:], dtype=sustain_bin.dtype)
    for t in range(n_step - 1, -1, -1):
        nxt = sustain_bin[t] * (nxt + 1)
        run[t] = nxt
    return run
