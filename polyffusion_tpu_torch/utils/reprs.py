"""Symbolic-music representations (pure NumPy, host-side): the part of the JAX
package's ``utils/reprs.py`` that the port needs, copied.

nmat
    Note matrix ``(N, 3)`` of ``(onset, pitch, duration)``; onset/duration are in
    16th-note bins, pitch is MIDI pitch 0-127.
prmat2c
    The diffusion "image": ``(2, n_step, 128)`` float32 with an onset channel and a
    sustain channel over (time-step, pitch).  8 bars = 128 steps.
prmat
    ``(n_step, 128)`` int64; ``prmat[t, p] = duration`` at onsets (texture-encoder input).
pnotree
    PianoTree ``(n_step, max_note_count, 6)`` int64; col 0 = pitch index with
    sos/eos/pad specials (128/129/130), cols 1:6 = (duration-1) in 5-bit binary.
chd
    Chord matrix ``(n_beat, 14)``: ``[root, chroma x 12, bass]``; one-hot form is
    ``(n_beat, 36)``: ``[root one-hot 12 | chroma 12 | bass one-hot 12]``.
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


def nmat_to_prmat(nmat, n_step: int = 32) -> np.ndarray:
    """Note matrix -> duration piano-roll ``(n_step, 128)`` (reference ``utils.py:212-217``)."""
    pr = np.zeros((n_step, 128), dtype=np.int64)
    nm = _as_nmat(nmat)
    if nm.shape[0] == 0:
        return pr
    o, p, d = nm[:, 0], nm[:, 1], nm[:, 2]
    keep = (o >= 0) & (o < n_step)
    pr[o[keep], p[keep]] = d[keep]
    return pr


PITCH_SOS = 128
PITCH_EOS = 129
PITCH_PAD = 130
DUR_PAD = 2


def nmat_to_pianotree_repr(
    nmat,
    n_step: int = 32,
    max_note_count: int = 20,
    dur_pad_ind: int = DUR_PAD,
    min_pitch: int = 0,
    pitch_sos_ind: int = PITCH_SOS,
    pitch_eos_ind: int = PITCH_EOS,
    pitch_pad_ind: int = PITCH_PAD,
) -> np.ndarray:
    """Note matrix -> PianoTree grid (reference ``utils.py:132-171``).

    Row layout per time step: ``[sos, note, note, ..., eos, pad...]`` in the pitch
    column; per-note duration is ``(min(d,32) - 1)`` as 5-bit binary in cols 1:6.
    Note insertion order follows nmat order (stateful per-step cursor), so this stays
    a small Python loop.
    """
    pnotree = np.full((n_step, max_note_count, 6), dur_pad_ind, dtype=np.int64)
    pnotree[:, :, 0] = pitch_pad_ind
    pnotree[:, 0, 0] = pitch_sos_ind

    cur = np.ones(n_step, dtype=np.int64)
    bits = np.array([4, 3, 2, 1, 0], dtype=np.int64)
    for o, p, d in _as_nmat(nmat):
        if o < 0 or o >= n_step:
            continue
        pnotree[o, cur[o], 0] = p - min_pitch
        d = min(int(d), 32)
        pnotree[o, cur[o], 1:] = (max(d - 1, 0) >> bits) & 1
        if cur[o] < max_note_count - 1:
            cur[o] += 1
    pnotree[np.arange(n_step), cur, 0] = pitch_eos_ind
    return pnotree


def pnotree_to_nmat(pnotree: np.ndarray) -> np.ndarray:
    """Inverse of :func:`nmat_to_pianotree_repr` (up to note order within a step)."""
    n_step = pnotree.shape[0]
    rows = []
    for t in range(n_step):
        for note in pnotree[t]:
            p = int(note[0])
            if 0 <= p <= 127:
                d = int(note[1] << 4 | note[2] << 3 | note[3] << 2 | note[4] << 1 | note[5]) + 1
                rows.append((t, p, d))
    if not rows:
        return np.zeros((0, 3), dtype=np.int64)
    return np.array(rows, dtype=np.int64)


# prmat2c -> prmat / nmat


def _round_arr(x: np.ndarray, is_custom_round: bool = False) -> np.ndarray:
    if is_custom_round:
        # reference custom_round (utils.py:395-399): 1 only inside (0.95, 1.05)
        return ((x > 0.95) & (x < 1.05)).astype(np.int64)
    return np.rint(x).astype(np.int64)


def prmat2c_to_prmat(prmat2c: np.ndarray, n_step: int = 32) -> np.ndarray:
    """Batch of prmat2c images -> duration piano-rolls (reference ``utils.py:240-269``).

    ``prmat2c``: (N, 2, n_step*ratio, 128) -> returns (N*ratio, n_step, 128) int64;
    duration = 1 + run of sustain pixels immediately after the onset.
    """
    prmat2c = np.asarray(prmat2c)
    if prmat2c.ndim != 4:
        raise ValueError(f"prmat2c must be (N, 2, T, 128), got shape {prmat2c.shape}")
    n, _, big_step, n_pitch = prmat2c.shape
    ratio = big_step // n_step
    out = np.zeros((n * ratio, n_step, n_pitch), dtype=np.int64)
    for i in range(n):
        onset = _round_arr(prmat2c[i, 0])
        sustain = _round_arr(prmat2c[i, 1])
        run = sustain_run_lengths(sustain)
        # duration at an onset (t, p): 1 + run[t+1, p]
        run_next = np.vstack([run[1:], np.zeros((1, n_pitch), dtype=np.int64)])
        dur = (1 + run_next) * (onset > 0)
        for r in range(ratio):
            out[i * ratio + r] = dur[r * n_step : (r + 1) * n_step]
    return out


def prmat2c_to_nmat(prmat2c_single: np.ndarray) -> np.ndarray:
    """One (2, n_step, 128) image -> nmat rows (onset, pitch, duration)."""
    onset = _round_arr(prmat2c_single[0])
    sustain = _round_arr(prmat2c_single[1])
    run = sustain_run_lengths(sustain)
    run_next = np.vstack([run[1:], np.zeros((1, onset.shape[1]), dtype=np.int64)])
    t, p = np.nonzero(onset > 0)
    d = 1 + run_next[t, p]
    return np.stack([t, p, d], axis=1).astype(np.int64)


# pitch-shift augmentation (reference utils.py:174-209)


def pr_mat_pitch_shift(pr_mat: np.ndarray, shift: int) -> np.ndarray:
    """Roll the pitch (last) axis; works for both prmat and prmat2c."""
    return np.roll(pr_mat, shift, axis=-1)


def pianotree_pitch_shift(pnotree: np.ndarray, shift: int) -> np.ndarray:
    out = pnotree.copy()
    out[out[:, :, 0] < 128, 0] += shift
    return out


def chd_pitch_shift(chd: np.ndarray, shift: int) -> np.ndarray:
    out = chd.copy()
    out[:, 0] = (out[:, 0] + shift) % 12
    out[:, 1:13] = np.roll(out[:, 1:13], shift, axis=-1)
    out[:, -1] = (out[:, -1] + shift) % 12
    return out


def chd_to_onehot(chd: np.ndarray) -> np.ndarray:
    """(n_beat, 14) chord matrix -> (n_beat, 36) one-hot (reference ``utils.py:194-201``)."""
    n_step = chd.shape[0]
    onehot = np.zeros((n_step, 36), dtype=np.float32)
    onehot[np.arange(n_step), chd[:, 0].astype(np.int64)] = 1
    onehot[:, 12:24] = chd[:, 1:13]
    onehot[np.arange(n_step), 24 + chd[:, -1].astype(np.int64)] = 1
    return onehot
