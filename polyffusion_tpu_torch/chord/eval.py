"""Chord-estimation evaluation metrics (the mir_eval ``chord`` scoring API; a copy
of the JAX package's ``chord/eval.py``).

The reference vendors the full mir_eval library but only calls ``chord.encode``
on the training path; the comparison/scoring surface is its offline-eval
toolbox (SURVEY.md §2.8).  This module rebuilds that surface on top of this
package's codec (``chord/encode.py``) with vectorized NumPy — behavioral
contract per reference ``mir_eval/chord.py:619-1552`` and ``util.py:280-911``,
pinned by exact-parity tests against the vendored oracle
(``tests/test_chord_eval.py``).

Comparison functions map ``(reference_labels, estimated_labels)`` to per-pair
scores in {0, 1} with −1 marking out-of-gamut pairs that ``weighted_accuracy``
must ignore.  ``evaluate`` composes the full score dict over labeled intervals.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .encode import NO_CHORD, QUALITIES, encode as _encode_one

__all__ = [
    "encode_many", "rotate_bitmaps_to_roots", "weighted_accuracy",
    "thirds", "thirds_inv", "triads", "triads_inv", "tetrads", "tetrads_inv",
    "root", "mirex", "majmin", "majmin_inv", "sevenths", "sevenths_inv",
    "directional_hamming_distance", "overseg", "underseg", "seg",
    "merge_chord_intervals", "adjust_intervals", "merge_labeled_intervals",
    "intervals_to_durations", "evaluate",
]


def encode_many(labels: Sequence[str], wrap_extensions: bool = False):
    """Labels -> (roots (n,), semitone bitmaps (n, 12), basses (n,)).

    ``wrap_extensions`` folds above-octave scale degrees into the bitmap
    (the reference's ``reduce_extended_chords`` used by interval merging).
    """
    n = len(labels)
    roots = np.zeros(n, dtype=int)
    basses = np.zeros(n, dtype=int)
    semitones = np.zeros((n, 12), dtype=int)
    cache = {}
    for i, label in enumerate(labels):
        got = cache.get(label)
        if got is None:
            got = cache[label] = _encode_one(label, wrap_extensions=wrap_extensions)
        roots[i], semitones[i], basses[i] = got
    return roots, semitones, basses


def rotate_bitmaps_to_roots(bitmaps, roots) -> np.ndarray:
    """Root-relative bitmaps -> absolute pitch-class space (vectorized).

    Nonzero positions rotate by the root; output entries are 1 at rotated
    positions (matching the reference's nonzero-index rotation, which maps the
    X chord's all−1 bitmap to all-ones)."""
    bitmaps = np.asarray(bitmaps)
    roots = np.asarray(roots)
    n, k = bitmaps.shape
    cols = (np.arange(k)[None, :] + roots[:, None]) % k
    out = np.zeros_like(bitmaps)
    rows = np.repeat(np.arange(n), k).reshape(n, k)
    mask = bitmaps != 0
    out[rows[mask], cols[mask]] = 1
    return out


def _validate(ref: Sequence[str], est: Sequence[str]) -> None:
    if len(ref) != len(est):
        raise ValueError(
            f"Chord comparison received different length lists: "
            f"len(reference)={len(ref)}\tlen(estimates)={len(est)}"
        )


def weighted_accuracy(comparisons: np.ndarray, weights: np.ndarray) -> float:
    """Weight the per-pair scores, ignoring out-of-gamut (−1) pairs."""
    comparisons = np.asarray(comparisons)
    weights = np.asarray(weights)
    if weights.shape[0] != comparisons.shape[0]:
        raise ValueError(
            f"weights and comparisons should be of the same length. "
            f"len(weights) = {weights.shape[0]} but len(comparisons) = "
            f"{comparisons.shape[0]}"
        )
    if (weights < 0).any():
        raise ValueError("Weights should all be positive.")
    if np.sum(weights) == 0:
        return 0
    valid = comparisons >= 0
    if valid.sum() == 0:
        return 0
    comparisons = comparisons[valid]
    weights = np.asarray(weights[valid], dtype=float)
    return float(np.sum(comparisons * weights / weights.sum()))


def _skip_x(scores: np.ndarray, ref_semitones: np.ndarray) -> np.ndarray:
    scores[np.any(ref_semitones < 0, axis=1)] = -1.0
    return scores


def thirds(ref, est) -> np.ndarray:
    """Root + third agreement (reference chord.py:712-757)."""
    _validate(ref, est)
    rr, rs, _ = encode_many(ref)
    er, es, _ = encode_many(est)
    scores = ((rr == er) & (rs[:, 3] == es[:, 3])).astype(float)
    return _skip_x(scores, rs)


def thirds_inv(ref, est) -> np.ndarray:
    _validate(ref, est)
    rr, rs, rb = encode_many(ref)
    er, es, eb = encode_many(est)
    scores = ((rr == er) & (rb == eb) & (rs[:, 3] == es[:, 3])).astype(float)
    return _skip_x(scores, rs)


def triads(ref, est) -> np.ndarray:
    """Root + first-octave (triad) spelling agreement (chord.py:807-853)."""
    _validate(ref, est)
    rr, rs, _ = encode_many(ref)
    er, es, _ = encode_many(est)
    scores = ((rr == er) & np.all(rs[:, :8] == es[:, :8], axis=1)).astype(float)
    return _skip_x(scores, rs)


def triads_inv(ref, est) -> np.ndarray:
    _validate(ref, est)
    rr, rs, rb = encode_many(ref)
    er, es, eb = encode_many(est)
    scores = (
        (rr == er) & (rb == eb) & np.all(rs[:, :8] == es[:, :8], axis=1)
    ).astype(float)
    return _skip_x(scores, rs)


def tetrads(ref, est) -> np.ndarray:
    """Root + full spelling agreement (chord.py:904-949)."""
    _validate(ref, est)
    rr, rs, _ = encode_many(ref)
    er, es, _ = encode_many(est)
    scores = ((rr == er) & np.all(rs == es, axis=1)).astype(float)
    return _skip_x(scores, rs)


def tetrads_inv(ref, est) -> np.ndarray:
    _validate(ref, est)
    rr, rs, rb = encode_many(ref)
    er, es, eb = encode_many(est)
    scores = ((rr == er) & (rb == eb) & np.all(rs == es, axis=1)).astype(float)
    return _skip_x(scores, rs)


def root(ref, est) -> np.ndarray:
    """Root-only agreement (chord.py:999-1043)."""
    _validate(ref, est)
    rr, rs, _ = encode_many(ref)
    er = encode_many(est)[0]
    scores = (rr == er).astype(float)
    return _skip_x(scores, rs)


def mirex(ref, est) -> np.ndarray:
    """MIREX-style ≥3-shared-chroma agreement (chord.py:1045-1105)."""
    _validate(ref, est)
    min_intersection = 3
    rr, rs, _ = encode_many(ref)
    er, es, _ = encode_many(est)
    ref_chroma = rotate_bitmaps_to_roots(rs, rr)
    est_chroma = rotate_bitmaps_to_roots(es, er)
    eq_chroma = (ref_chroma * est_chroma).sum(axis=-1)
    scores = (eq_chroma >= min_intersection).astype(float)
    scores[(rr == -1) & (er == -1)] = 1.0  # N matches N
    counts = (rs > 0).sum(axis=1)
    skip = (counts > 0) & (counts < min_intersection)
    skip |= np.any(rs < 0, axis=1)  # X out of gamut
    scores[skip] = -1.0
    return scores


def _majmin_gamut(scores: np.ndarray, rr, rs) -> np.ndarray:
    maj = np.asarray(QUALITIES["maj"][:8])
    mn = np.asarray(QUALITIES["min"][:8])
    is_maj = np.all(rs[:, :8] == maj, axis=1)
    is_min = np.all(rs[:, :8] == mn, axis=1)
    is_none = (rr < 0) & np.all(rs == 0, axis=1)
    scores[~(is_maj | is_min | is_none)] = -1
    return scores


def _invalid_inversion(rs, rb) -> np.ndarray:
    valid = np.ones(rb.shape, dtype=bool)
    has_bass = rb >= 0
    valid[has_bass] = rs[has_bass, rb[has_bass]].astype(bool)
    return ~valid


def majmin(ref, est) -> np.ndarray:
    """Major/minor/no-chord agreement; everything else out of gamut
    (chord.py:1107-1171)."""
    _validate(ref, est)
    rr, rs, _ = encode_many(ref)
    er, es, _ = encode_many(est)
    scores = ((rr == er) & np.all(rs[:, :8] == es[:, :8], axis=1)).astype(float)
    return _majmin_gamut(scores, rr, rs)


def majmin_inv(ref, est) -> np.ndarray:
    _validate(ref, est)
    rr, rs, rb = encode_many(ref)
    er, es, eb = encode_many(est)
    scores = (
        (rr == er) & (rb == eb) & np.all(rs[:, :8] == es[:, :8], axis=1)
    ).astype(float)
    scores = _majmin_gamut(scores, rr, rs)
    scores[_invalid_inversion(rs, rb)] = -1
    return scores


_SEVENTH_QUALITIES = ("maj", "min", "maj7", "7", "min7", "")


def _sevenths_gamut(scores: np.ndarray, rs) -> np.ndarray:
    valid = np.asarray([QUALITIES[q] for q in _SEVENTH_QUALITIES])
    in_gamut = np.any(
        np.all(rs[None, :, :] == valid[:, None, :], axis=2), axis=0
    )
    scores[~in_gamut] = -1
    return scores


def sevenths(ref, est) -> np.ndarray:
    """maj/min/maj7/7/min7/N agreement over the full spelling
    (chord.py:1238-1291)."""
    _validate(ref, est)
    rr, rs, _ = encode_many(ref)
    er, es, _ = encode_many(est)
    scores = ((rr == er) & np.all(rs == es, axis=1)).astype(float)
    return _sevenths_gamut(scores, rs)


def sevenths_inv(ref, est) -> np.ndarray:
    _validate(ref, est)
    rr, rs, rb = encode_many(ref)
    er, es, eb = encode_many(est)
    scores = ((rr == er) & (rb == eb) & np.all(rs == es, axis=1)).astype(float)
    scores = _sevenths_gamut(scores, rs)
    scores[_invalid_inversion(rs, rb)] = -1
    return scores


# ---------------------------------------------------------------------------
# segmentation metrics + interval plumbing
# ---------------------------------------------------------------------------


def _validate_intervals(intervals: np.ndarray) -> None:
    if intervals.ndim != 2 or intervals.shape[1] != 2:
        raise ValueError(
            f"Intervals should be n-by-2 numpy ndarray, but shape={intervals.shape}"
        )
    if (intervals < 0).any():
        raise ValueError("Negative interval times found")
    if (intervals[:, 1] <= intervals[:, 0]).any():
        raise ValueError("All interval durations must be strictly positive")


def directional_hamming_distance(reference_intervals, estimated_intervals) -> float:
    """Mean per-reference-segment fragmentation by estimated boundaries
    (chord.py:1353-1399)."""
    reference_intervals = np.asarray(reference_intervals)
    estimated_intervals = np.asarray(estimated_intervals)
    _validate_intervals(reference_intervals)
    _validate_intervals(estimated_intervals)
    if len(reference_intervals) > 1 and (
        reference_intervals[:-1, 1] > reference_intervals[1:, 0]
    ).any():
        raise ValueError("Chord Intervals must not overlap")
    est_ts = np.unique(estimated_intervals.flatten())
    total = 0.0
    for start, end in reference_intervals:
        inside = est_ts[(est_ts >= start) & (est_ts < end)]
        cuts = np.hstack([start, inside, end])
        total += (end - start) - np.diff(cuts).max()
    span = reference_intervals[-1, 1] - reference_intervals[0, 0]
    return total / span


def overseg(reference_intervals, estimated_intervals) -> float:
    return 1 - directional_hamming_distance(reference_intervals, estimated_intervals)


def underseg(reference_intervals, estimated_intervals) -> float:
    return 1 - directional_hamming_distance(estimated_intervals, reference_intervals)


def seg(reference_intervals, estimated_intervals) -> float:
    return min(
        underseg(reference_intervals, estimated_intervals),
        overseg(reference_intervals, estimated_intervals),
    )


def merge_chord_intervals(intervals, labels) -> np.ndarray:
    """Merge adjacent intervals whose labels encode identically
    (chord.py:1483-1515; uses wrapped extensions like the reference)."""
    intervals = np.asarray(intervals)
    roots, semitones, basses = encode_many(labels, wrap_extensions=True)
    merged: List[List[float]] = []
    prev = None
    for (s, e), rt, st, ba in zip(intervals, roots, semitones, basses):
        key = (rt, tuple(st), ba)
        if key != prev:
            prev = key
            merged.append([s, e])
        else:
            merged[-1][-1] = e
    return np.asarray(merged)


def adjust_intervals(
    intervals: np.ndarray,
    labels: Optional[List[str]],
    t_min: Optional[float],
    t_max: Optional[float],
    start_label: str = NO_CHORD,
    end_label: str = NO_CHORD,
) -> Tuple[np.ndarray, Optional[List[str]]]:
    """Crop/pad labeled intervals to the [t_min, t_max] span
    (reference util.py:280-380)."""
    intervals = np.asarray(intervals, dtype=float)
    labels = list(labels) if labels is not None else None
    if intervals.size == 0:
        if t_min is None or t_max is None:
            raise ValueError("Supplied intervals are empty, can't append new intervals")
        return np.array([[t_min, t_max]]), [start_label]
    if t_min is not None:
        keep = np.argwhere(intervals[:, 1] >= t_min)
        if len(keep) > 0:
            first = int(keep[0, 0])  # keep is (N, 1); ndim>0 int() is deprecated
            intervals = intervals[first:]
            if labels is not None:
                labels = labels[first:]
        intervals = np.maximum(t_min, intervals)
        if intervals.min() > t_min:
            intervals = np.vstack(([t_min, intervals.min()], intervals))
            if labels is not None:
                labels.insert(0, start_label)
    if t_max is not None:
        above = np.argwhere(intervals[:, 0] > t_max)
        if len(above) > 0:
            last = int(above[0, 0])
            intervals = intervals[:last]
            if labels is not None:
                labels = labels[:last]
        intervals = np.minimum(t_max, intervals)
        if intervals.max() < t_max:
            intervals = np.vstack((intervals, [intervals.max(), t_max]))
            if labels is not None:
                labels.append(end_label)
    return intervals, labels


def merge_labeled_intervals(x_intervals, x_labels, y_intervals, y_labels):
    """Split two co-spanning labeled interval sequences on the union of their
    boundaries (reference util.py:501-560)."""
    x_intervals = np.asarray(x_intervals, dtype=float)
    y_intervals = np.asarray(y_intervals, dtype=float)
    if (
        x_intervals[0, 0] != y_intervals[0, 0]
        or x_intervals[-1, 1] != y_intervals[-1, 1]
    ):
        raise ValueError("Time intervals do not align; did you mean to call "
                         "'adjust_intervals()' first?")
    bounds = np.unique(np.concatenate([x_intervals.flatten(), y_intervals.flatten()]))
    out_intervals = np.stack([bounds[:-1], bounds[1:]], axis=1)
    # each output interval start falls inside exactly one x / y interval
    xi = np.searchsorted(x_intervals[:, 0], out_intervals[:, 0], side="right") - 1
    yi = np.searchsorted(y_intervals[:, 0], out_intervals[:, 0], side="right") - 1
    new_x = [x_labels[i] for i in xi]
    new_y = [y_labels[i] for i in yi]
    return out_intervals, new_x, new_y


def intervals_to_durations(intervals) -> np.ndarray:
    intervals = np.asarray(intervals)
    _validate_intervals(intervals)
    return np.abs(np.diff(intervals, axis=-1)).flatten()


_COMPARISONS = OrderedDict(
    [
        ("thirds", thirds), ("thirds_inv", thirds_inv),
        ("triads", triads), ("triads_inv", triads_inv),
        ("tetrads", tetrads), ("tetrads_inv", tetrads_inv),
        ("root", root), ("mirex", mirex),
        ("majmin", majmin), ("majmin_inv", majmin_inv),
        ("sevenths", sevenths), ("sevenths_inv", sevenths_inv),
    ]
)


def evaluate(ref_intervals, ref_labels, est_intervals, est_labels) -> OrderedDict:
    """All comparison scores + segmentation metrics over labeled intervals
    (reference chord.py:1517-1552)."""
    ref_intervals = np.asarray(ref_intervals, dtype=float)
    est_intervals = np.asarray(est_intervals, dtype=float)
    est_intervals, est_labels = adjust_intervals(
        est_intervals, est_labels, ref_intervals.min(), ref_intervals.max()
    )
    merged_ref = merge_chord_intervals(ref_intervals, ref_labels)
    merged_est = merge_chord_intervals(est_intervals, est_labels)
    intervals, ref_labels, est_labels = merge_labeled_intervals(
        ref_intervals, list(ref_labels), est_intervals, list(est_labels)
    )
    durations = intervals_to_durations(intervals)
    scores: OrderedDict = OrderedDict()
    for name, fn in _COMPARISONS.items():
        scores[name] = weighted_accuracy(fn(ref_labels, est_labels), durations)
    scores["underseg"] = underseg(merged_ref, merged_est)
    scores["overseg"] = overseg(merged_ref, merged_est)
    scores["seg"] = min(scores["overseg"], scores["underseg"])
    return scores
