"""Chord-matrix rows -> label strings (the inverse of ``encode_to_absolute_row``;
a copy of the JAX package's ``chord/labels.py``).

The data pipeline stores chords as beat-level 14-column rows
[root, absolute-chroma x12, absolute-bass] built from recognizer labels
(reference ``chord_extractor/__init__.py:10-46``); the control-fidelity metric
(``expr --type chd_acc``) needs to turn conditioning rows BACK into labels so
``chord/eval.py`` (the mir_eval scoring surface) can compare them against the
labels recognized from the generated MIDI.

Rows that came from the recognizer vocabulary invert exactly via the template
bank; arbitrary rows (e.g. augmented synthetic data) fall back to the
highest-scoring template under the recognizer's own scoring rule, which is
also how such a chroma would have been labeled at recognition time.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Sequence, Tuple

import numpy as np

from .templates import ChordTemplates


@lru_cache(maxsize=1)
def _bank():
    t = ChordTemplates()
    exact = {}
    for name, chroma, bass in zip(t.chord_list, t.chroma_templates, t.bass_templates):
        key = (tuple(int(v) for v in chroma), int(np.argmax(bass)) if bass.any() else -1)
        exact.setdefault(key, name)
    return t, exact


def label_from_chd_row(row: Sequence[float]) -> str:
    """One 14-column row [root, abs chroma x12, abs bass] -> a label string.

    Exact template-bank inverse when possible; recognizer-scored nearest
    template otherwise; all-zero chroma -> "N".
    """
    row = np.asarray(row, dtype=float)
    chroma = row[1:13]
    if not chroma.any():
        return "N"
    bass = int(row[13]) % 12
    templates, exact = _bank()
    hit = exact.get((tuple(int(v) for v in np.rint(chroma)), bass))
    if hit is not None:
        return hit
    bass_onehot = np.eye(12)[bass]
    scores = templates.batch_score(chroma[None], bass_onehot[None])[0]
    return templates.chord_list[int(np.argmax(scores))]


def labels_from_chord_matrix(chd: np.ndarray) -> List[str]:
    """(M, 14) beat-level chord matrix -> M label strings."""
    return [label_from_chd_row(r) for r in np.asarray(chd)]


def beat_labels_to_intervals(
    labels: Sequence[str], one_beat: float = 0.5
) -> Tuple[np.ndarray, List[str]]:
    """Beat-level labels -> merged (intervals (N, 2) seconds, labels) for
    ``chord/eval.py`` scoring; consecutive identical labels coalesce."""
    intervals, out = [], []
    start = 0
    for i, lab in enumerate(labels):
        if i + 1 < len(labels) and labels[i + 1] == lab:
            continue
        intervals.append([start * one_beat, (i + 1) * one_beat])
        out.append(lab)
        start = i + 1
    return np.asarray(intervals, dtype=float), out
