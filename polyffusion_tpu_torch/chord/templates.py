"""Chord template bank: 12 roots x (32 qualities + 12 inversion slots) + N = 529 classes
(a copy of the JAX package's ``chord/templates.py``).

Same class vocabulary and scoring semantics as the reference bank
(``chord_extractor/chord_class.py:5-139``) but scoring is fully vectorized: one
(N, 12) @ (12, C) matmul per feature instead of a Python loop over 529 classes
(~80x faster on the data-prep hot path).
"""

from __future__ import annotations

import numpy as np

# quality -> root-relative chroma template (the recognizer's search vocabulary)
RECOGNIZER_QUALITIES = {
    "maj": [1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0],
    "min": [1, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0],
    "aug": [1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0],
    "dim": [1, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0, 0],
    "sus4": [1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0],
    "sus4(b7)": [1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 1, 0],
    "sus4(b7,9)": [1, 0, 1, 0, 0, 1, 0, 1, 0, 0, 1, 0],
    "sus2": [1, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0],
    "7": [1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0],
    "maj7": [1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 1],
    "min7": [1, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 0],
    "minmaj7": [1, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1],
    "maj6": [1, 0, 0, 0, 1, 0, 0, 1, 0, 1, 0, 0],
    "min6": [1, 0, 0, 1, 0, 0, 0, 1, 0, 1, 0, 0],
    "9": [1, 0, 1, 0, 1, 0, 0, 1, 0, 0, 1, 0],
    "maj9": [1, 0, 1, 0, 1, 0, 0, 1, 0, 0, 0, 1],
    "min9": [1, 0, 1, 1, 0, 0, 0, 1, 0, 0, 1, 0],
    "7(#9)": [1, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0],
    "maj6(9)": [1, 0, 1, 0, 1, 0, 0, 1, 0, 1, 0, 0],
    "min6(9)": [1, 0, 1, 1, 0, 0, 0, 1, 0, 1, 0, 0],
    "maj(9)": [1, 0, 1, 0, 1, 0, 0, 1, 0, 0, 0, 0],
    "min(9)": [1, 0, 1, 1, 0, 0, 0, 1, 0, 0, 0, 0],
    "maj(11)": [1, 0, 0, 0, 1, 1, 0, 1, 0, 0, 0, 1],
    "min(11)": [1, 0, 0, 1, 0, 1, 0, 1, 0, 0, 0, 1],
    "11": [1, 0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0],
    "maj9(11)": [1, 0, 1, 0, 1, 1, 0, 1, 0, 0, 0, 1],
    "min11": [1, 0, 1, 1, 0, 1, 0, 1, 0, 0, 1, 0],
    "13": [1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 1, 0],
    "maj13": [1, 0, 1, 0, 1, 1, 0, 1, 0, 1, 0, 1],
    "min13": [1, 0, 1, 1, 0, 1, 0, 1, 0, 1, 1, 0],
    "dim7": [1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0],
    "hdim7": [1, 0, 0, 1, 0, 0, 1, 0, 0, 0, 1, 0],
}

# qualities that additionally get inversion (slash) variants
INVERSIONS = {
    "maj": ["3", "5"],
    "min": ["b3", "5"],
    "7": ["3", "5", "b7"],
    "maj7": ["3", "5", "7"],
    "min7": ["5", "b7"],
}

NUM_TO_ABS_SCALE = ["C", "C#", "D", "Eb", "E", "F", "F#", "G", "Ab", "A", "Bb", "B"]
NUM_TO_INVERSION = ["1", "b2", "2", "b3", "3", "4", "b5", "5", "#5", "6", "b7", "7"]


class ChordTemplates:
    def __init__(self):
        names = ["N"]
        chroma = [np.zeros(12)]
        bass = [np.zeros(12)]
        bass_unit = np.eye(12)[0]
        for i in range(12):
            for q, template in RECOGNIZER_QUALITIES.items():
                t = np.array(template, dtype=float)
                names.append(f"{NUM_TO_ABS_SCALE[i]}:{q}")
                chroma.append(np.roll(t, i))
                bass.append(np.roll(bass_unit, i))
                for inv in INVERSIONS.get(q, ()):
                    delta = NUM_TO_INVERSION.index(inv)
                    names.append(f"{NUM_TO_ABS_SCALE[i]}:{q}/{inv}")
                    chroma.append(np.roll(t, i))
                    bass.append(np.roll(bass_unit, i + delta))

        self.chord_list = names
        self.chroma_templates = np.array(chroma)
        self.bass_templates = np.array(bass)

        # precomputed scoring operators: per class c with template T_c,
        #   score(x, b) = (x . T_c - x . (1 - T_c)) / |T_c| + 0.5 b . B_c
        #                 - 0.1 |T_c| - 0.05 [inversion]
        # so score = x @ W + b @ (0.5 B^T) + const, one matmul each.
        n_pos = self.chroma_templates.sum(axis=1)  # |T_c| (0 for N)
        n_pos_safe = np.where(n_pos > 0, n_pos, 1.0)
        signed = 2.0 * self.chroma_templates - 1.0  # +1 in-template, -1 out
        self._w_chroma = (signed / n_pos_safe[None].T).T  # (12, C)
        self._w_bass = 0.5 * self.bass_templates.T  # (12, C)
        is_inv = np.array(["/" in n for n in names], dtype=float)
        self._const = -0.1 * n_pos - 0.05 * is_inv
        # N-chord: fixed score 0.2 regardless of features
        self._is_n = np.array([n == "N" for n in names])
        self._const = np.where(self._is_n, 0.2, self._const)
        self._w_chroma[:, self._is_n] = 0.0
        self._w_bass[:, self._is_n] = 0.0

    def __len__(self) -> int:
        return len(self.chord_list)

    def batch_score(self, chromas: np.ndarray, bass_chromas: np.ndarray) -> np.ndarray:
        """(N, 12) features -> (N, C) scores; semantics of chord_class.py:113-139."""
        return chromas @ self._w_chroma + bass_chromas @ self._w_bass + self._const
