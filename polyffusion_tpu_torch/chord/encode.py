"""Chord-label codec (the subset of the mir_eval chord grammar this framework uses;
a copy of the JAX package's ``chord/encode.py``).

Implements the standard Harte chord-label syntax ``ROOT[:QUALITY][(DEGREES)][/BASS]``
and the numerical encoding contract of ``mir_eval.chord.encode`` (reference vendored
``mir_eval/chord.py:469-521``): ``(root_number, root-relative semitone bitmap,
bass_number)`` with the bass bit forced into the bitmap.  Verified 1:1 against the
reference's vendored mir_eval in tests.
"""

from __future__ import annotations

from typing import Set, Tuple

import numpy as np

NO_CHORD = "N"
X_CHORD = "X"

# pitch letters -> semitones
_PITCH_CLASSES = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}

# scale degrees -> semitones (NOT wrapped; degree 9 = 14, etc.)
_SCALE_DEGREES = {
    "1": 0, "2": 2, "3": 4, "4": 5, "5": 7, "6": 9, "7": 11,
    "8": 12, "9": 14, "10": 16, "11": 17, "12": 19, "13": 21,
}

# quality shorthand -> root-relative semitone bitmap
QUALITIES = {
    "maj": [1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0],
    "min": [1, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 0],
    "aug": [1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0],
    "dim": [1, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0, 0],
    "sus4": [1, 0, 0, 0, 0, 1, 0, 1, 0, 0, 0, 0],
    "sus2": [1, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0],
    "7": [1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0],
    "maj7": [1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 1],
    "min7": [1, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 0],
    "minmaj7": [1, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0, 1],
    "maj6": [1, 0, 0, 0, 1, 0, 0, 1, 0, 1, 0, 0],
    "min6": [1, 0, 0, 1, 0, 0, 0, 1, 0, 1, 0, 0],
    "dim7": [1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0],
    "hdim7": [1, 0, 0, 1, 0, 0, 1, 0, 0, 0, 1, 0],
    # upper voicings of extended chords are deliberately NOT spelled out in the
    # 12-bitmap (matching mir_eval's table, chord.py:259-270)
    "maj9": [1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 1],
    "min9": [1, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 0],
    "9": [1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0],
    "b9": [1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0],
    "#9": [1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0],
    "min11": [1, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 0],
    "11": [1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0],
    "#11": [1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0],
    "maj13": [1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 1],
    "min13": [1, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 0],
    "13": [1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0],
    "b13": [1, 0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0],
    "1": [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    "5": [1, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0],
    "": [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
}


#: scale-degree extensions implied by extended qualities when folding upper
#: voicings into the octave (mir_eval ``EXTENDED_QUALITY_REDUX``, chord.py:301);
#: the base-quality bitmaps already coincide with our QUALITIES entries
_EXTENDED_QUALITY_DEGREES = {
    "minmaj7": {"7"}, "maj9": {"9"}, "min9": {"9"}, "9": {"9"}, "b9": {"b9"},
    "#9": {"#9"}, "11": {"9", "11"}, "#11": {"9", "#11"},
    "13": {"9", "11", "13"}, "b13": {"9", "11", "b13"},
    "min11": {"9", "11"}, "maj13": {"9", "11", "13"}, "min13": {"9", "11", "13"},
}


class InvalidChordError(ValueError):
    pass


def pitch_class_to_semitone(pitch_class: str) -> int:
    """'C#' -> 1, 'Gbb' -> 5 (letter then any number of #/b)."""
    if not pitch_class or pitch_class[0] not in _PITCH_CLASSES:
        raise InvalidChordError(f"bad pitch class: {pitch_class!r}")
    semitone = _PITCH_CLASSES[pitch_class[0]]
    for ch in pitch_class[1:]:
        if ch == "#":
            semitone += 1
        elif ch == "b":
            semitone -= 1
        else:
            raise InvalidChordError(f"bad pitch class: {pitch_class!r}")
    return semitone % 12


def scale_degree_to_semitone(scale_degree: str) -> int:
    """'b7' -> 10, '#5' -> 8, '9' -> 14 (un-wrapped)."""
    offset = 0
    if scale_degree.startswith("#"):
        offset = scale_degree.count("#")
        scale_degree = scale_degree.lstrip("#")
    elif scale_degree.startswith("b"):
        offset = -scale_degree.count("b")
        scale_degree = scale_degree.lstrip("b")
    if scale_degree not in _SCALE_DEGREES:
        raise InvalidChordError(f"bad scale degree: {scale_degree!r}")
    return _SCALE_DEGREES[scale_degree] + offset


def split(chord_label: str) -> Tuple[str, str, Set[str], str]:
    """Label -> (root, quality, scale-degree set, bass degree)."""
    chord_label = str(chord_label).strip()
    if chord_label == NO_CHORD:
        return chord_label, "", set(), ""

    bass = "1"
    if "/" in chord_label:
        chord_label, bass = chord_label.split("/")

    degrees: Set[str] = set()
    if "(" in chord_label:
        chord_label, deg_str = chord_label.split("(")
        degrees = {d.strip() for d in deg_str.rstrip(")").split(",")}

    quality = "" if degrees else "maj"
    if ":" in chord_label:
        root, quality_name = chord_label.split(":")
        if quality_name:
            quality = quality_name.lower()
    else:
        root = chord_label
    return root, quality, degrees, bass


def encode(
    chord_label: str, wrap_extensions: bool = False
) -> Tuple[int, np.ndarray, int]:
    """Label -> (root semitone, root-relative bitmap, bass semitone rel. root).

    ``wrap_extensions`` folds above-octave scale degrees into the 12-bitmap
    (mir_eval's ``reduce_extended_chords``; default drops them unwrapped).
    """
    if chord_label == NO_CHORD:
        return -1, np.zeros(12, dtype=int), -1
    if chord_label == X_CHORD:
        return -1, -np.ones(12, dtype=int), -1

    root, quality, degrees, bass = split(chord_label)
    root_number = pitch_class_to_semitone(root)
    bass_number = scale_degree_to_semitone(bass) % 12

    if quality not in QUALITIES:
        raise InvalidChordError(f"unknown quality: {quality!r} in {chord_label!r}")
    bitmap = np.array(QUALITIES[quality], dtype=int)
    bitmap[0] = 1
    if wrap_extensions:
        degrees = set(degrees) | _EXTENDED_QUALITY_DEGREES.get(quality, set())
    for degree in degrees:
        sign = 1
        if degree.startswith("*"):
            sign = -1
            degree = degree.lstrip("*")
        semitone = scale_degree_to_semitone(degree)
        if semitone < 12 or wrap_extensions:
            bitmap[semitone % 12] += sign
    bitmap = (bitmap > 0).astype(int)
    bitmap[bass_number] = 1
    return root_number, bitmap, bass_number


def encode_to_absolute_row(chord_label: str) -> list:
    """Label -> the 14-column chord-matrix row [root, absolute chroma x12, abs bass]
    used by the data pipeline (reference ``chord_extractor/__init__.py:10-46``)."""
    root, bitmap, bass = encode(chord_label)
    chroma = np.roll(bitmap, root)
    abs_bass = (bass + root) % 12
    return [root, *chroma.tolist(), abs_bass]
