"""Rule-based chord recognition + chord label codec (a copy of the JAX
package's ``chord/``; its ``labels.py`` and ``eval.py`` are not ported yet)."""

from .encode import encode, encode_to_absolute_row, split  # noqa: F401
from .recognizer import (  # noqa: F401
    ChordRecognizer,
    chord_matrix_from_chordlab,
    extract_chords_from_midi_file,
    read_chordlab,
    transcribe_midi,
    write_chordlab,
)
from .templates import ChordTemplates  # noqa: F401
