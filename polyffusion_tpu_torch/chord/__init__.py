"""Rule-based chord recognition, the chord label codec, and the mir_eval chord
scoring surface (a copy of the JAX package's ``chord/``)."""

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
