"""The port's chord recognizer and label codec (``chord/``) against the JAX
package's, on the same labels, features and MIDI files: every value exact."""

import importlib

import numpy as np
import pytest

from midi_cases import hand_built_cases, write_case, write_song
from polyffusion_tpu.chord import recognizer as jax_rec
from polyffusion_tpu.chord.templates import ChordTemplates as JaxChordTemplates
from polyffusion_tpu.utils import midi as jax_midi
from polyffusion_tpu_torch.chord import recognizer as rec
from polyffusion_tpu_torch.chord.templates import ChordTemplates
from polyffusion_tpu_torch.utils import midi

E = importlib.import_module("polyffusion_tpu_torch.chord.encode")
JAX_E = importlib.import_module("polyffusion_tpu.chord.encode")
CASES = hand_built_cases()
EXTRA_LABELS = ["C", "G#:min(*b3,*5)/5", "A:(3)/6", "Gbb:7", "F##:min9", "B:sus2/2", "X",
                "D:maj13", "E:min11/b7", "F:13(b9)", "Bb:hdim7/b3"]


@pytest.fixture(scope="module")
def banks():
    return ChordTemplates(), JaxChordTemplates()


def test_encode_matches_jax_over_the_vocabulary(banks):
    for label in banks[0].chord_list + EXTRA_LABELS:
        for wrap in (False, True):
            got, want = E.encode(label, wrap), JAX_E.encode(label, wrap)
            assert got[0] == want[0] and got[2] == want[2], label
            np.testing.assert_array_equal(got[1], want[1], err_msg=label)
        assert E.split(label) == JAX_E.split(label)
        if label != "X":
            assert E.encode_to_absolute_row(label) == JAX_E.encode_to_absolute_row(label)
    with pytest.raises(E.InvalidChordError):
        E.encode("C:nonsense")


def test_template_bank_matches_jax(banks):
    got, want = banks
    assert got.chord_list == want.chord_list and len(got) == 529
    for name in ("chroma_templates", "bass_templates", "_w_chroma", "_w_bass", "_const"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    rng = np.random.default_rng(0)
    chromas, basses = rng.random((64, 12)) * 3, rng.random((64, 12))
    np.testing.assert_array_equal(got.batch_score(chromas, basses),
                                  want.batch_score(chromas, basses))


def _block_chords(M, path, progression, beats_per_chord=4, one_beat=0.5):
    """tests/test_chord.py's ``make_chord_midi`` with the ``M`` module's writer."""
    ins = M.Instrument(program=0)
    t = 0.0
    for pitches in progression:
        for p in pitches:
            ins.notes.append(M.Note(t, t + beats_per_chord * one_beat, p, 80))
        t += beats_per_chord * one_beat
    M.save_midi(M.MidiFile(instruments=[ins], time_signatures=[M.TimeSignature(4, 4, 0.0, 0)]),
                path)


def _band(M, path):
    """tests/test_chord.py's multitrack-with-drums MIDI."""
    melody, bass, drums = (M.Instrument(program=0), M.Instrument(program=32),
                           M.Instrument(program=0, is_drum=True))
    for beat in range(16):
        t = beat * 0.5
        melody.notes.append(M.Note(t, t + 0.5, 64 + (beat % 3), 80))
        bass.notes.append(M.Note(t, t + 0.5, 36, 90))
        drums.notes.append(M.Note(t, t + 0.1, 40, 100))
    for beat in range(16):
        t = beat * 0.5
        for p in (60, 64, 67):
            melody.notes.append(M.Note(t, t + 0.5, p, 70))
    M.save_midi(M.MidiFile(instruments=[melody, bass, drums],
                           time_signatures=[M.TimeSignature(4, 4, 0.0, 0)]), path)


C, F, G = [60, 64, 67], [53, 57, 60], [55, 59, 62]
WRITTEN = {
    "progression": lambda M, p: _block_chords(M, p, [C, C, F, F, G, G, C, C]),
    "inversion": lambda M, p: _block_chords(M, p, [[52, 60, 64, 67]] * 2),
    "band": _band,
    "song": lambda M, p: write_song(M, p, n_bars=8, seed=2),
    "song_tempo_change": lambda M, p: write_song(M, p, n_bars=8, seed=3, tempo_change=True),
}


def _midi_path(tmp_path, name):
    if name in CASES:
        return write_case(tmp_path, name, CASES[name])
    path = str(tmp_path / f"{name}.mid")
    WRITTEN[name](midi, path)
    jax_path = str(tmp_path / f"{name}_jax.mid")
    WRITTEN[name](jax_midi, jax_path)
    assert open(path, "rb").read() == open(jax_path, "rb").read()
    return path


@pytest.mark.parametrize("name", sorted(WRITTEN) + sorted(CASES))
def test_recognizer_matches_jax(tmp_path, name):
    """Chordlab rows (times and labels), the written chordlab and its chord
    matrix; the features on the way (channel weights, beat grid) too."""
    path = _midi_path(tmp_path, name)
    got_m, want_m = midi.load_midi(path), jax_midi.load_midi(path)
    np.testing.assert_array_equal(rec.thickness_and_bass_weights(got_m),
                                  jax_rec.thickness_and_bass_weights(want_m))
    for ins_got, ins_want in zip(got_m.instruments, want_m.instruments):
        np.testing.assert_array_equal(rec._piano_roll(ins_got), jax_rec._piano_roll(ins_want))
        assert rec._is_percussive(ins_got) == jax_rec._is_percussive(ins_want)
    for div in (1, 2):
        np.testing.assert_array_equal(rec.beat_grid(got_m, div), jax_rec.beat_grid(want_m, div))
    got = rec.transcribe_midi(path, str(tmp_path / "port.lab"))
    want = jax_rec.transcribe_midi(path, str(tmp_path / "jax.lab"))
    assert got == want and got
    assert open(tmp_path / "port.lab").read() == open(tmp_path / "jax.lab").read()
    assert rec.read_chordlab(str(tmp_path / "port.lab")) == jax_rec.read_chordlab(
        str(tmp_path / "jax.lab"))
    for rounding in (True, False):
        np.testing.assert_array_equal(rec.chord_matrix_from_chordlab(got, rounding=rounding),
                                      jax_rec.chord_matrix_from_chordlab(want, rounding=rounding))
    np.testing.assert_array_equal(
        rec.extract_chords_from_midi_file(path, str(tmp_path / "a.lab")),
        jax_rec.extract_chords_from_midi_file(path, str(tmp_path / "b.lab")))


def test_recognizer_finds_the_written_chords(tmp_path):
    """The behaviour tests/test_chord.py asks of the JAX recognizer, of the port's."""
    rows = rec.transcribe_midi(_midi_path(tmp_path, "progression"))
    labels = {lab for s, e, lab in rows for t in (0.5, 5.0, 9.0, 13.0) if s <= t < e}
    assert labels == {"C:maj", "F:maj", "G:maj"}
    assert any(lab == "C:maj/3" for _, _, lab in rec.transcribe_midi(_midi_path(tmp_path,
                                                                                "inversion")))
    mat = rec.chord_matrix_from_chordlab([(0.0, 2.0, "C:maj"), (2.0, 4.0, "A:min/5")])
    assert mat.shape == (8, 14) and mat[4, 0] == 9 and mat[4, 13] == 4


def test_recognizer_refuses_a_file_without_beats_as_jax(tmp_path):
    ins = midi.Instrument()
    ins.notes.append(midi.Note(0.0, 0.2, 60, 80))
    path = str(tmp_path / "short.mid")
    midi.save_midi(midi.MidiFile(instruments=[ins]), path)
    for transcribe in (rec.transcribe_midi, jax_rec.transcribe_midi):
        with pytest.raises(ValueError, match="not enough beats"):
            transcribe(path)
