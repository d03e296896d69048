"""The port's MIDI reader and writers (``utils/midi.py``, ``utils/midi_io.py``)
and the representation converters they need (``utils/reprs.py``) against the
JAX package's, on the same files and arrays: every field exact."""

import dataclasses

import numpy as np
import pytest

from midi_cases import hand_built_cases, smf, write_case, write_song
from polyffusion_tpu.utils import midi as jax_midi
from polyffusion_tpu.utils import midi_io as jax_midi_io
from polyffusion_tpu.utils import reprs as jax_reprs
from polyffusion_tpu_torch.utils import midi, midi_io, reprs

CASES = hand_built_cases()


def _read_both(path):
    return midi.load_midi(path), jax_midi.load_midi(path)


def _assert_same_midi(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.get_end_time() == want.get_end_time()
    assert got.get_beats() == want.get_beats()
    assert got.get_downbeats() == want.get_downbeats()
    np.testing.assert_array_equal(midi_io.nmat_from_midi_seconds(got),
                                  jax_midi_io.nmat_from_midi_seconds(want))


@pytest.mark.parametrize("name", sorted(CASES))
def test_load_midi_matches_jax_on_hand_built_files(tmp_path, name):
    got, want = _read_both(write_case(tmp_path, name, CASES[name]))
    _assert_same_midi(got, want)
    assert got.instruments, "every case holds notes"


def test_reader_rules_hold(tmp_path):
    """The pretty_midi rules the reader copies, on the port's own reading."""
    read = {n: midi.load_midi(write_case(tmp_path, n, d)) for n, d in CASES.items()}
    # a zero-length note is dropped, and the next note of its pitch is whole
    notes60 = [(n.start_tick, n.end_tick) for ins in read["zero_length"].instruments
               for n in ins.notes if n.pitch == 60 and n.start_tick < 200]
    assert notes60 == [(100, 200)]
    # a same-tick retrigger: the off closes the old note only
    notes64 = sorted((n.start_tick, n.end_tick) for ins in read["retrigger"].instruments
                     for n in ins.notes if n.pitch == 64)
    assert notes64[:2] == [(0, 480), (480, 960)]
    # velocity-0 ons close notes; one off closes both open notes of a pitch
    v0 = sorted((n.pitch, n.start_tick, n.end_tick) for ins in read["velocity0_offs"].instruments
                for n in ins.notes if n.pitch in (60, 62, 65) and n.start_tick < 1440)
    assert v0 == [(60, 0, 480), (62, 480, 960), (65, 960, 1440), (65, 1200, 1440)]
    # a trailing controller extends the end time past the last note-off
    tc = read["trailing_cc"]
    assert tc.get_end_time() > max(n.end for ins in tc.instruments for n in ins.notes)
    # drums on channel 10 are drums; a program change sticks to its own channel
    kinds = {(ins.is_drum, ins.program) for ins in read["drums"].instruments}
    assert kinds == {(False, 0), (False, 115), (True, 0)}
    # the 3/4 stretch: its downbeats are three beats apart
    beats, down = read["three_four"].get_beats(), read["three_four"].get_downbeats()
    assert np.diff(down)[2] == pytest.approx(3 * (beats[1] - beats[0]))


def test_smpte_division_is_refused_as_in_jax(tmp_path):
    path = write_case(tmp_path, "smpte", smf([b""], division=0xE728))
    for load in (midi.load_midi, jax_midi.load_midi):
        with pytest.raises(ValueError, match="SMPTE"):
            load(path)


def _kitchen_sink(M):
    """A MidiFile for the writer: 11 instruments (the channel counter wraps
    past 9 and 15), a drum kit, notes that round to zero ticks, lyrics and
    two time signatures."""
    rng = np.random.default_rng(3)
    instruments = []
    for i in range(11):
        ins = M.Instrument(program=i * 11 % 128, is_drum=(i == 4))
        for _ in range(20):
            s = float(rng.integers(0, 64)) * 0.125 + float(rng.random()) * 1e-4
            end = s + float(rng.integers(0, 6)) * 0.125
            ins.notes.append(M.Note(s, end, int(rng.integers(0, 128)), int(rng.integers(-5, 140))))
        instruments.append(ins)
    return M.MidiFile(instruments=instruments,
                      time_signatures=[M.TimeSignature(4, 4, 0.0), M.TimeSignature(3, 4, 4.0)],
                      lyrics=[M.Lyric("a", 0.0), M.Lyric("bé", 2.5)])


def test_save_midi_writes_the_bytes_of_jax(tmp_path):
    paths = [str(tmp_path / f"{k}.mid") for k in ("port", "jax", "port_tempo", "jax_tempo")]
    midi.save_midi(_kitchen_sink(midi), paths[0])
    jax_midi.save_midi(_kitchen_sink(jax_midi), paths[1])
    midi.save_midi(_kitchen_sink(midi), paths[2], tempo_us_per_beat=612345)
    jax_midi.save_midi(_kitchen_sink(jax_midi), paths[3], tempo_us_per_beat=612345)
    data = [open(p, "rb").read() for p in paths]
    assert data[0] == data[1] and data[2] == data[3] and data[0] != data[2]
    got, want = _read_both(paths[2])
    _assert_same_midi(got, want)


@pytest.mark.parametrize("tempo_change", [False, True])
def test_load_midi_matches_jax_on_written_songs(tmp_path, tempo_change):
    path = str(tmp_path / "song.mid")
    write_song(midi, path, n_bars=8, seed=1, tempo_change=tempo_change)
    got, want = _read_both(path)
    _assert_same_midi(got, want)
    assert len(got.tempo_changes) == 1 + tempo_change


def _estx(rng, b):
    pt = np.zeros((b, 32, 20, 6), np.int64)
    pt[..., 0] = rng.integers(0, 131, pt.shape[:3])
    pt[..., 1:] = rng.integers(0, 2, pt.shape[:3] + (5,))
    return pt


@pytest.mark.parametrize("writer", ["estx", "prmat", "prmat_float", "chd14", "chd36"])
def test_writers_write_the_bytes_of_jax(tmp_path, writer):
    rng = np.random.default_rng(7)
    labels = None
    if writer == "estx":
        args, fn, jfn, labels = (_estx(rng, 3),), midi_io.estx_to_midi_file, \
            jax_midi_io.estx_to_midi_file, ["x", "y", "z"]
    elif writer.startswith("prmat"):
        pr = rng.integers(0, 40, (2, 32, 128)) * (rng.random((2, 32, 128)) < 0.05)
        if writer == "prmat_float":
            pr = pr + rng.normal(0, 0.3, pr.shape)
        args, fn, jfn = (pr,), midi_io.prmat_to_midi_file, jax_midi_io.prmat_to_midi_file
    else:
        chd = np.zeros((2, 8, 14), np.int64)
        chd[..., 0] = rng.integers(0, 12, (2, 8))
        chd[..., 1:13] = rng.integers(0, 2, (2, 8, 12))
        chd[..., 13] = rng.integers(0, 12, (2, 8))
        if writer == "chd36":
            chd = np.stack([jax_reprs.chd_to_onehot(c) for c in chd])
        args, fn, jfn = (chd,), midi_io.chd_to_midi_file, jax_midi_io.chd_to_midi_file
    kw = {"labels": labels} if labels else {}
    fn(*args, str(tmp_path / "port.mid"), **kw)
    jfn(*args, str(tmp_path / "jax.mid"), **kw)
    assert open(tmp_path / "port.mid", "rb").read() == open(tmp_path / "jax.mid", "rb").read()


def test_reprs_converters_match_jax():
    rng = np.random.default_rng(11)
    pt = _estx(rng, 1)[0]
    np.testing.assert_array_equal(reprs.pnotree_to_nmat(pt), jax_reprs.pnotree_to_nmat(pt))
    empty = np.full((4, 20, 6), 130, np.int64)
    assert reprs.pnotree_to_nmat(empty).shape == jax_reprs.pnotree_to_nmat(empty).shape == (0, 3)
    img = rng.random((3, 2, 64, 128)).astype(np.float32) * 1.2 - 0.1
    img[:, :, :, :100] = img[:, :, :, :100] > 0.8  # sparse binary part beside soft values
    got = reprs.prmat2c_to_prmat(img)
    want = jax_reprs.prmat2c_to_prmat(img)
    assert got.shape == (6, 32, 128) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(reprs.prmat2c_to_prmat(img, n_step=64),
                                  jax_reprs.prmat2c_to_prmat(img, n_step=64))
    for single in img:
        np.testing.assert_array_equal(reprs.prmat2c_to_nmat(single),
                                      jax_reprs.prmat2c_to_nmat(single))
    for custom in (False, True):
        np.testing.assert_array_equal(reprs._round_arr(img, custom),
                                      jax_reprs._round_arr(img, custom))


def test_nmat_from_midi_seconds_matches_jax_with_a_step(tmp_path):
    got, want = _read_both(write_case(tmp_path, "t", CASES["tempo_changes"]))
    for step in (0.125, 0.1, 0.3):
        np.testing.assert_array_equal(midi_io.nmat_from_midi_seconds(got, step),
                                      jax_midi_io.nmat_from_midi_seconds(want, step))
