"""The port's MIDI -> song data path (``data/midi_to_data.py``,
``SongNpz.from_dict``, ``prepare_data.py``) against the JAX package's on the
same MIDI files: every array exact."""

import os
import tempfile

import numpy as np
import pytest

from midi_cases import ev, hand_built_cases, meta, smf, tempo, time_sig, write_case, write_song
from polyffusion_tpu.data import midi_to_data as jax_m2d
from polyffusion_tpu.prepare_data import prepare_npz as jax_prepare_npz
from polyffusion_tpu.utils import midi as jax_midi
from polyffusion_tpu_torch.data import SegmentDataset, SongNpz
from polyffusion_tpu_torch.data import midi_to_data as m2d
from polyffusion_tpu_torch.prepare_data import main as prepare_main
from polyffusion_tpu_torch.prepare_data import prepare_npz
from polyffusion_tpu_torch.utils import midi

CASES = hand_built_cases()


def _assert_same_dict(got, want):
    if want is None:
        assert got is None
        return
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _extra_cases():
    """Files whose data dict is None in JAX: drums only (no notes); a meter
    change off the 16th grid (a fractional barline)."""
    drums = (ev(0, 0x99, 36, 100) + ev(240, 0x89, 36, 0)
             + ev(0, 0x99, 38, 100) + ev(240, 0x89, 38, 0))
    fractional = (tempo(0, 500000) + time_sig(0, 4, 2) + time_sig(1930, 3, 2)
                  + meta(0, 0x01, b"off grid"))
    notes = ev(0, 0x90, 60, 80) + ev(7680, 0x80, 60, 0)
    return {"drums_only": smf([tempo(0, 500000), drums]),
            "fractional_barline": smf([fractional, notes])}


ALL = dict(CASES, **_extra_cases())


@pytest.mark.parametrize("name", sorted(ALL))
def test_data_dict_matches_jax(tmp_path, name):
    path = write_case(tmp_path, name, ALL[name])
    for kw in ({}, {"melody_only": True}, {"force_length": True}):
        _assert_same_dict(m2d.get_data_for_single_midi(path, **kw),
                          jax_m2d.get_data_for_single_midi(path, **kw))
    if name in _extra_cases():
        assert m2d.get_data_for_single_midi(path) is None


def test_helpers_match_jax(tmp_path):
    path = write_case(tmp_path, "three_four", CASES["three_four"])
    got, want = midi.load_midi(path), jax_midi.load_midi(path)
    rows = m2d.get_note_matrix(got)
    assert rows == jax_m2d.get_note_matrix(want)
    assert m2d.dedup_note_matrix(rows + rows) == jax_m2d.dedup_note_matrix(rows + rows)
    assert m2d.get_downbeat_pos_and_filter(got) == jax_m2d.get_downbeat_pos_and_filter(want)
    np.testing.assert_array_equal(m2d.get_start_table(rows, 300),
                                  jax_m2d.get_start_table(rows, 300))
    assert m2d.force_length_to_8_bars(got) is got  # long enough already
    short = write_case(tmp_path, "sustain", CASES["sustain"])  # 4 bars
    got, want = midi.load_midi(short), jax_midi.load_midi(short)
    forced_got = m2d.force_length_to_8_bars(got)
    forced_want = jax_m2d.force_length_to_8_bars(want)
    assert forced_got.max_tick == forced_want.max_tick > got.max_tick
    assert m2d.get_note_matrix(forced_got) == jax_m2d.get_note_matrix(forced_want)


@pytest.mark.parametrize("tempo_change", [False, True])
def test_song_from_midi_matches_jax(tmp_path, monkeypatch, tempo_change):
    path = str(tmp_path / "song.mid")
    write_song(midi, path, n_bars=20, seed=4, tempo_change=tempo_change)
    (tmp_path / "tmp").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "tmp"))
    got = m2d.song_from_midi(path)
    assert not os.listdir(tmp_path / "tmp")  # the temporary chordlab is removed
    want = jax_m2d.song_from_midi(path)
    assert got.song_fn == want.song_fn == "song.mid" and len(got) == len(want) > 0
    for a, b in zip(got.get_whole_song_data(), want.get_whole_song_data()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # the chordlab written where asked, as in JAX
    lab = str(tmp_path / "song.lab")
    _assert_same_dict(m2d.get_data_for_single_midi(path, chdfile_path=lab),
                      jax_m2d.get_data_for_single_midi(path))
    assert os.path.getsize(lab)


def test_song_from_midi_refuses_what_jax_refuses(tmp_path):
    path = write_case(tmp_path, "drums_only", ALL["drums_only"])
    for fn in (m2d.song_from_midi, jax_m2d.song_from_midi):
        with pytest.raises(ValueError, match="downbeat"):
            fn(path)


def test_prepare_npz_matches_jax(tmp_path, capsys):
    midi_dir = tmp_path / "midis"
    (midi_dir / "sub").mkdir(parents=True)
    for i in range(2):
        write_song(midi, str(midi_dir / f"s{i}.mid"), n_bars=12, seed=10 + i, tempo_change=i == 1)
    write_song(midi, str(midi_dir / "sub" / "s2.MIDI"), n_bars=9, seed=12)
    write_case(midi_dir, "drums_only", ALL["drums_only"])
    (midi_dir / "broken.mid").write_bytes(b"not a midi")
    (midi_dir / "notes.txt").write_text("skipped")
    counts = prepare_npz(str(midi_dir), str(tmp_path / "port"))
    want_counts = jax_prepare_npz(str(midi_dir), str(tmp_path / "jax"))
    assert counts == want_counts == {"ok": 3, "downbeat_error": 1, "empty": 0, "read_error": 1}
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax")) == ["s0.npz", "s1.npz", "sub_s2.npz"]
    for fn in files:
        with np.load(tmp_path / "port" / fn) as got, np.load(tmp_path / "jax" / fn) as want:
            _assert_same_dict(dict(got), dict(want))
    # the port's dataset reads them, and the whole song is song_from_midi's
    ds = SegmentDataset.from_dir(str(tmp_path / "port"))
    assert len(ds) > 0 and ds[0][0].shape == (2, 128, 128)
    for a, b in zip(SongNpz("s1.npz", str(tmp_path / "port")).get_whole_song_data(),
                    m2d.song_from_midi(str(midi_dir / "s1.mid")).get_whole_song_data()):
        np.testing.assert_array_equal(a, b)
    # the CLI, with its flags
    prepare_main(["--midi_dir", str(midi_dir), "--npz_dir", str(tmp_path / "cli"),
                  "--melody_only", "--force_length"])
    assert "'ok': 3" in capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "cli")) == files


def test_from_dict_equals_the_saved_song(tmp_path):
    path = str(tmp_path / "song.mid")
    write_song(midi, path, n_bars=10, seed=5)
    data = m2d.get_data_for_single_midi(path)
    np.savez_compressed(tmp_path / "song.npz", **data)
    a, b = SongNpz.from_dict(data, song_fn="x"), SongNpz("song.npz", str(tmp_path))
    assert (a.song_fn, a.fpath) == ("x", "x") and len(a) == len(b)
    for u, v in zip(a.get_whole_song_data(), b.get_whole_song_data()):
        np.testing.assert_array_equal(u, v)
