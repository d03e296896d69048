"""Song datasets over the npz format (host-side NumPy; a copy of the JAX
package's ``data/dataset.py``: training items, and whole songs for inference
from an npz file or from a MIDI file's data dict).

The npz song format matches the reference's (``data/dataset.py:27-252``):

    notes        per-track object array of (onset_bin, pitch, duration, ...) rows
                 (3 tracks for POP909: melody, bridge, piano), or a single (N, >=3)
                 array for single-track corpora
    start_table  per-track array mapping beat-bin -> first row index in ``notes``
    db_pos       downbeat bin positions
    db_pos_filter boolean mask of downbeats that start a complete 8-bar 4/4 run
    chord        (n_beat, 14) chord matrix [root, chroma x 12, bass]

Each item is an 8-bar segment: ``(prmat2c (2,128,128), pnotree (128,20,6),
chord (32,14), prmat (128,128))``.  Per-downbeat conversions are cached lazily.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.reprs import chd_to_onehot, nmat_to_pianotree_repr, nmat_to_prmat, nmat_to_prmat2c

SEG_LGTH = 32  # beats per segment (8 bars of 4/4)
N_BIN = 4  # 16th-note bins per beat
SEG_LGTH_BIN = SEG_LGTH * N_BIN  # 128 steps


class SongNpz:
    """One song loaded from .npz with lazily cached per-downbeat segments."""

    def __init__(self, song_fn: str, data_dir: str, use_track: Sequence[int] = (0, 1, 2)):
        self.song_fn = song_fn
        self.fpath = os.path.join(data_dir, song_fn)
        data = np.load(self.fpath, allow_pickle=True)
        self._setup(data, use_track)

    @classmethod
    def from_dict(cls, data: dict, song_fn: str = "<memory>", use_track=(0, 1, 2)):
        """Build from an in-memory data dict (the --from_midi inference path,
        reference ``data/datasample.py``)."""
        self = cls.__new__(cls)
        self.song_fn = song_fn
        self.fpath = song_fn
        self._setup(data, use_track)
        return self

    def _setup(self, data, use_track: Sequence[int]):
        self.use_track = list(use_track)
        notes = np.asarray(data["notes"], dtype=object) if np.asarray(
            data["notes"]
        ).dtype == object else np.asarray(data["notes"])
        self.notes = notes
        self.start_table = np.asarray(data["start_table"])
        db_pos = np.asarray(data["db_pos"])
        self.db_pos = db_pos[np.asarray(data["db_pos_filter"])]
        if "chord" in data and np.asarray(data["chord"]).size:
            self.chord = np.asarray(data["chord"]).astype(np.int32)
        else:
            # chord-less corpora (e.g. musicalion solo piano,
            # reference data/dataset_musicalion.py): zero placeholder rows
            n_beats = (int(db_pos[-1]) // N_BIN + SEG_LGTH) if len(db_pos) else SEG_LGTH
            self.chord = np.zeros((n_beats, 14), np.int32)
        self._multitrack = self.start_table.ndim > 0 and self.start_table.dtype == object
        self._cache: Dict[int, Tuple[np.ndarray, ...]] = {}

    def __len__(self) -> int:
        return len(self.db_pos)

    # -- segment extraction -------------------------------------------------

    def _seg_nmat_at_db(self, db: int) -> np.ndarray:
        """Notes with onsets in [db, db + 128), onset rebased to 0 (cols o, p, d)."""

        def lookup(table, key):
            # start tables are dense arrays (write_song_npz) or per-downbeat
            # dicts (the reference POP909 conversion, polydis_format_to_mine.py)
            if isinstance(table, dict):
                return int(table[key]) if key in table else None
            return int(table[key]) if key < len(table) else None

        def one_track(notes, start_table):
            s = lookup(start_table, db)
            e = lookup(start_table, db + SEG_LGTH_BIN)
            notes = np.asarray(notes)
            seg = np.asarray(notes[s:e] if e is not None else notes[s:])
            return seg.reshape(-1, seg.shape[-1]) if seg.size else np.zeros((0, 5))

        if self._multitrack:
            mats = [one_track(self.notes[t], self.start_table[t]) for t in self.use_track]
            seg = np.concatenate(mats, axis=0) if mats else np.zeros((0, 5))
        else:
            seg = one_track(self.notes, self.start_table)
        out = np.zeros((len(seg), 3), dtype=np.int64)
        if len(seg):
            out[:, 0] = seg[:, 0] - db
            out[:, 1] = seg[:, 1]
            out[:, 2] = seg[:, 2]
        return out

    def _get_item_by_db(self, db: int):
        if db not in self._cache:
            nmat = self._seg_nmat_at_db(db)
            prmat2c = nmat_to_prmat2c(nmat, SEG_LGTH_BIN)
            prmat = nmat_to_prmat(nmat, SEG_LGTH_BIN)
            pnotree = nmat_to_pianotree_repr(nmat, n_step=SEG_LGTH_BIN)
            chord = self.chord[db // N_BIN : db // N_BIN + SEG_LGTH]
            if chord.shape[0] < SEG_LGTH:
                chord = np.concatenate(
                    [chord, np.zeros((SEG_LGTH - chord.shape[0], 14), np.int32)], axis=0
                )
            self._cache[db] = (prmat2c, pnotree, chord, prmat)
        return self._cache[db]

    def __getitem__(self, idx: int):
        return self._get_item_by_db(int(self.db_pos[idx]))

    def get_whole_song_data(self):
        """Non-overlapping 8-bar segments for whole-song inference
        (reference ``dataset.py:227-252``); chord is one-hot (32, 36)."""
        prmat2c, pnotree, chord, prmat = [], [], [], []
        idx, i = 0, 0
        while i < len(self):
            p2c, pt, chd, pr = self[i]
            prmat2c.append(p2c)
            pnotree.append(pt)
            chord.append(chd_to_onehot(chd))
            prmat.append(pr)
            idx += SEG_LGTH_BIN
            while i < len(self) and self.db_pos[i] < idx:
                i += 1
        return (
            np.array(prmat2c, np.float32),
            np.array(pnotree, np.int64),
            np.array(chord, np.float32),
            np.array(prmat, np.float32),
        )


class SegmentDataset:
    """Concatenation of songs with cumulative-length indexing
    (reference ``PianoOrchDataset``, ``data/dataset.py:255-307``)."""

    def __init__(self, songs: List[SongNpz]):
        self.songs = songs
        lengths = np.array([len(s) for s in songs], np.int64)
        self.cumsum = np.cumsum(lengths)

    def __len__(self) -> int:
        return int(self.cumsum[-1]) if len(self.songs) else 0

    def __getitem__(self, index: int):
        song_no = int(np.searchsorted(self.cumsum, index, side="right"))
        prev = int(self.cumsum[song_no - 1]) if song_no else 0
        return self.songs[song_no][index - prev]

    # -- constructors ---------------------------------------------------------

    @classmethod
    def from_dir(
        cls,
        data_dir: str,
        song_fns: Optional[Sequence[str]] = None,
        use_track: Sequence[int] = (0, 1, 2),
    ) -> "SegmentDataset":
        if song_fns is None:
            song_fns = sorted(f for f in os.listdir(data_dir) if f.endswith(".npz"))
        return cls([SongNpz(fn, data_dir, use_track) for fn in song_fns])

    @classmethod
    def train_val_from_split(
        cls, data_dir: str, split_path: str, use_track: Sequence[int] = (0, 1, 2)
    ):
        """Load (train, val) via a pickled (train_list, val_list) split file
        (reference ``data/train_split_pnt/pop909.pickle``)."""
        with open(split_path, "rb") as f:
            split = pickle.load(f)
        return (
            cls.from_dir(data_dir, split[0], use_track),
            cls.from_dir(data_dir, split[1], use_track),
        )

    @classmethod
    def train_val_from_dir(
        cls,
        data_dir: str,
        train_ratio: float = 0.9,
        use_track: Sequence[int] = (0, 1, 2),
    ):
        """Deterministic ratio split over a directory of npz songs
        (reference ``get_custom_train_val_dataloaders``, ``data/dataloader.py:69-109``)."""
        all_fns = sorted(f for f in os.listdir(data_dir) if f.endswith(".npz"))
        n_train = int(len(all_fns) * train_ratio)
        return (
            cls.from_dir(data_dir, all_fns[:n_train], use_track),
            cls.from_dir(data_dir, all_fns[n_train:], use_track),
        )


def write_song_npz(
    path: str,
    notes_per_track: Sequence[np.ndarray],
    chord: np.ndarray,
    db_pos: np.ndarray,
    db_pos_filter: np.ndarray,
    n_beats: Optional[int] = None,
) -> None:
    """Write a song npz in the standard format; builds start_tables from notes."""
    n_beats = n_beats if n_beats is not None else len(chord)
    n_bins = n_beats * N_BIN
    start_tables = []
    for notes in notes_per_track:
        notes = np.asarray(notes)
        onsets = notes[:, 0] if len(notes) else np.zeros(0, np.int64)
        table = np.searchsorted(onsets, np.arange(n_bins + 1))
        start_tables.append(table)
    single = len(notes_per_track) == 1
    np.savez_compressed(
        path,
        notes=np.asarray(notes_per_track[0])
        if single
        else np.array([np.asarray(t) for t in notes_per_track], dtype=object),
        start_table=start_tables[0]
        if single
        else np.array(start_tables, dtype=object),
        db_pos=db_pos,
        db_pos_filter=db_pos_filter,
        chord=chord,
    )
