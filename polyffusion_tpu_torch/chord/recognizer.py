"""Rule-based MIDI chord recognition: beat-grid chroma features + template DP decode
(a copy of the JAX package's ``chord/recognizer.py``).

Semantics follow the reference pipeline (``chord_extractor/midi_chord.py``,
``chord_extractor/main.py``, ``extractors/rule_based_channel_reweight.py``) with
vectorized NumPy feature building and decoding:

1. build a beat grid from the MIDI's beats/downbeats (the reference's effective
   grid is beat-level - see transcribe_midi);
2. per-channel-weighted note-overlap chroma per beat + sub-beat lowest-pitch bass
   chroma;
3. segment the grid by dynamic programming over segment lengths <= 12 beats
   scored against the 529-class template bank, with length/downbeat/even-beat
   bonuses, segments never crossing more than one downbeat;
4. emit ``(start_sec, end_sec, label)`` rows (chordlab format).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.midi import MidiFile, load_midi
from .encode import encode_to_absolute_row
from .templates import ChordTemplates

MAX_PREV = 12
SUBBEAT_COUNT = 8


# ---------------------------------------------------------------------------
# channel weighting (reference rule_based_channel_reweight.py)
# ---------------------------------------------------------------------------


def _is_percussive(instrument) -> bool:
    """Drums or high-program (>112, the GM percussive bank) channels are
    excluded from chord features (reference midi_utilities.py:172-175)."""
    return instrument.is_drum or instrument.program > 112


def _piano_roll(instrument, fs: int = 100) -> np.ndarray:
    """(frames, 128) roll with pretty_midi ``Instrument.get_piano_roll().T``
    semantics: velocity-summed notes, sustain-pedal (CC64) running-max
    extension, pitch-bend shifting — the reference's channel weights are
    computed from exactly this roll (rule_based_channel_reweight.py:35-48)."""
    if not instrument.notes:
        return np.zeros((0, 128))
    end = instrument.get_end_time()
    n_frames = int(fs * end)
    roll = np.zeros((128, n_frames))
    for n in instrument.notes:
        roll[n.pitch, int(n.start * fs) : int(n.end * fs)] += n.velocity

    # sustain pedal: within a pedal-down span each pitch retains its running max
    time_pedal_on = 0
    is_pedal_on = False
    for cc in instrument.control_changes:
        if cc.number != 64:
            continue
        time_now = int(cc.time * fs)
        is_down = cc.value >= 64
        if not is_pedal_on and is_down:
            time_pedal_on = time_now
            is_pedal_on = True
        elif is_pedal_on and not is_down:
            sub = roll[:, time_pedal_on:time_now]
            roll[:, time_pedal_on:time_now] = np.maximum.accumulate(sub, axis=1)
            is_pedal_on = False

    # pitch bends: shift the bent span by the (possibly fractional) semitone amount
    bends = sorted(instrument.pitch_bends, key=lambda b: b.time)
    for i, bend in enumerate(bends):
        if abs(bend.pitch) < 1:
            continue
        end_t = bends[i + 1].time if i + 1 < len(bends) else end
        semis = 2.0 * bend.pitch / 8192.0
        bend_int = int(np.sign(semis) * np.floor(np.abs(semis)))
        bend_dec = float(np.abs(semis - bend_int))
        rng = np.r_[int(bend.time * fs) : int(end_t * fs)]
        bent = np.zeros((128, rng.shape[0]))
        if bend.pitch >= 0:
            if bend_int != 0:
                bent[bend_int:] = roll[:-bend_int][:, rng]
            else:
                bent = roll[:, rng]
            bent[1:] = (1 - bend_dec) * bent[1:] + bend_dec * bent[:-1]
        else:
            if bend_int != 0:
                bent[:bend_int] = roll[-bend_int:][:, rng]
            else:
                bent = roll[:, rng]
            bent[:-1] = (1 - bend_dec) * bent[:-1] + bend_dec * bent[1:]
        roll[:, rng] = bent
    return roll.T


def _channel_thickness(roll: np.ndarray) -> float:
    if roll.shape[0] == 0:
        return 0.0
    chroma = np.zeros((roll.shape[0], 12))
    for note in range(12):
        chroma[:, note] = roll[:, note::12].sum(axis=1)
    thickness = (chroma > 0).sum(axis=1)
    if thickness.sum() == 0:
        return 0.0
    return float(thickness[thickness > 0].mean())


def _channel_bass_property(roll: np.ndarray) -> Tuple[float, float]:
    idx = np.argwhere(roll > 0)
    if len(idx) == 0:
        return 0.0, 1.0
    return float(idx[:, 1].mean()), min(1.0, len(idx) / max(len(roll), 1))


def thickness_and_bass_weights(midi: MidiFile) -> np.ndarray:
    """Per-non-percussive-channel chroma weights: thicker channels count more;
    the bassiest active channel is forced to weight 1 (reference :35-47)."""
    rolls = [_piano_roll(ins) for ins in midi.instruments if not _is_percussive(ins)]
    if not rolls:
        return np.array([])
    thickness = np.array([_channel_thickness(r) for r in rolls])
    bass = np.array([_channel_bass_property(r) for r in rolls])
    bass[bass[:, 1] < 0.2, 0] = 128
    weights = 1 - np.exp(-(thickness - 0.95))
    m = weights.max()
    if m > 0:
        weights = weights / m
    weights[np.argmin(bass[:, 0])] = 1.0
    return weights


# ---------------------------------------------------------------------------
# beat grid
# ---------------------------------------------------------------------------


def beat_grid(midi: MidiFile, extra_division: int = 2) -> np.ndarray:
    """(n_frame, 2) rows [time_sec, beat_pos] with beat_pos == 1 at downbeats
    (reference main.py:33-50); beats optionally subdivided."""
    beats = np.asarray(midi.get_beats(), dtype=float)
    if len(beats) < 2:
        raise ValueError("not enough beats in MIDI")
    if extra_division > 1:
        interp = np.linspace(beats[:-1], beats[1:], extra_division + 1).T
        last = interp[-1, -1]
        beats = np.append(interp[:, :-1].reshape(-1), last)
    downbeats = set(np.round(np.asarray(midi.get_downbeats()), 9).tolist())
    grid = []
    pos = -1
    for b in beats:
        if round(float(b), 9) in downbeats:
            pos = 1
        else:
            pos += 1
        if pos <= 0:
            # grid starts before the first downbeat; treat leading beats as pickup
            pos = 1
        grid.append([float(b), pos])
    return np.asarray(grid)


# ---------------------------------------------------------------------------
# recognition
# ---------------------------------------------------------------------------


class ChordRecognizer:
    def __init__(
        self,
        templates: Optional[ChordTemplates] = None,
        half_beat_switch: bool = True,
    ):
        self.templates = templates or ChordTemplates()
        self.half_beat_switch = half_beat_switch

    # -- features (reference midi_chord.py:20-107) ------------------------------

    def compute_features(self, midi: MidiFile, beat: np.ndarray, channel_weights):
        n_frame = len(beat)
        onset = beat[:, 0].copy()
        offset = np.empty(n_frame)
        offset[:-1] = onset[1:]
        offset[-1] = onset[-1] + (onset[-1] - onset[-2])
        length = np.empty(n_frame)
        length[:-1] = np.diff(onset)
        length[-1] = length[-2]

        def quantize(time: float) -> float:
            if time <= onset[0]:
                return 0.0
            if time >= offset[-1]:
                return float(n_frame)
            b = int(np.searchsorted(onset, time, side="right")) - 1
            return b + (time - onset[b]) / length[b]

        beat_chroma = np.zeros((n_frame, 12))
        min_subbeat_bass = np.full(n_frame * SUBBEAT_COUNT, 259, dtype=int)

        ch = 0
        for ins in midi.instruments:
            if _is_percussive(ins):
                continue
            w = channel_weights[ch]
            for note in ins.notes:
                bs, be = quantize(note.start), quantize(note.end)
                left_beat = int(np.floor(bs + 0.2))
                right_beat = int(np.ceil(be - 0.2))
                left_sub = int(np.floor(bs * SUBBEAT_COUNT + 0.2))
                right_sub = int(np.floor(be * SUBBEAT_COUNT + 0.2))
                if right_beat < left_beat:
                    right_beat = left_beat
                if right_sub > left_sub:
                    seg = min_subbeat_bass[left_sub:right_sub]
                    np.minimum(seg, note.pitch, out=seg)
                for j in range(left_beat, right_beat):
                    overlap = min(be, j + 1) - max(bs, j)
                    pc = note.pitch % 12
                    beat_chroma[j, pc] = max(beat_chroma[j, pc], overlap * w)
            ch += 1

        beat_bass = np.zeros((n_frame, 12))
        for i in range(SUBBEAT_COUNT):
            sub = min_subbeat_bass[i::SUBBEAT_COUNT]
            valid = sub < 259
            np.add.at(beat_bass, (np.nonzero(valid)[0], sub[valid] % 12), 1.0 / SUBBEAT_COUNT)

        pos = beat[:, 1]
        return {
            "chroma": beat_chroma,
            "bass": beat_bass,
            "onset": onset,
            "offset": offset,
            "is_downbeat": pos == 1,
            "is_halfdownbeat": pos * 2 - 2 == pos.max(),
            "is_even_beat": pos % 2 == 1,
        }

    # -- DP decode (reference midi_chord.py:109-190), vectorized over classes/lags

    def decode(self, feats) -> List[Tuple[float, float, str]]:
        chroma, bass = feats["chroma"], feats["bass"]
        n_frame = len(chroma)
        n_class = len(self.templates)

        # windowed sums via cumulative sums: window (i-j..i)
        cum_c = np.vstack([np.zeros(12), np.cumsum(chroma, axis=0)])
        cum_b = np.vstack([np.zeros(12), np.cumsum(bass, axis=0)])
        i_idx = np.arange(n_frame)[:, None]
        j_idx = np.arange(MAX_PREV)[None, :]
        lo = np.maximum(i_idx - j_idx, 0)
        valid = i_idx - j_idx >= 0
        win_c = cum_c[i_idx + 1] - cum_c[lo]  # (n_frame, MAX_PREV, 12)
        win_b = cum_b[i_idx + 1] - cum_b[lo]

        scores = self.templates.batch_score(
            win_c.reshape(-1, 12), win_b.reshape(-1, 12)
        ).reshape(n_frame, MAX_PREV, n_class)

        start = np.maximum(i_idx - j_idx, 0)
        bonus = (
            j_idx * 0.7
            + feats["is_halfdownbeat"][start] * 0.15
            + feats["is_even_beat"][start] * 0.2
        )
        obs = np.where(valid, scores.max(axis=2) + bonus, -np.inf)
        best_c = scores.argmax(axis=2)

        # allowed segment length per i: j stops after the first j>0 whose segment
        # start is preceded by a downbeat (reference :160-161 break)
        is_db = feats["is_downbeat"]
        dp = np.full(n_frame + 1, -np.inf)
        dp[0] = 0.0
        prei = np.zeros(n_frame, dtype=int)
        prec = np.zeros(n_frame, dtype=int)
        for i in range(n_frame):
            max_j = min(i, MAX_PREV - 1)
            j_stop = max_j
            for j in range(1, max_j + 1):
                if is_db[i - j + 1]:
                    j_stop = j
                    break
            js = np.arange(j_stop + 1)
            cand = dp[i - js] + obs[i, js]
            j_best = int(np.argmax(cand))
            dp[i + 1] = cand[j_best]
            prei[i] = i - j_best - 1
            prec[i] = best_c[i, j_best]

        onset, offset = feats["onset"], feats["offset"]
        is_even = feats["is_even_beat"]
        result = []
        cur = n_frame - 1
        while cur >= 0:
            pi, pc = int(prei[cur]), int(prec[cur])
            s = pi + 1 if self.half_beat_switch or is_even[pi + 1] else pi + 2
            e = (
                cur
                if self.half_beat_switch or cur == n_frame - 1 or is_even[cur + 1]
                else cur + 1
            )
            result.append((onset[s], offset[e], self.templates.chord_list[pc]))
            cur = pi
        return result[::-1]

    def recognize(self, midi: MidiFile, extra_division: int = 2):
        beat = beat_grid(midi, extra_division)
        weights = thickness_and_bass_weights(midi)
        feats = self.compute_features(midi, beat, weights)
        return self.decode(feats)


# ---------------------------------------------------------------------------
# chordlab IO + public API (reference chord_extractor/__init__.py)
# ---------------------------------------------------------------------------


def write_chordlab(rows: Sequence[Tuple[float, float, str]], fpath: str) -> None:
    with open(fpath, "w") as f:
        for start, end, label in rows:
            f.write(f"{start}\t{end}\t{label}\n")


def read_chordlab(fpath: str) -> List[Tuple[float, float, str]]:
    rows = []
    with open(fpath) as f:
        for line in f:
            if line.strip():
                s, e, lab = line.rstrip("\n").split("\t")
                rows.append((float(s), float(e), lab))
    return rows


def transcribe_midi(midi_path: str, output_path: Optional[str] = None):
    """Recognize chords in a MIDI file; optionally write a chordlab file
    (reference ``transcribe_cb1000_midi``, main.py:58-69).

    The effective frame grid is BEAT-level (extra_division=1): the reference's
    ``process_chord`` builds a half-beat grid locally but ``ChordRecognition``
    reads ``entry.beat`` — the MidiBeatExtractor proxy output with its default
    ``div=1`` (midi_utilities.py:14, main.py:34-53) — so the half-beat grid is
    dead code and the shipped golden output (chord_extractor/example.out) is
    beat-level.  Verified by exact-parity against that golden file in
    tests/test_chord_golden.py."""
    midi = load_midi(midi_path)
    rows = ChordRecognizer().recognize(midi, extra_division=1)
    if output_path:
        write_chordlab(rows, output_path)
    return rows


def chord_matrix_from_chordlab(
    rows: Sequence[Tuple[float, float, str]], one_beat: float = 0.5, rounding: bool = True
) -> np.ndarray:
    """Chordlab rows -> (M, 14) beat-level chord matrix
    (reference ``get_chord_from_chdfile``, chord_extractor/__init__.py:10-46)."""
    out = []
    for start, end, label in rows:
        n = round((end - start) / one_beat) if rounding else int((end - start) / one_beat)
        row = encode_to_absolute_row(label)
        out.extend([row] * int(n))
    return np.array(out, dtype=np.float32)


def extract_chords_from_midi_file(fpath: str, chdfile_path: str) -> np.ndarray:
    """MIDI -> chordlab file -> (M, 14) chord matrix (reference __init__.py:49-51)."""
    rows = transcribe_midi(fpath, chdfile_path)
    return chord_matrix_from_chordlab(read_chordlab(chdfile_path))
