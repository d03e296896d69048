"""Minimal Standard MIDI File (SMF) reader/writer with zero dependencies (a
copy of the JAX package's ``utils/midi.py``).

The reference relies on ``pretty_midi``/``muspy`` for MIDI IO; neither is a
dependency here, so the small subset of SMF the port needs is implemented
directly:

- format 0/1 read with running status, tempo map, time signatures, note pairing;
- format 1 write with tempo, program change, notes, and lyric meta events;
- beat / downbeat grids equivalent to ``pretty_midi.get_beats()/get_downbeats()``
  for the metric structure used by the chord extractor and data preparation.

All note times are in seconds (float), matching pretty_midi conventions. Seconds
come from ticks by summing over the tempo map in the JAX package's order, so
both packages read the same floats, bit for bit.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

DEFAULT_TICKS_PER_BEAT = 480
DEFAULT_TEMPO_US = 500000  # 120 bpm


@dataclass
class Note:
    start: float  # seconds
    end: float  # seconds
    pitch: int
    velocity: int = 80
    start_tick: int = -1  # populated by load_midi for exact grid quantization
    end_tick: int = -1


@dataclass
class ControlChange:
    number: int
    value: int
    time: float  # seconds


@dataclass
class PitchBend:
    pitch: int  # signed, -8192..8191 (pretty_midi convention)
    time: float  # seconds


@dataclass
class Instrument:
    program: int = 0
    is_drum: bool = False
    name: str = ""
    notes: List[Note] = field(default_factory=list)
    control_changes: List[ControlChange] = field(default_factory=list)
    pitch_bends: List[PitchBend] = field(default_factory=list)

    def get_end_time(self) -> float:
        """Latest note-off / CC / pitch-bend time (pretty_midi Instrument semantics)."""
        events = (
            [n.end for n in self.notes]
            + [c.time for c in self.control_changes]
            + [b.time for b in self.pitch_bends]
        )
        return max(events, default=0.0)


@dataclass
class TimeSignature:
    numerator: int
    denominator: int
    time: float  # seconds
    tick: int = 0


@dataclass
class TempoChange:
    tempo_us_per_beat: int
    tick: int
    time: float = 0.0


@dataclass
class Lyric:
    text: str
    time: float


@dataclass
class MidiFile:
    ticks_per_beat: int = DEFAULT_TICKS_PER_BEAT
    instruments: List[Instrument] = field(default_factory=list)
    tempo_changes: List[TempoChange] = field(default_factory=list)
    time_signatures: List[TimeSignature] = field(default_factory=list)
    lyrics: List[Lyric] = field(default_factory=list)
    max_tick: int = 0
    # last control-change / pitch-bend / stored-meta time (seconds); pretty_midi's
    # get_end_time() includes these, and the chord extractor's beat grid runs to
    # that end (a trailing CC fade after the last note extends the beats)
    event_end_time: float = 0.0

    # -- metric structure ---------------------------------------------------

    def get_end_time(self) -> float:
        note_end = max((n.end for ins in self.instruments for n in ins.notes), default=0.0)
        return max(note_end, self.event_end_time)

    def _tempo_at(self) -> List[TempoChange]:
        if not self.tempo_changes:
            return [TempoChange(DEFAULT_TEMPO_US, 0, 0.0)]
        return self.tempo_changes

    def get_beats(self) -> List[float]:
        """Beat times in seconds, meter-aware (beat = whole-note / denominator)."""
        end = self.get_end_time()
        sigs = list(self.time_signatures) or [TimeSignature(4, 4, 0.0)]
        if sigs[0].time > 0.0:
            sigs = [TimeSignature(4, 4, 0.0)] + sigs
        beats: List[float] = []
        tempos = self._tempo_at()

        def sec_per_quarter(t: float) -> float:
            cur = tempos[0].tempo_us_per_beat
            for tc in tempos:
                if tc.time <= t + 1e-9:
                    cur = tc.tempo_us_per_beat
                else:
                    break
            return cur / 1e6

        for i, sig in enumerate(sigs):
            seg_end = sigs[i + 1].time if i + 1 < len(sigs) else end
            t = sig.time
            beat_quarters = 4.0 / sig.denominator
            while t < seg_end - 1e-9:
                beats.append(t)
                t += sec_per_quarter(t) * beat_quarters
        return beats

    def get_downbeats(self) -> List[float]:
        """Downbeat times: every ``numerator`` beats within each time-signature span."""
        end = self.get_end_time()
        sigs = list(self.time_signatures) or [TimeSignature(4, 4, 0.0)]
        if sigs[0].time > 0.0:
            sigs = [TimeSignature(4, 4, 0.0)] + sigs
        beats = self.get_beats()
        downbeats: List[float] = []
        for i, sig in enumerate(sigs):
            seg_end = sigs[i + 1].time if i + 1 < len(sigs) else end
            seg_beats = [b for b in beats if sig.time - 1e-9 <= b < seg_end - 1e-9]
            downbeats.extend(seg_beats[:: max(sig.numerator, 1)])
        return downbeats


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


def _read_varlen(data: bytes, pos: int) -> Tuple[int, int]:
    value = 0
    while True:
        b = data[pos]
        pos += 1
        value = (value << 7) | (b & 0x7F)
        if not (b & 0x80):
            return value, pos


def load_midi(fpath: str) -> MidiFile:
    with open(fpath, "rb") as f:
        data = f.read()
    if data[:4] != b"MThd":
        raise ValueError(f"not a MIDI file: {fpath}")
    hdr_len = struct.unpack(">I", data[4:8])[0]
    fmt, n_tracks, division = struct.unpack(">HHH", data[8:14])
    if division & 0x8000:
        raise ValueError("SMPTE time division is not supported")
    pos = 8 + hdr_len

    midi = MidiFile(ticks_per_beat=division)
    raw_tracks = []
    for _ in range(n_tracks):
        if data[pos : pos + 4] != b"MTrk":
            # skip unknown chunk
            chunk_len = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
            pos += 8 + chunk_len
            continue
        length = struct.unpack(">I", data[pos + 4 : pos + 8])[0]
        raw_tracks.append(data[pos + 8 : pos + 8 + length])
        pos += 8 + length

    tempo_events: List[TempoChange] = []
    ts_events: List[Tuple[int, int, int]] = []  # (tick, num, den)
    lyric_events: List[Tuple[int, str]] = []
    # per (track, channel): instrument events
    track_events = []  # list of (tick, kind, ch, a, b) per track
    max_tick = 0
    # max tick of events pretty_midi counts toward get_end_time(): control
    # changes, pitch bends, and stored meta (time/key signature, lyric, text)
    event_end_tick = 0

    for raw in raw_tracks:
        p = 0
        tick = 0
        status = 0
        events = []
        while p < len(raw):
            delta, p = _read_varlen(raw, p)
            tick += delta
            b0 = raw[p]
            if b0 == 0xFF:  # meta
                meta_type = raw[p + 1]
                mlen, q = _read_varlen(raw, p + 2)
                payload = raw[q : q + mlen]
                p = q + mlen
                if meta_type == 0x51 and mlen == 3:
                    tempo_events.append(
                        TempoChange(int.from_bytes(payload, "big"), tick)
                    )
                elif meta_type == 0x58 and mlen >= 2:
                    ts_events.append((tick, payload[0], 1 << payload[1]))
                    event_end_tick = max(event_end_tick, tick)
                elif meta_type == 0x05:
                    lyric_events.append((tick, payload.decode("latin-1", "replace")))
                    event_end_tick = max(event_end_tick, tick)
                elif meta_type in (0x01, 0x59):  # text / key signature
                    event_end_tick = max(event_end_tick, tick)
                elif meta_type == 0x2F:
                    break
            elif b0 in (0xF0, 0xF7):  # sysex
                slen, q = _read_varlen(raw, p + 1)
                p = q + slen
            else:
                if b0 & 0x80:
                    status = b0
                    p += 1
                kind = status & 0xF0
                ch = status & 0x0F
                if kind in (0x80, 0x90, 0xA0, 0xB0, 0xE0):
                    a, b = raw[p], raw[p + 1]
                    p += 2
                    events.append((tick, kind, ch, a, b))
                    if kind in (0xB0, 0xE0):
                        event_end_tick = max(event_end_tick, tick)
                elif kind in (0xC0, 0xD0):
                    a = raw[p]
                    p += 1
                    events.append((tick, kind, ch, a, 0))
        max_tick = max(max_tick, tick)
        track_events.append(events)

    # tick -> seconds mapping from the tempo map
    tempo_events.sort(key=lambda tc: tc.tick)
    if not tempo_events or tempo_events[0].tick > 0:
        tempo_events.insert(0, TempoChange(DEFAULT_TEMPO_US, 0))

    boundaries = []
    t_sec = 0.0
    for i, tc in enumerate(tempo_events):
        if i > 0:
            prev = tempo_events[i - 1]
            t_sec += (tc.tick - prev.tick) * prev.tempo_us_per_beat / 1e6 / division
        tc.time = t_sec
        boundaries.append((tc.tick, t_sec, tc.tempo_us_per_beat))

    def tick_to_sec(tick: int) -> float:
        lo = 0
        for btick, bsec, tempo in boundaries:
            if btick <= tick:
                lo_tick, lo_sec, lo_tempo = btick, bsec, tempo
            else:
                break
        return lo_sec + (tick - lo_tick) * lo_tempo / 1e6 / division

    midi.tempo_changes = tempo_events
    midi.time_signatures = [
        TimeSignature(num, den, tick_to_sec(tk), tk) for tk, num, den in sorted(ts_events)
    ]
    midi.lyrics = [Lyric(text, tick_to_sec(tk)) for tk, text in sorted(lyric_events)]
    midi.max_tick = max_tick
    midi.event_end_time = tick_to_sec(event_end_tick)

    # assemble instruments: one per (track, channel, program-at-first-note);
    # control changes / pitch bends attach to the same (channel, program) bucket
    # so pretty_midi-style piano rolls (sustain pedal, bends) can be rebuilt
    for events in track_events:
        per_channel_program = {}
        instruments = {}
        active = {}  # (ch, pitch) -> (tick, velocity)

        def bucket(ch):
            prog = per_channel_program.get(ch, 0)
            key = (ch, prog)
            if key not in instruments:
                instruments[key] = Instrument(program=prog, is_drum=(ch == 9))
            return instruments[key]

        for tick, kind, ch, a, b in sorted(events, key=lambda e: e[0]):
            if kind == 0xC0:
                per_channel_program[ch] = a
            elif kind == 0x90 and b > 0:
                active.setdefault((ch, a), []).append((tick, b))
            elif kind == 0x80 or (kind == 0x90 and b == 0):
                # pretty_midi pairing: one note-off closes ALL open notes of
                # this pitch except ones that started on the same tick — and
                # those stay open ONLY when the off also closed something;
                # otherwise pretty_midi drops them (zero-length notes from
                # quantized exports are silently discarded, never left open)
                stack = active.get((ch, a))
                if stack:
                    keep = [(t, v) for t, v in stack if t == tick]
                    ins = bucket(ch)
                    for on_tick, vel in stack:
                        if on_tick != tick:
                            ins.notes.append(
                                Note(
                                    tick_to_sec(on_tick), tick_to_sec(tick), a, vel, on_tick, tick
                                )
                            )
                    if keep and len(keep) != len(stack):
                        active[(ch, a)] = keep
                    else:
                        del active[(ch, a)]
            elif kind == 0xB0:
                bucket(ch).control_changes.append(ControlChange(a, b, tick_to_sec(tick)))
            elif kind == 0xE0:
                bucket(ch).pitch_bends.append(
                    PitchBend(((b << 7) | a) - 8192, tick_to_sec(tick))
                )
        for ins in instruments.values():
            ins.notes.sort(key=lambda n: (n.start, n.pitch))
            if ins.notes:
                midi.instruments.append(ins)
    return midi


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _varlen(value: int) -> bytes:
    buf = [value & 0x7F]
    value >>= 7
    while value:
        buf.append((value & 0x7F) | 0x80)
        value >>= 7
    return bytes(reversed(buf))


def _track_chunk(events: List[Tuple[int, bytes]]) -> bytes:
    events.sort(key=lambda e: e[0])
    out = bytearray()
    last = 0
    for tick, payload in events:
        out += _varlen(tick - last)
        out += payload
        last = tick
    out += _varlen(0) + b"\xff\x2f\x00"
    return b"MTrk" + struct.pack(">I", len(out)) + bytes(out)


def save_midi(
    midi: MidiFile,
    fpath: str,
    tempo_us_per_beat: int = DEFAULT_TEMPO_US,
) -> None:
    """Write a format-1 SMF. Seconds -> ticks assumes the single given tempo."""
    tpb = midi.ticks_per_beat
    sec_to_tick = lambda s: int(round(s * 1e6 / tempo_us_per_beat * tpb))  # noqa: E731

    meta_events: List[Tuple[int, bytes]] = [
        (0, b"\xff\x51\x03" + tempo_us_per_beat.to_bytes(3, "big"))
    ]
    for sig in midi.time_signatures or [TimeSignature(4, 4, 0.0)]:
        den_pow = max(sig.denominator, 1).bit_length() - 1
        meta_events.append(
            (sec_to_tick(sig.time), bytes([0xFF, 0x58, 0x04, sig.numerator, den_pow, 24, 8]))
        )
    for lyric in midi.lyrics:
        text = lyric.text.encode("latin-1", "replace")
        meta_events.append(
            (sec_to_tick(lyric.time), b"\xff\x05" + _varlen(len(text)) + text)
        )

    chunks = [_track_chunk(meta_events)]
    next_channel = 0
    for ins in midi.instruments:
        ch = 9 if ins.is_drum else next_channel
        if not ins.is_drum:
            next_channel += 1
            if next_channel == 9:
                next_channel += 1
            next_channel %= 16
        events: List[Tuple[int, bytes]] = [
            (0, bytes([0xC0 | ch, ins.program & 0x7F]))
        ]
        for n in ins.notes:
            on, off = sec_to_tick(n.start), sec_to_tick(n.end)
            if off <= on:
                off = on + 1
            events.append((on, bytes([0x90 | ch, n.pitch & 0x7F, max(1, min(127, n.velocity))])))
            events.append((off, bytes([0x80 | ch, n.pitch & 0x7F, 0])))
        chunks.append(_track_chunk(events))

    with open(fpath, "wb") as f:
        f.write(b"MThd" + struct.pack(">IHHH", 6, 1, len(chunks), tpb))
        for c in chunks:
            f.write(c)
