"""Minimal Standard MIDI File writer with zero dependencies (the writing half
of the JAX package's ``utils/midi.py``, copied): format 1 with tempo, time
signature, program change, notes and lyric meta events. Note times are in
seconds (float), as in pretty_midi, which the reference used.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import List, Tuple

DEFAULT_TICKS_PER_BEAT = 480
DEFAULT_TEMPO_US = 500000  # 120 bpm


@dataclass
class Note:
    start: float  # seconds
    end: float  # seconds
    pitch: int
    velocity: int = 80


@dataclass
class Instrument:
    program: int = 0
    is_drum: bool = False
    name: str = ""
    notes: List[Note] = field(default_factory=list)


@dataclass
class TimeSignature:
    numerator: int
    denominator: int
    time: float  # seconds


@dataclass
class Lyric:
    text: str
    time: float


@dataclass
class MidiFile:
    ticks_per_beat: int = DEFAULT_TICKS_PER_BEAT
    instruments: List[Instrument] = field(default_factory=list)
    time_signatures: List[TimeSignature] = field(default_factory=list)
    lyrics: List[Lyric] = field(default_factory=list)


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
