"""Spans and counters of the port: what its threads did, and when.

A span is a named interval on one thread. ``span(name, rid=..., **attrs)`` is
a context manager; spans nest per thread, and each record keeps its parent
(the span that was open on the thread when it began). ``record(name,
start_ns, end_ns, ...)`` files an interval that began elsewhere, such as a
request's wait in the queue, which starts on the request's thread and ends on
the dispatcher's. Records go into a ring of ``RING`` records, the oldest
dropped first, and ``snapshot()`` reads them: recording is on by default, a
flight recorder of the last hours of a server. ``enable(False)`` makes a span
one attribute check.

The clock is ``time.time_ns()`` (CLOCK_REALTIME), the clock ``torch.profiler``
stamps its events with: an event's absolute time is ``origin_ns(prof)`` plus
its relative start. On a thread that ``torch.profiler`` is recording (the
profiler records host ranges only on the thread that entered it), a span also
opens ``torch.profiler.record_function(name)``, so that the program's spans
on that thread appear among the trace's host operations.

Counters live here too: ``register(name, owner, attr)`` names an attribute
that some object keeps counting (a kernel wrapper's ``launches``, the serving
worker's ``requests``), and ``counters()`` reads every live one by name.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from collections import deque
from typing import Dict, List, NamedTuple, Optional

import torch

RING = 1 << 17  # records kept: over three hours of the served cell's ~11 a second


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    thread: int  # threading.get_ident() of the thread that closed it
    sid: int
    parent: Optional[int]  # sid of the span open on that thread when it began
    rid: Optional[int]  # the request it belongs to, if one
    attrs: Optional[dict]

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


_ring: deque = deque(maxlen=RING)
_ring_lock = threading.Lock()
_sids = itertools.count(1)
_rids = itertools.count(1)
_local = threading.local()
_enabled = True
_profiling = torch._C._autograd._profiler_enabled  # per thread


def enable(on: bool = True) -> None:
    """Switch recording on or off for every thread."""
    global _enabled
    _enabled = bool(on)


def new_id() -> int:
    """A fresh request (or queue) id, increasing in the order of the calls."""
    return next(_rids)


def snapshot() -> List[Record]:
    """The records in the ring, oldest first."""
    with _ring_lock:
        return list(_ring)


def clear() -> None:
    with _ring_lock:
        _ring.clear()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _file(rec: Record) -> None:
    with _ring_lock:
        _ring.append(rec)


class span:
    """``with span("serve.pass", rows=32) as s:`` records the interval of the
    block on this thread; ``rid`` defaults to the enclosing span's, and
    ``s.attrs`` may gain keys inside the block."""

    __slots__ = ("name", "rid", "attrs", "sid", "parent", "start_ns", "_rf")

    def __init__(self, name: str, rid: Optional[int] = None, **attrs):
        self.name, self.rid, self.attrs = name, rid, attrs
        self.sid = None

    def __enter__(self) -> "span":
        if not _enabled:
            return self
        stack = _stack()
        top = stack[-1] if stack else None
        self.parent = top.sid if top is not None else None
        if self.rid is None and top is not None:
            self.rid = top.rid
        self.sid = next(_sids)
        stack.append(self)
        self._rf = None
        if _profiling():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.sid is None:
            return False
        end = time.time_ns()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _stack().pop()
        _file(Record(self.name, self.start_ns, end, threading.get_ident(), self.sid,
                     self.parent, self.rid, self.attrs or None))
        return False


def record(name: str, start_ns: int, end_ns: int, rid: Optional[int] = None, **attrs) -> None:
    """File an interval measured by hand (``time.time_ns()`` at both ends),
    under the span open on this thread."""
    if not _enabled:
        return
    stack = _stack()
    parent = stack[-1].sid if stack else None
    _file(Record(name, int(start_ns), int(end_ns), threading.get_ident(), next(_sids), parent,
                 rid, attrs or None))


def origin_ns(prof) -> int:
    """The ``time.time_ns()`` instant that a finished ``torch.profiler.profile``
    counts its events' relative microseconds from."""
    return int(prof.profiler.kineto_results.trace_start_ns())


# -- counters ---------------------------------------------------------------------

_counters: Dict[str, tuple] = {}


def register(name: str, owner, attr: str) -> None:
    """``counters()[name]`` reads ``owner.attr``; a later owner of the same
    name replaces the earlier, and a collected owner drops out."""
    _counters[name] = (weakref.ref(owner), attr)


def counters() -> Dict[str, object]:
    """Every registered counter with a live owner, by name."""
    out = {}
    for name, (ref, attr) in sorted(_counters.items()):
        owner = ref()
        if owner is not None:
            out[name] = getattr(owner, attr, None)
    return out
