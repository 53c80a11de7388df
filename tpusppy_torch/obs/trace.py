"""Structured trace ring buffer of spans.

A standard-library copy of the recording half of ``tpusppy/obs/trace.py``
(the spans ``spopt``/``phbase``/``hostsync`` emit).  Recording is
OFF by default; every record function checks one module flag first and the
disabled path allocates nothing, so instrumentation stays in hot paths.
Events are ``(t, tid, track, name, kind, dur, payload)`` tuples; ``track=None``
resolves to the calling thread's track (``"main"`` unless set).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import NamedTuple

DEFAULT_CAPACITY = 131072

_perf = time.perf_counter


class Event(NamedTuple):
    t: float            # perf_counter timestamp (seconds)
    tid: int            # OS thread ident at record time
    track: str          # logical timeline name
    name: str           # event name
    kind: str           # "span" or "instant"
    dur: float | None   # span duration (seconds); None otherwise
    payload: dict | None


_enabled = False
_buffer: collections.deque = collections.deque(maxlen=DEFAULT_CAPACITY)
_lock = threading.Lock()
_tls = threading.local()


def enabled() -> bool:
    return _enabled


def thread_track() -> str:
    return getattr(_tls, "track", None) or "main"


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def events() -> list:
    """Snapshot of the recorded events, oldest first."""
    with _lock:
        return list(_buffer)


def _add(ev: Event):
    with _lock:
        _buffer.append(ev)


class _NullSpan:
    """Shared no-op span: returned whenever tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **kw):
        pass


_NULL = _NullSpan()


class _Span:
    __slots__ = ("track", "name", "payload", "t0")

    def __init__(self, track, name, payload):
        self.track = track
        self.name = name
        self.payload = payload

    def __enter__(self):
        self.t0 = _perf()
        return self

    def add(self, **kw):
        """Attach payload discovered mid-span (recorded at exit)."""
        if self.payload is None:
            self.payload = {}
        self.payload.update(kw)

    def __exit__(self, *exc):
        if _enabled:
            _add(Event(self.t0, threading.get_ident(),
                       self.track or thread_track(), self.name, "span",
                       _perf() - self.t0, self.payload))
        return False


def span(track: str | None, name: str, **payload):
    """Context manager recording a duration event on ``track``."""
    if not _enabled:
        return _NULL
    return _Span(track, name, payload or None)


def instant(track: str | None, name: str, **payload):
    """Point event (a marker on the timeline)."""
    if not _enabled:
        return
    _add(Event(_perf(), threading.get_ident(), track or thread_track(), name,
               "instant", None, payload or None))


def record_span(track: str | None, name: str, t0: float, dur: float,
                payload: dict | None = None):
    """Record an already-timed span."""
    if not _enabled:
        return
    _add(Event(t0, threading.get_ident(), track or thread_track(), name,
               "span", dur, payload))
