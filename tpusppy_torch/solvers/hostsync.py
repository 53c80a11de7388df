"""Host-sync accounting for device-to-host fetches.

Every fetch the solve loop makes on a decision path (the packed per-solve
measurement, the straggler rescue's aux state, the device sweep loop's stop
flag) goes through :func:`fetch` or :func:`fetch_async`, so the traffic is
observable: ``host_sync.count`` counts fetches and ``host_sync.fetch_secs``
the host time spent blocked in them.  A fetch marked ``overlapped`` resolves
while further device work is already queued (the device sweep loop reads a
replay's stop flag with the next replay in flight): the host still blocks,
the device does not, so only the other fetches' time counts in
``host_sync.blocked_secs``, and ``host_sync.overlapped`` counts the rest.

Trackers opened with :func:`track` count the fetches of the calling thread
alone (``tpusppy/solvers/hostsync.py``): the cylinders of a wheel run on
threads of their own, so each one's fetches land only in its own trackers.
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs import trace as _trace

_CTR_COUNT = _metrics.counter("host_sync.count")
_CTR_OVERLAPPED = _metrics.counter("host_sync.overlapped")
_CTR_BLOCKED = _metrics.counter("host_sync.blocked_secs")
_CTR_FETCH = _metrics.counter("host_sync.fetch_secs")

_local = threading.local()


def _stack():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class SyncTracker:
    """Counts one thread's fetches and the host time spent in them;
    ``blocked_secs`` only that of the fetches not ``overlapped``."""

    def __init__(self):
        self.count = 0
        self.overlapped = 0
        self.blocked_secs = 0.0
        self.fetch_secs = 0.0

    def add(self, secs: float, overlapped: bool):
        self.count += 1
        self.fetch_secs += secs
        if overlapped:
            self.overlapped += 1
        else:
            self.blocked_secs += secs


@contextlib.contextmanager
def track():
    """Open a tracker for the calling thread; trackers nest (a fetch lands
    in every tracker its thread has open, and in no other thread's)."""
    t = SyncTracker()
    _stack().append(t)
    try:
        yield t
    finally:
        _stack().remove(t)


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return np.array(x.detach().cpu(), copy=True)
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    return np.asarray(x)


def _bill(t0, overlapped):
    dt = time.perf_counter() - t0
    for tr in _stack():
        tr.add(dt, overlapped)
    _CTR_COUNT.inc(1)
    _CTR_FETCH.inc(dt)
    if overlapped:
        _CTR_OVERLAPPED.inc(1)
    else:
        _CTR_BLOCKED.inc(dt)
    if _trace.enabled():
        _trace.record_span("host-sync", "fetch", t0, dt,
                           {"overlapped": overlapped})


def fetch(x, overlapped: bool = False):
    """Device-to-host copy of a tensor (or a tuple of them) as numpy,
    counted as ONE host sync.  numpy inputs pass through as arrays."""
    t0 = time.perf_counter()
    out = _to_host(x)
    _bill(t0, overlapped)
    return out


class Pending:
    """A device-to-host copy in flight (:func:`fetch_async`)."""

    __slots__ = ("_host", "_event")

    def __init__(self, host, event):
        self._host = host
        self._event = event

    def result(self, overlapped: bool = False) -> np.ndarray:
        """Wait for the copy and return it as numpy, counted as ONE host
        sync (``overlapped``: device work queued after the copy runs on
        while the host waits)."""
        t0 = time.perf_counter()
        if self._event is not None:
            self._event.synchronize()
        out = self._host.numpy().copy()
        _bill(t0, overlapped)
        return out


def fetch_async(x: torch.Tensor, out: torch.Tensor | None = None,
                event=None) -> Pending:
    """Start copying ``x`` to the host without waiting: on CUDA a
    non-blocking copy into the pinned ``out`` (made here when None) and an
    event behind it on the current stream, so the host can queue more
    device work before it waits in :meth:`Pending.result`.  ``event``: a
    ``torch.cuda.Event`` to record (made here when None)."""
    if x.device.type != "cuda":
        return Pending(x.detach().clone(), None)
    if out is None:
        out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x, non_blocking=True)
    event = torch.cuda.Event() if event is None else event
    event.record()
    return Pending(out, event)
