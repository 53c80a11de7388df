"""Cylinder heartbeats and the hub-side spoke supervisor (degradation).

A copy of ``tpusppy/resilience/supervisor.py``.  Without it a dead spoke
thread surfaces only as an exception after the hub finishes, and a
wedged one (alive, making no mailbox progress) can hold the hub's linger
harvest for its whole budget.  The supervisor turns spoke health into
data the hub acts on each ``sync()``:

- every spoke publishes a heartbeat gauge (``heartbeat.spoke<i>`` in
  :mod:`..obs.metrics`, monotonic seconds) each time it polls its
  mailbox, and the hub ``heartbeat.hub`` each sync;
- the hub's :class:`SpokeSupervisor` watches, per spoke, the inbound
  mailbox's write-id (progress), the heartbeat (liveness) and the thread
  (death), and marks a spoke lost when it crashed, died, or, with
  ``spoke_timeout_secs`` set, made no progress past the timeout;
- a lost spoke gates nothing: the linger harvest ends when every spoke is
  lost, teardown joins give a lost spoke a short grace instead of the
  full deadline, a crashed spoke's finalize is skipped, and the wheel
  completes with what the remaining bounders certified
  (``WheelSpinner.lost_spokes``; ``strict_spokes`` raises instead).

Warm-up on the card: a spoke's first solves build its kernels (``nvcc``,
minutes the first time) and capture its CUDA graphs, with no mailbox
poll and so no heartbeat in between, while every cylinder shares one
interpreter lock.  So the staleness timeout starts after warm-up, which
ends on a signal every spoke reaches whether or not it ever posts: its
first poll after it has worked on its first fresh hub payload (the
spoke publishes that moment on its ``warmup.spoke<i>`` gauge, see
:func:`mark_warm`), or its first bound in its mailbox (write-id 1 or
more), whichever comes first.  Before that only a crash or a dead thread
marks it lost.  The timeout is off by default, and the load-adaptive
grace below widens it whenever the hub's own sync loop is starved.

Bounds a spoke posted before dying stay valid and are still read: loss
only stops the hub waiting on the dead.
"""

from __future__ import annotations

import threading
import time

from .. import global_toc
from ..obs import metrics as _metrics
from ..obs import trace as _trace

HEARTBEAT_PREFIX = "heartbeat."
WARMUP_PREFIX = "warmup."

_CTR_LOST = _metrics.counter("supervisor.spokes_lost")


def heartbeat_gauge(cylinder: str):
    """The liveness gauge for ``cylinder`` — poll loops hoist this once
    and ``set(time.monotonic())`` per beat (one lock + a float store)."""
    return _metrics.gauge(HEARTBEAT_PREFIX + cylinder)


def heartbeat(cylinder: str):
    """Publish liveness for ``cylinder`` (gauge = monotonic seconds)."""
    heartbeat_gauge(cylinder).set(time.monotonic())


def last_heartbeat(cylinder: str):
    return _metrics.gauge(HEARTBEAT_PREFIX + cylinder).get()


def mark_warm(cylinder: str):
    """``cylinder``'s warm-up is over (gauge = monotonic seconds, so a
    mark left by an earlier wheel in this process reads as older than a
    new supervisor and does not count)."""
    _metrics.gauge(WARMUP_PREFIX + cylinder).set(time.monotonic())


def warm_since(cylinder: str):
    return _metrics.gauge(WARMUP_PREFIX + cylinder).get()


class _Watch:
    __slots__ = ("name", "last_wid", "last_progress", "thread", "proc",
                 "lost", "reason", "error", "warm")

    def __init__(self, name):
        self.name = name
        self.warm = False       # the spoke's warm-up is over
        self.last_wid = None
        self.last_progress = time.monotonic()
        self.thread = None
        self.proc = None
        self.lost = False
        self.reason = None
        self.error = None


class SpokeSupervisor:
    """Hub-side per-spoke health tracker.

    ``fabric`` supplies the inbound (``to_hub``) mailboxes whose write-id
    progression is the progress signal; ``spoke_names`` maps strata rank
    -> display name.  ``timeout_secs=None`` disables staleness-based loss
    (death-based loss is always on): a spoke legitimately deep in a host
    MILP makes no mailbox progress for minutes, so the timeout is an
    operator knob, not a default.

    Staleness is judged only after a spoke's warm-up (its first poll
    after working on a payload, or its first bound posted; the module
    docstring says why), on the monotonic clock with a
    load-adaptive grace: while the sync loop is healthy (the gap between
    ``observe`` calls within ``timeout_secs``) the operator's window
    applies unchanged; only when the loop itself stalls past the window,
    so that no valid observation could have happened inside it, does the
    effective timeout widen to ``grace_factor`` times the observed
    latency (the larger of its running mean and the latest gap).  A hub
    starved of the interpreter starves its spokes too, and a fixed window
    would read that as a wedge.
    """

    def __init__(self, fabric, spoke_names: dict, timeout_secs=None,
                 grace_factor: float = 8.0):
        self.fabric = fabric
        self.timeout_secs = (None if timeout_secs in (None, 0)
                             else float(timeout_secs))
        self.grace_factor = float(grace_factor)
        self._t0 = time.monotonic()
        self._last_observe = None
        self._latency_ewma = 0.0
        self._latency_last = 0.0
        self._lock = threading.Lock()
        self._watch = {int(i): _Watch(str(nm))
                       for i, nm in (spoke_names or {}).items()}

    # ---- registration ------------------------------------------------------
    def note_thread(self, idx: int, thread):
        with self._lock:
            if idx in self._watch:
                self._watch[idx].thread = thread

    def note_process(self, idx: int, proc):
        with self._lock:
            if idx in self._watch:
                self._watch[idx].proc = proc

    def note_error(self, idx: int, exc):
        """A spoke's main loop raised: immediate loss."""
        with self._lock:
            w = self._watch.get(idx)
            if w is not None:
                w.error = exc
        self._mark_lost(idx, "crashed")

    # ---- observation (hub sync cadence) ------------------------------------
    def effective_timeout(self):
        """The staleness window actually applied this pass: the operator
        knob, widened ONLY when the observe loop itself stalled past it
        (None = staleness loss disabled)."""
        if self.timeout_secs is None:
            return None
        lat = max(self._latency_ewma, self._latency_last)
        if self.grace_factor <= 0 or lat <= self.timeout_secs:
            return self.timeout_secs
        return self.grace_factor * lat

    def observe(self):
        """One health pass over every non-lost spoke; called by the hub
        each sync.  Reads are mailbox write-ids and gauges — never a
        device or network round-trip beyond what the fabric's write_id
        accessor costs."""
        now = time.monotonic()
        if self._last_observe is not None:
            dt = now - self._last_observe
            self._latency_last = dt
            self._latency_ewma = (dt if self._latency_ewma == 0.0
                                  else 0.8 * self._latency_ewma + 0.2 * dt)
        self._last_observe = now
        eff_timeout = self.effective_timeout()
        for idx, w in list(self._watch.items()):
            if w.lost:
                continue
            progressed = False
            try:
                wid = self.fabric.to_hub[idx].write_id
            except Exception:
                wid = None          # fabric op failed: no progress signal
            if wid is not None and wid != w.last_wid:
                w.last_wid = wid
                progressed = True
            if not w.warm:
                warm_t = warm_since(f"spoke{idx}")
                w.warm = ((wid is not None and wid >= 1) or
                          (warm_t is not None and warm_t >= self._t0))
            hb = last_heartbeat(f"spoke{idx}")
            if hb is not None and hb > w.last_progress:
                progressed = True
            if progressed:
                w.last_progress = now
                continue
            dead = (w.thread is not None and not w.thread.is_alive()) or \
                   (w.proc is not None and w.proc.exitcode is not None)
            if dead:
                self._mark_lost(idx, "died")
            elif (eff_timeout is not None and w.warm
                    and now - w.last_progress > eff_timeout):
                self._mark_lost(idx, "wedged")

    def _mark_lost(self, idx: int, reason: str):
        with self._lock:
            w = self._watch.get(idx)
            if w is None or w.lost:
                return
            w.lost = True
            w.reason = reason
        _CTR_LOST.inc(1)
        if _trace.enabled():
            _trace.instant("hub", "spoke_lost", spoke=idx, name=w.name,
                           reason=reason)
        global_toc(
            f"WARNING: spoke {idx} ({w.name}) marked LOST ({reason}) — "
            "continuing with the remaining cylinders", True)

    # ---- queries -----------------------------------------------------------
    def is_lost(self, idx: int) -> bool:
        w = self._watch.get(idx)
        return bool(w and w.lost)

    def lost(self) -> dict:
        """{idx: (name, reason)} of every lost spoke."""
        with self._lock:
            return {i: (w.name, w.reason)
                    for i, w in self._watch.items() if w.lost}

    def lost_names(self) -> list:
        return [f"{nm} ({why})" for nm, why in self.lost().values()]

    def errors(self) -> list:
        with self._lock:
            return [(w.name, w.error) for w in self._watch.values()
                    if w.error is not None]

    def all_lost(self) -> bool:
        with self._lock:
            return bool(self._watch) and all(
                w.lost for w in self._watch.values())
