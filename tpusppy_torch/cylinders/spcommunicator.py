"""Cylinder communication fabric: versioned mailboxes + SPCommunicator base.

A copy of ``tpusppy/cylinders/spcommunicator.py`` (the analogue of
``mpisppy/cylinders/spcommunicator.py:21-120``), without its fault-injection
hooks.  The reference exchanges flat float64 vectors between cylinder
process groups through one-sided MPI RMA windows whose last slot is a
monotone **write_id**; readers accept a payload only when the id is fresh,
and id ``-1`` is the kill signal.

Here cylinders are host threads of one process, each running its solves on
a CUDA stream of its own, so the window is a lock-guarded in-memory
:class:`Mailbox` with the same write-id semantics.  Payloads are host numpy
copies: no device tensor crosses from one cylinder to another, so no stream
hand-off is needed.
"""

from __future__ import annotations

import threading

import numpy as np

from ..obs import metrics as _metrics
from ..obs import trace as _trace

KILL_ID = -1

# mailbox traffic: puts against versioned-put skips (a hub re-putting an
# unchanged state would re-trigger a spoke's solve round), and the spokes'
# polls
_CTR_PUTS = _metrics.counter("mailbox.puts")
_CTR_PUT_SKIPS = _metrics.counter("mailbox.put_skips")
_CTR_GETS = _metrics.counter("mailbox.gets")
_CTR_KILLS = _metrics.counter("mailbox.kills")


class Mailbox:
    """A versioned one-writer many-reader buffer (the RMA-window analogue).

    The payload is ``length`` float64 slots; a trailing write-id slot is
    kept internally (buf[-1]), as ``_make_window``'s +1 layout.
    """

    def __init__(self, length: int, name: str = ""):
        self.name = name
        self.length = int(length)
        self._buf = np.zeros(self.length + 1)
        self._lock = threading.Lock()
        self._last_token = None

    def put(self, values) -> int:
        """Owner-side Put: write payload, bump write_id (spoke.py:60-82)."""
        values = np.asarray(values, dtype=np.float64)
        if values.shape != (self.length,):
            raise RuntimeError(
                f"Mailbox {self.name}: putting length {values.shape} into "
                f"buffer of length {self.length}"
            )
        with self._lock:
            if int(self._buf[-1]) == KILL_ID:
                # the kill sentinel is terminal: a late writer must not
                # resurrect the mailbox
                return KILL_ID
            new_id = int(self._buf[-1]) + 1
            self._buf[:-1] = values
            self._buf[-1] = new_id
        _CTR_PUTS.inc(1)
        if _trace.enabled():
            _trace.instant("mailbox", "put", box=self.name, write_id=new_id)
        return new_id

    def put_versioned(self, token, values) -> int:
        """Put that SKIPS when the writer's state token (any
        ==-comparable value) has not advanced since the previous versioned
        put.  ``values`` may be a zero-arg callable, so a skipped payload
        is not assembled either.  Returns the write-id (unchanged on a
        skip); the kill sentinel stays terminal."""
        with self._lock:
            if self._last_token is not None and token == self._last_token:
                _CTR_PUT_SKIPS.inc(1)
                return int(self._buf[-1])
        wid = self.put(values() if callable(values) else values)
        if wid != KILL_ID:
            self._last_token = token
        return wid

    def get(self) -> tuple[np.ndarray, int]:
        """Reader-side Get: snapshot (payload copy, write_id)."""
        _CTR_GETS.inc(1)
        with self._lock:
            return self._buf[:-1].copy(), int(self._buf[-1])

    def kill(self):
        """Write the termination sentinel (write_id = -1).  The last payload
        is kept, so a spoke that finalizes with the last hub data (the
        Lagrangian's final-W pass) uses it rather than zeros."""
        with self._lock:
            self._buf[-1] = KILL_ID
        _CTR_KILLS.inc(1)

    @property
    def write_id(self) -> int:
        with self._lock:
            return int(self._buf[-1])


class WindowFabric:
    """The set of hub<->spoke mailboxes for one wheel (the star graph):
    for each spoke strata rank i (1-based, the hub is 0), ``to_spoke[i]``
    is the hub-owned outbound window and ``to_hub[i]`` the spoke-owned
    inbound one."""

    def __init__(self):
        self.to_spoke: dict[int, Mailbox] = {}
        self.to_hub: dict[int, Mailbox] = {}

    def add_spoke(self, strata_rank: int, hub_to_spoke_len: int,
                  spoke_to_hub_len: int):
        self.to_spoke[strata_rank] = Mailbox(
            hub_to_spoke_len, f"hub->spoke{strata_rank}")
        self.to_hub[strata_rank] = Mailbox(
            spoke_to_hub_len, f"spoke{strata_rank}->hub")

    def send_terminate(self):
        for mb in self.to_spoke.values():
            mb.kill()


class SPCommunicator:
    """Base for hub/spoke communicators (spcommunicator.py:21-92).

    Owns the opt object (an SPBase derivative) and its strata position.
    Subclasses implement ``main``; ``sync``/``is_converged``/``finalize``
    are hooks the opt object's iteration loop calls.
    """

    def __init__(self, spbase_object, strata_rank: int, fabric: WindowFabric,
                 options=None):
        self.opt = spbase_object
        self.strata_rank = int(strata_rank)
        self.fabric = fabric
        self.options = dict(options or {})
        self.opt.spcomm = self

    def main(self):
        raise NotImplementedError

    def sync(self):
        pass

    def is_converged(self):
        return False

    def finalize(self):
        """Optional final calculations after convergence."""
        pass

    def hub_finalize(self):
        pass
