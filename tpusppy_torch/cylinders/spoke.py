"""Spoke type lattice: typed bases for bound/W/nonant spokes.

A copy of ``tpusppy/cylinders/spoke.py`` (the analogue of
``mpisppy/cylinders/spoke.py:18-376``), with the supervisor's heartbeat
gauge (beaten on every poll of the hub's mailbox) and the dead-spoke fault
hook (:func:`..resilience.faults.on_spoke_payload`, on every fresh
payload).  A spoke runs an opt object in its own cylinder
(a host thread with a CUDA stream of its own), puts its bound into its
hub-facing mailbox, polls the hub's outbound mailbox for W / nonant / bound
payloads with write-id freshness semantics, and exits on the kill sentinel
(write_id == -1).
"""

from __future__ import annotations

import enum
import math
import threading
import time

import numpy as np

from ..resilience import faults as _faults
from ..resilience import supervisor as _supervisor
from .spcommunicator import KILL_ID, SPCommunicator


class ConvergerSpokeType(enum.Enum):
    OUTER_BOUND = 1
    INNER_BOUND = 2
    W_GETTER = 3
    NONANT_GETTER = 4


class Spoke(SPCommunicator):
    """Base spoke (spoke.py:24-145)."""

    def __init__(self, spbase_object, strata_rank, fabric, options=None):
        super().__init__(spbase_object, strata_rank, fabric, options)
        self.remote_write_id = 0
        self._recv_count = 0     # fresh hub payloads seen (the fault clock)
        self._hb_gauge = _supervisor.heartbeat_gauge(
            f"spoke{self.strata_rank}")
        self._warm = False

    def buffer_lengths(self) -> tuple[int, int]:
        """(spoke_to_hub_len, hub_to_spoke_len), excluding write-id slots;
        the spinner sizes the mailboxes from them."""
        raise NotImplementedError

    def spoke_to_hub(self, values):
        self.fabric.to_hub[self.strata_rank].put(values)

    def spoke_from_hub(self):
        """Snapshot the hub's outbound payload; True when fresh.  A poll is
        a heartbeat for the hub's supervisor, whether or not it brings
        anything new.  The first poll after a fresh payload ends the
        spoke's warm-up: it has come back from its first solve on hub
        data, so its kernels are built and its graphs captured."""
        self._hb_gauge.set(time.monotonic())
        if not self._warm and self._recv_count:
            self._warm = True
            _supervisor.mark_warm(f"spoke{self.strata_rank}")
        data, wid = self.fabric.to_spoke[self.strata_rank].get()
        self._locals = data
        if wid > self.remote_write_id or wid < 0:
            self.remote_write_id = wid
            if wid >= 0:
                self._recv_count += 1
                if _faults.active():   # deterministic dead-spoke injection
                    _faults.on_spoke_payload(self)
            return True
        return False

    def got_kill_signal(self) -> bool:
        self._new_locals = self.spoke_from_hub()
        if not self._new_locals:
            # nothing fresh: yield the core so the hub thread can progress
            time.sleep(0.002)
        return self.remote_write_id == KILL_ID

    def peek_kill_signal(self) -> bool:
        """Kill check that does not consume payload freshness: safe to call
        mid-computation."""
        return self.fabric.to_spoke[self.strata_rank].write_id == KILL_ID

    def main(self):
        raise NotImplementedError


class _BoundSpoke(Spoke):
    """A spoke that reports a single bound (spoke.py:147-208); it counts the
    bounds it posts."""

    def __init__(self, spbase_object, strata_rank, fabric, options=None):
        super().__init__(spbase_object, strata_rank, fabric, options)
        self._bound = 0.0
        self._locals = np.zeros(2)
        self._new_locals = False
        self.bounds_posted = 0

    def buffer_lengths(self):
        return 1, 2  # bound out; hub outer/inner bounds in

    @property
    def bound(self):
        return self._bound

    @bound.setter
    def bound(self, value):
        self._bound = float(value)
        self.spoke_to_hub(np.array([self._bound]))
        self.bounds_posted += 1

    @property
    def hub_outer_bound(self):
        return self._locals[-2]

    @property
    def hub_inner_bound(self):
        return self._locals[-1]


class InnerBoundSpoke(_BoundSpoke):
    """Inner bound, no hub data needed (spoke.py:239-244)."""
    converger_spoke_types = (ConvergerSpokeType.INNER_BOUND,)
    converger_spoke_char = 'I'


class OuterBoundSpoke(_BoundSpoke):
    """Outer bound, no hub data needed (spoke.py:246-252)."""
    converger_spoke_types = (ConvergerSpokeType.OUTER_BOUND,)
    converger_spoke_char = 'O'


class _BoundNonantLenSpoke(_BoundSpoke):
    """A bound spoke whose inbound payload is nonant-length
    (spoke.py:210-237): (S*K) values + hub outer/inner bounds."""

    def buffer_lengths(self):
        S = self.opt.batch.num_scenarios
        K = self.opt.nonant_length
        return 1, S * K + 2


class _BoundWSpoke(_BoundNonantLenSpoke):
    """Gets the hub's W (spoke.py:254-270)."""

    @property
    def localWs(self) -> np.ndarray:
        """(S, K) view of the hub's dual weights."""
        S = self.opt.batch.num_scenarios
        K = self.opt.nonant_length
        return self._locals[:-2].reshape(S, K)

    @property
    def new_Ws(self) -> bool:
        return self._new_locals


class OuterBoundWSpoke(_BoundWSpoke):
    converger_spoke_types = (
        ConvergerSpokeType.OUTER_BOUND,
        ConvergerSpokeType.W_GETTER,
    )
    converger_spoke_char = 'O'


class _BoundNonantSpoke(_BoundNonantLenSpoke):
    """Gets the hub's nonants (spoke.py:288-304)."""

    @property
    def localnonants(self) -> np.ndarray:
        """(S, K) view of the hub's current nonant values."""
        S = self.opt.batch.num_scenarios
        K = self.opt.nonant_length
        return self._locals[:-2].reshape(S, K)

    @property
    def new_nonants(self) -> bool:
        return self._new_locals


class InnerBoundNonantSpoke(_BoundNonantSpoke):
    """Incumbent finder over hub nonants, with best-solution cache
    (spoke.py:306-363)."""

    converger_spoke_types = (
        ConvergerSpokeType.INNER_BOUND,
        ConvergerSpokeType.NONANT_GETTER,
    )
    converger_spoke_char = 'I'

    def __init__(self, spbase_object, strata_rank, fabric, options=None):
        super().__init__(spbase_object, strata_rank, fabric, options)
        self.is_minimizing = self.opt.is_minimizing
        self.best_inner_bound = math.inf if self.is_minimizing else -math.inf
        self.best_solution_cache = None   # (S, n) full solutions
        # (bound, cache) are written as a pair; the spinner may read them
        # from another thread while the spoke is still mid-update
        self._best_lock = threading.Lock()

    def update_if_improving(self, candidate_inner_bound) -> bool:
        if candidate_inner_bound is None or not np.isfinite(
                candidate_inner_bound):
            return False
        better = (candidate_inner_bound < self.best_inner_bound
                  if self.is_minimizing
                  else candidate_inner_bound > self.best_inner_bound)
        if not better:
            return False
        with self._best_lock:
            self.best_inner_bound = float(candidate_inner_bound)
            self.bound = self.best_inner_bound
            self._cache_best_solution()
        return True

    def best_snapshot(self):
        """(bound, cache), read atomically against update_if_improving."""
        with self._best_lock:
            return self.best_inner_bound, self.best_solution_cache

    def _cache_best_solution(self):
        if self.opt.local_x is not None:
            self.best_solution_cache = np.asarray(self.opt.local_x).copy()

    def finalize(self):
        if self.best_solution_cache is None:
            return None
        self.opt.local_x = self.best_solution_cache
        self.final_bound = self.bound
        return self.final_bound


class OuterBoundNonantSpoke(_BoundNonantSpoke):
    converger_spoke_types = (
        ConvergerSpokeType.OUTER_BOUND,
        ConvergerSpokeType.NONANT_GETTER,
    )
    converger_spoke_char = 'A'
