"""Process-wide metric counters.

A standard-library copy of the counter half of ``tpusppy/obs/metrics.py``:
what the solve loop and the host-sync wrapper feed (``host_sync.*``,
``admm.loop_checks``, ``solve.*``), and the reference's megastep counters:
``dispatch.megasteps`` (windows run, one packed fetch each),
``dispatch.mega_iterations`` (PH iterations they accepted),
``dispatch.flops`` (model flops, :mod:`..solvers.flops`),
``megastep.refresh_hits`` (windows that sent the next iteration to the
refresh), ``megastep.rejected_iterations``, ``megastep.bound_passes``,
``megastep.bound_pass_infeasible``, ``megastep.bound_rescues`` and
``phstate.boundary_fetches`` (host-mirror fetches of lean windows); and the
integer tiers' (:mod:`..solvers.integer`): ``integer.candidates``
(candidates the bound passes evaluated), ``integer.feasible_hits``
(feasible candidates, and incumbents the host legs certified from the
sweep), ``integer.rcfix_slots`` (slots reduced-cost fixing fixed),
``integer.escalations`` (host escalation rounds), ``integer.escalation_lifts``
(scenarios their MILP lifts solved), ``integer.escalation_secs`` (their
host seconds) and ``integer.escalation_errors`` (escalations that raised
and declined).  Each update is one lock and a float add.  Scoped
measurements read deltas through :func:`window`.
"""

from __future__ import annotations

import threading


class Counter:
    """Monotone float/int accumulator."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = 0.0

    def inc(self, n=1.0):
        with self._lock:
            self.value += n

    def get(self) -> float:
        with self._lock:
            return self.value


class Registry:
    """Name -> counter store with a get-or-create accessor."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def value(self, name: str, default=0.0):
        with self._lock:
            c = self._counters.get(name)
        return default if c is None else c.get()

    def dump(self) -> dict:
        with self._lock:
            items = list(self._counters.items())
        return {name: c.get() for name, c in sorted(items)}


#: The process-wide registry every subsystem feeds.
REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def inc(name: str, n=1.0):
    REGISTRY.counter(name).inc(n)


def value(name: str, default=0.0):
    return REGISTRY.value(name, default)


class Window:
    """Delta view over the registry: ``delta(name)`` is the traffic since
    the window was entered."""

    def __init__(self, registry: Registry | None = None):
        self.registry = registry or REGISTRY
        self._base: dict = {}

    def __enter__(self):
        self._base = self.registry.dump()
        return self

    def __exit__(self, *exc):
        return False

    def delta(self, name: str) -> float:
        return self.registry.value(name, 0.0) - self._base.get(name, 0.0)


def window(registry: Registry | None = None) -> Window:
    """Context manager for scoped measurement."""
    return Window(registry)
