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
and declined); and resilience's (:mod:`..resilience`): ``checkpoint.*``
(captures, capture fetches, writes, write errors, coalesced snapshots,
restores, corrupt files skipped; ``checkpoint.write_secs`` a histogram),
``faults.*`` (injected faults by kind), ``supervisor.spokes_lost`` and the
``heartbeat.<cylinder>`` gauges; and the service tier's
(:mod:`..service`): ``service.*`` (requests, completions, warm and cold
starts, slices, preemptions, recoveries, rejections; the
``service.queue_wait_s``, ``service.wall_s`` and ``service.ttfi_s``
histograms and the journal's writes, compactions and torn lines),
``batching.*`` (joins, evictions, ghost rows, windows; the
``batching.slots`` gauge) and ``tcp_window.*``.  Each update is one lock
and a float add.  Scoped measurements read deltas through :func:`window`.
"""

from __future__ import annotations

import random
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


class Gauge:
    """Last-value-wins sample (None until set)."""

    __slots__ = ("_lock", "value")

    def __init__(self):
        self._lock = threading.Lock()
        self.value = None

    def set(self, v):
        with self._lock:
            self.value = float(v)

    def get(self):
        with self._lock:
            return self.value


class Histogram:
    """Streaming count, total, min and max of the samples added, and
    quantiles from a bounded reservoir (Algorithm R, capped at
    :data:`RESERVOIR_CAP` samples, seeded so that equal sample streams give
    equal summaries): the service tier's latency percentiles."""

    RESERVOIR_CAP = 512

    __slots__ = ("_lock", "count", "total", "min", "max", "_samples",
                 "_rng")

    def __init__(self):
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._samples: list = []
        self._rng = random.Random(0x5EED)

    def add(self, v):
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            if len(self._samples) < self.RESERVOIR_CAP:
                self._samples.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self.RESERVOIR_CAP:
                    self._samples[j] = v

    def quantile(self, q: float):
        """Nearest-rank quantile of the reservoir (None when empty); exact
        while ``count`` <= :data:`RESERVOIR_CAP`."""
        with self._lock:
            samples = sorted(self._samples)
        if not samples:
            return None
        q = min(max(float(q), 0.0), 1.0)
        return samples[min(len(samples) - 1,
                           int(round(q * (len(samples) - 1))))]

    def summary(self) -> dict:
        p50, p95, p99 = (self.quantile(q) for q in (0.50, 0.95, 0.99))
        with self._lock:
            return {"count": self.count, "total": self.total,
                    "min": self.min, "max": self.max,
                    "p50": p50, "p95": p95, "p99": p99}


class Registry:
    """Name -> metric store with get-or-create accessors."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}

    def _get(self, name: str, cls):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls()
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} is {type(m).__name__}, "
                                f"wanted {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(name, Histogram)

    def value(self, name: str, default=0.0):
        """A counter's or gauge's value, a histogram's total; ``default``
        for a name never fed (an idle subsystem reads as zero)."""
        with self._lock:
            m = self._metrics.get(name)
        if m is None:
            return default
        if isinstance(m, Histogram):
            return m.summary()["total"]
        return m.get()

    def dump(self) -> dict:
        with self._lock:
            names = sorted(self._metrics)
        return {name: self.value(name) for name in names}


#: The process-wide registry every subsystem feeds.
REGISTRY = Registry()


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str) -> Histogram:
    return REGISTRY.histogram(name)


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
        return ((self.registry.value(name, 0.0) or 0.0)
                - (self._base.get(name, 0.0) or 0.0))


def window(registry: Registry | None = None) -> Window:
    """Context manager for scoped measurement."""
    return Window(registry)
