"""Resilience: checkpoint and resume, fault injection, degradation.

The port of ``tpusppy/resilience/``:

- :mod:`.checkpoint`: versioned, atomic, asynchronous snapshots of the
  wheel's state (W, xbars, rho, the iteration, the best bounds) on a
  wall-clock or iteration cadence, and the ``resume=`` path of the wheel
  spinner.  A capture reads only host mirrors: it adds no fetch.
- :mod:`.faults`: deterministic fault injection (a spoke killed at its
  k-th payload, stale mailbox write-ids, and the hooks of the paths not
  ported yet).
- :mod:`.supervisor`: heartbeat gauges and the hub's spoke supervisor: a
  dead or wedged spoke is marked lost and the wheel goes on certifying
  with the cylinders left.
"""

from . import checkpoint, faults, supervisor  # noqa: F401

__all__ = ["checkpoint", "faults", "supervisor"]
