"""Host-sync accounting for device-to-host fetches.

Every fetch the solve loop makes on a decision path (the packed per-solve
measurement, the straggler rescue's aux state) goes through :func:`fetch`, so
the traffic is observable: the ``host_sync.count`` counter counts fetches and
``host_sync.fetch_secs`` the host time spent blocked in them.  The inner ADMM
loop's per-check termination vote is a sync too; it is counted separately as
``admm.loop_checks`` (:mod:`tpusppy_torch.solvers.admm`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs import trace as _trace

_CTR_COUNT = _metrics.counter("host_sync.count")
_CTR_FETCH = _metrics.counter("host_sync.fetch_secs")


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return np.array(x.detach().cpu(), copy=True)
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    return np.asarray(x)


def fetch(x):
    """Device-to-host copy of a tensor (or a tuple of them) as numpy,
    counted as ONE host sync.  numpy inputs pass through as arrays."""
    t0 = time.perf_counter()
    out = _to_host(x)
    dt = time.perf_counter() - t0
    _CTR_COUNT.inc(1)
    _CTR_FETCH.inc(dt)
    if _trace.enabled():
        _trace.record_span("host-sync", "fetch", t0, dt)
    return out
