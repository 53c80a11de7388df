"""Continuous batching: K isomorphic tenants in ONE tenant window.

Port of ``tpusppy/service/batching.py``.  Time-slicing runs the same
programs one tenant at a time, paying a park/resume, a wheel's set-up and
teardown and a host sync a window for each tenant and quantum.  Here K
concurrent requests of one shape family share one window
(:func:`..parallel.sharded.make_tenant_megastep`) and one packed fetch, and
a finishing tenant's slot is backfilled from the queue at a window
boundary.

:class:`BatchedFamilyRunner` is the scheduler-side half of the tenant
window:

* **Slots.**  K slots, each holding one tenant's OWN
  :class:`~..parallel.sharded.PHState`, arrays and factors: the per-slot
  computation is the solo wheel's window (the 1e-9 parity contract); only
  the dispatch and the fetch are shared.  An empty slot rides as a GHOST
  (``live_mask`` False: nothing runs, its state passes through) until a
  join backfills it.
* **Joins and evictions at window boundaries only.**  A join uploads the
  newcomer's arrays and a fresh (or checkpoint-resumed) W/xbars/rho into
  a free slot; an eviction banks the slot's W/xbars/rho through the
  checkpoint seam (:mod:`..resilience.checkpoint`), a normal
  :class:`~..resilience.checkpoint.WheelCheckpoint` that the solo path, a
  batched re-join and restart recovery all read.  Every slot's window runs
  on the runner's owner token (:func:`..solvers.cuda_kernels.owned_by`),
  so on the card the slots share one set of captured graphs: a join copies
  into their buffers and captures nothing.
* **Per-tenant certification.**  ``in_wheel_bounds`` windows return one
  bound pack a tenant; each slot's :class:`BoundTracker` keeps the hub's
  typed-update semantics (outer keeps the max, inner the min; an inner
  bound only when the frozen evaluation was feasible on the whole batch,
  else the slot's host-exact rescue) under the source char ``'B'``.
* **Attribution.**  A window's wall splits by live-row fraction
  (:func:`..solvers.flops.tenant_shares`) and flops are billed per tenant
  from the solo megastep's flop model (:func:`..solvers.segmented.
  bill_megastep`, :func:`~..solvers.segmented.bill_bound_pass`).  Graph
  captures, replays and build seconds (:data:`METERED`) are metered per
  tenant over its admission, its refreshes and its slot's windows.

Counters: ``batching.joins``, ``batching.evictions``,
``batching.ghost_rows``, ``batching.windows`` and the ``batching.slots``
gauge.  The runner does no admission, QoS ordering, journaling or deadline
handling: that is :class:`.server.SolveServer`'s.
"""

from __future__ import annotations

import time
from math import inf

import numpy as np
import torch

from .. import resolve_device
from ..obs import metrics as _metrics
from ..obs import telemetry as _telemetry
from ..obs import trace as _trace
from ..obs.log import get_logger
from ..resilience import checkpoint as _ckpt
from ..solvers import cuda_kernels, device_loop, hostsync
from ..solvers import flops as _flops
from ..solvers import segmented as _segmented
from ..solvers.integer import feas_slack as _feas_slack
from ..spbase import make_admm_settings

_log = get_logger("service.batching")

_CTR_JOINS = _metrics.counter("batching.joins")
_CTR_EVICTIONS = _metrics.counter("batching.evictions")
_CTR_GHOST_ROWS = _metrics.counter("batching.ghost_rows")
_CTR_WINDOWS = _metrics.counter("batching.windows")
_G_SLOTS = _metrics.gauge("batching.slots")

#: Source char of bound updates from the tenant window ('*' the hub's own,
#: 'M' the megastep's, 'R' a resume seed).
BATCH_SOURCE_CHAR = "B"

#: Registry counters metered for each tenant over its admission, its
#: slot's refreshes and its slot's windows and reported with them: its
#: graph captures and replays, and their capture and kernel build seconds
#: (the server bills them into the tenant's record).
METERED = ("device_loop.captures", "device_loop.replays",
           "device_loop.capture_secs", "cuda_kernels.build_secs")

#: QoS classes: a lower rank takes a free slot first; ties keep submission
#: order.
QOS_CLASSES = {"interactive": 0, "standard": 1, "batch": 2}


def _meter() -> dict:
    return {n: _metrics.value(n) for n in METERED}


def _since(before: dict) -> dict:
    return {n: _metrics.value(n) - v for n, v in before.items()}


def qos_rank(qos) -> int:
    """Slot-assignment rank of a QoS class name (unknown -> standard)."""
    return QOS_CLASSES.get(str(qos or "standard"), QOS_CLASSES["standard"])


class BoundTracker:
    """Per-tenant bounds with the hub's typed-update semantics
    (minimizing: outer keeps the max, inner the min), for a tenant whose
    window bounds come from the tenant window instead of a hub."""

    def __init__(self, best_inner=inf, best_outer=-inf):
        self.best_inner = float(best_inner)
        self.best_outer = float(best_outer)

    def outer_update(self, v: float):
        v = float(v)
        if np.isfinite(v) and v > self.best_outer:
            self.best_outer = v

    def inner_update(self, v: float):
        v = float(v)
        if np.isfinite(v) and v < self.best_inner:
            self.best_inner = v

    def gaps(self):
        """(abs_gap, rel_gap), the hub's ``compute_gaps`` arithmetic."""
        if not (np.isfinite(self.best_inner)
                and np.isfinite(self.best_outer)):
            return inf, inf
        abs_gap = self.best_inner - self.best_outer
        return abs_gap, abs_gap / (abs(self.best_outer) or 1.0)


class _Slot:
    """One tenant slot: a live wheel, or a finished tenant's residue left
    as the ghost filler."""

    __slots__ = ("rid", "dir", "arr", "state", "factors", "age", "iters",
                 "iter_limit", "convthresh", "tracker", "live", "batch",
                 "gate_misses", "next_rescue", "declines", "trace_id")

    def __init__(self, rid, tenant_dir, arr, state, iter_limit,
                 convthresh, tracker, iters=0, batch=None,
                 trace_id=None):
        self.rid = rid
        self.dir = tenant_dir
        self.arr = arr
        self.state = state
        self.factors = None
        self.age = inf          # forces a prox-on refresh at first window
        self.iters = int(iters)
        self.iter_limit = int(iter_limit)
        self.convthresh = float(convthresh)
        self.tracker = tracker
        self.live = True
        self.batch = batch      # host arrays, for the inner-bound rescue
        self.gate_misses = 0    # the rescue's cadence state
        self.next_rescue = 0
        self.declines = 0
        self.trace_id = trace_id


class BatchedFamilyRunner:
    """K-slot tenant window for ONE shape family.

    Args:
      canon: any member's :class:`.canonical.CanonicalModel` (the family
        template: nonant indices, settings, shapes).  Each tenant brings
        its own canonical model to :meth:`admit`.
      opt_options: the family's resolved opt options (equal for every
        member by family equality); ``"device"`` picks the device (CUDA
        unless ``"cpu"``; raises without a GPU).
      k_slots: slot count K.
      owner: the owner token of the runner's device state (captured graphs
        and kernel operands); default a token of the runner's own, freed by
        :meth:`close`.  The solve server passes one token a family, kept
        until the family is retired, so a later runner of the family
        captures nothing.
    """

    def __init__(self, canon, opt_options, k_slots, owner=None):
        from ..parallel import sharded

        self._sharded = sharded
        self.opt_options = dict(opt_options)
        self.device = resolve_device(self.opt_options.get("device"))
        self.settings = make_admm_settings(dict(opt_options),
                                           canon.bundling)
        self.dt = self.settings.tdtype()
        b = canon.batch
        self.S, self.n, self.m = (b.num_scenarios, b.num_vars,
                                  b.num_rows)
        self.nonant_idx = b.tree.nonant_indices
        self.k_slots = int(k_slots)
        self.default_rho = float(self.opt_options.get("defaultPHrho", 1.0))
        self.refresh_every = max(
            int(self.opt_options.get("solver_refresh_every", 16) or 16), 1)
        self.in_wheel = bool(self.opt_options.get("in_wheel_bounds"))
        self.feas_tol = max(
            float(self.opt_options.get("feas_tol", 1e-3)),
            10.0 * self.settings.eps_rel)
        # the window's acceptance tolerance: the solo wheel's frozen
        # iterations' (spopt._straggler_tols, QP side)
        floor = 10.0 * self.settings.eps_rel
        tol_lp = max(float(self.opt_options.get("straggler_tol", 1e-4)),
                     floor)
        if "straggler_tol_qp" in self.opt_options:
            self.accept_tol = max(
                float(self.opt_options["straggler_tol_qp"]), floor)
        elif "straggler_tol" in self.opt_options:
            self.accept_tol = tol_lp
        else:
            self.accept_tol = max(1e-2, tol_lp)
        cap = _segmented.megastep_cap(bound_pass=self.in_wheel)
        self.n_window = max(1, min(self.refresh_every, cap))
        self._refresh, _ = sharded.make_ph_step_pair(
            self.nonant_idx, self.settings)
        self._mega = sharded.make_tenant_megastep(
            self.nonant_idx, self.settings, n_iters=self.n_window,
            bounds=self.in_wheel)
        self.owner = owner if owner is not None else ("batch", id(self))
        self._owned = owner is None
        self.slots: list = [None] * self.k_slots
        #: kernel launches of each slot's windows (its frozen solves and
        #: bound passes), by (kernel, mode) as cuda_kernels.counts keys
        self.slot_launches = [{} for _ in range(self.k_slots)]
        self.windows = 0
        _G_SLOTS.set(float(self.k_slots))

    def _running(self):
        """The runner's device work runs as its owner."""
        return cuda_kernels.owned_by(self.owner)

    def close(self):
        """Free the device state of a runner that owns its token."""
        if self._owned:
            device_loop.release(self.owner)

    # ---- slot inventory -----------------------------------------------------
    def _find(self, rid):
        for s in self.slots:
            if s is not None and s.live and s.rid == rid:
                return s
        return None

    def has(self, rid) -> bool:
        return self._find(rid) is not None

    def live_rids(self) -> list:
        return [s.rid for s in self.slots if s is not None and s.live]

    def free_slots(self) -> int:
        return sum(1 for s in self.slots if s is None or not s.live)

    def tracker(self, rid) -> BoundTracker:
        return self._find(rid).tracker

    # ---- joins --------------------------------------------------------------
    def admit(self, rid, canon, tenant_dir, iter_limit, resume=True,
              best_inner=inf, best_outer=-inf, trace_id=None) -> dict:
        """Join ``rid`` into a free slot at this window boundary.

        ``resume=True`` seeds W/xbars/rho (and the banked bounds) from the
        tenant's newest checkpoint where one exists: an evicted (or
        solo-parked) tenant continues its trajectory, and the first prox-on
        refresh rebuilds the iterate.  A fresh tenant runs Iter0 (plain
        objective, W=0, prox off) as the solo wheel does.  ``trace_id``
        carries the request's trace into the slot's events.  Returns
        ``{"iteration", "resumed", "metered"}``, ``metered`` the
        :data:`METERED` counters' deltas over the admission."""
        from .. import spopt

        idx = None
        for i, s in enumerate(self.slots):
            if s is None or not s.live:
                idx = i
                break
        if idx is None:
            raise RuntimeError(f"no free slot for {rid!r} "
                               f"(K={self.k_slots})")
        before = _meter()
        arr = spopt.mega_arrays_for_batch(
            canon.batch, self.dt, self.device,
            sparse=self.opt_options.get("sparse_device_A", "auto"))
        state = self._sharded.init_state(arr, self.default_rho,
                                         self.settings)
        tracker = BoundTracker(best_inner=best_inner,
                               best_outer=best_outer)
        banked = _ckpt.load_latest(tenant_dir) if resume else None
        resumed = banked is not None and banked.W is not None
        it0 = 0
        if resumed:
            def t(v):
                return torch.as_tensor(np.asarray(v), dtype=self.dt,
                                       device=self.device)

            state = state._replace(W=t(banked.W), xbars=t(banked.xbars),
                                   rho=t(banked.rho))
            it0 = int(banked.iteration)
            tracker.inner_update(banked.best_inner)
            tracker.outer_update(banked.best_outer)
            for _, bd in (banked.spoke_bounds or {}).items():
                kind, val = bd[0], float(bd[1])
                (tracker.outer_update if kind == "outer"
                 else tracker.inner_update)(val)
        else:
            # Iter0: the plain-objective solve (W=0, prox off); its factors
            # (of the prox-off system) are dropped: the first window's
            # refresh builds the prox-on ones
            with self._running():
                state, _, _ = self._refresh(state, arr, 0.0)
        slot = _Slot(rid, tenant_dir, arr, state, iter_limit,
                     float(self.opt_options.get("convthresh", -1.0)),
                     tracker, iters=it0, batch=canon.batch,
                     trace_id=trace_id)
        self.slots[idx] = slot
        _CTR_JOINS.inc(1)
        _telemetry.tenant_instant(rid, trace_id, "batch_join", slot=idx,
                                  resumed=resumed, iteration=it0)
        _log.info("batch join: %s -> slot %d (%s, iter %d)", rid, idx,
                  "resumed" if resumed else "fresh", it0)
        return {"iteration": it0, "resumed": resumed,
                "metered": _since(before)}

    # ---- evictions ----------------------------------------------------------
    def _bank(self, s) -> int:
        """Write one slot's W/xbars/rho and best bounds through the
        checkpoint seam (one fetch of the three arrays)."""
        W, xbars, rho = hostsync.fetch((s.state.W, s.state.xbars,
                                        s.state.rho))
        ck = _ckpt.WheelCheckpoint(
            iteration=s.iters, W=np.asarray(W, dtype=float),
            xbars=np.asarray(xbars, dtype=float),
            rho=np.asarray(rho, dtype=float),
            best_inner=s.tracker.best_inner,
            best_outer=s.tracker.best_outer,
            meta={"batched": True, "source": BATCH_SOURCE_CHAR})
        _ckpt.save(ck, _ckpt.checkpoint_path(s.dir, s.iters))
        _telemetry.tenant_instant(s.rid, s.trace_id, "batch_bank",
                                  iteration=s.iters)
        return s.iters

    def bank(self, rid) -> int:
        """Mid-run checkpoint of a LIVE slot (the server's
        ``checkpoint_every_secs`` cadence inside a batch); the slot keeps
        running."""
        return self._bank(self._find(rid))

    def evict(self, rid, bank=True) -> int:
        """Evict ``rid``'s slot at this window boundary, banking its state
        first where ``bank``; the slot's arrays stay as the ghost filler.
        Returns the slot's iteration."""
        s = self._find(rid)
        if s is None:
            raise KeyError(f"{rid!r} holds no live slot")
        if bank:
            self._bank(s)
        s.live = False
        s.batch = None
        _CTR_EVICTIONS.inc(1)
        _telemetry.tenant_instant(rid, s.trace_id, "batch_evict",
                                  iteration=s.iters, banked=bank)
        _log.info("batch evict: %s at iter %d (%s)", rid, s.iters,
                  "banked" if bank else "unbanked")
        return s.iters

    def complete(self, rid):
        """Retire a FINISHED tenant's slot (no eviction, no checkpoint: the
        record carries the result); its host arrays are released."""
        s = self._find(rid)
        if s is not None:
            s.live = False
            s.batch = None

    # ---- the inner-bound host rescue ----------------------------------------
    def _maybe_rescue(self, s):
        """Per-slot twin of ``PHBase._maybe_inwheel_rescue``: where the
        device feasibility gate misses, evaluate the same xhat candidate by
        per-scenario host-exact solves and offer the certified expected
        objective as the slot's inner bound, at the first miss and then
        every ``in_wheel_rescue_every``-th, declines retried with a growing
        backoff."""
        if not self.opt_options.get("in_wheel_host_rescue", True):
            return
        every = max(1, int(self.opt_options.get("in_wheel_rescue_every",
                                                4)))
        miss = s.gate_misses
        s.gate_misses = miss + 1
        if miss < s.next_rescue:
            return
        ib = self._eval_candidate_host(s)
        if ib is None:
            s.declines += 1
            s.next_rescue = miss + min(s.declines, every)
        else:
            s.next_rescue = miss + every
            s.tracker.inner_update(ib)

    def _eval_candidate_host(self, s):
        """Expected objective of the slot's clamped xhat candidate by
        per-scenario host solves (None: infeasible or a solver error; a
        failed rescue declines, never stops the batch)."""
        from ..cylinders.xhatxbar_bounder import clamp_candidate
        from ..solvers import scipy_backend

        b = s.batch
        if b is None:
            return None
        _metrics.inc("megastep.bound_rescues")
        try:
            nid = b.tree.nonant_indices
            xbars = np.asarray(hostsync.fetch(s.state.xbars), dtype=float)
            thr = float(self.opt_options.get("in_wheel_xhat_threshold",
                                             0.5))
            _, lb, ub = clamp_candidate(b, nid, xbars, thr)
            probs = np.asarray(b.tree.scen_prob, dtype=float)
            objs = []
            for i in range(b.num_scenarios):
                q2s = np.asarray(b.q2[i])
                if q2s.any():
                    r = scipy_backend.solve_qp_with_duals(
                        b.c[i], q2s, b.A[i], b.cl[i], b.cu[i],
                        lb[i], ub[i], const=b.const[i])
                else:
                    r = scipy_backend.solve_lp(
                        b.c[i], b.A[i], b.cl[i], b.cu[i],
                        lb[i], ub[i], const=b.const[i])
                objs.append(r.obj)
            objs = np.asarray(objs, dtype=float)
            if not np.isfinite(objs).all():
                return None
            return float(probs @ objs)
        except Exception as e:
            _log.warning("batched inner rescue failed (%r): declined", e)
            return None

    # ---- the window ---------------------------------------------------------
    def window(self) -> dict:
        """Run ONE tenant window over every live slot; returns ``{rid:
        report}`` with the tenant's ``executed``, cumulative ``iters``,
        ``outer``, ``inner``, ``abs_gap``, ``rel_gap``, ``wall_s`` (its
        live-row share of the window's wall), ``flops`` (its own flop-model
        bill), ``metered`` (the :data:`METERED` counters' deltas over its
        refresh and its slot's window) and ``exhausted`` (iteration budget
        spent).

        Joins and evictions happen BETWEEN calls; inside the call the slot
        population is frozen, and a slot that stops mid-window (its
        convergence test, its ``n_live``) never perturbs its siblings."""
        sharded = self._sharded
        live = [s for s in self.slots if s is not None and s.live]
        if not live:
            return {}
        t0 = time.monotonic()
        metered = [dict.fromkeys(METERED, 0.0) for _ in self.slots]
        with self._running():
            # per-slot adaptive refresh where due: the solo wheel's refresh
            # step, so the trajectory is the time-sliced path's
            for i, s in enumerate(self.slots):
                if s is None or not s.live:
                    continue
                if s.factors is None or s.age >= self.refresh_every:
                    if s.iters >= s.iter_limit:
                        continue           # budget spent: rides inert
                    before = _meter()
                    s.state, _, s.factors = self._refresh(s.state, s.arr,
                                                          1.0)
                    for n, d in _since(before).items():
                        metered[i][n] += d
                    s.age = 0
                    s.iters += 1
            # ghost fillers: an empty slot carries a live slot's arrays and
            # factors (shapes only: a ghost runs nothing)
            donor = live[0]
            for i, s in enumerate(self.slots):
                if s is None:
                    self.slots[i] = s = _Slot(
                        None, None, donor.arr,
                        sharded.init_state(donor.arr, self.default_rho,
                                           self.settings),
                        0, -1.0, BoundTracker())
                    s.live = False
                if s.factors is None:
                    s.factors = donor.factors
            slots = self.slots
            n_ghost = sum(1 for s in slots if not s.live)
            live_mask = [s.live for s in slots]
            n_live = [max(0, min(self.n_window, self.refresh_every - s.age,
                                 s.iter_limit - s.iters)) if s.live else 0
                      for s in slots]
            convthresh = [s.convthresh for s in slots]
            extra = {}
            if self.in_wheel:
                extra = dict(bound_live=live_mask, feas_tol=self.feas_tol)
            with _trace.span("batch", "window", live=len(live),
                             k=self.k_slots):
                states, packed = self._mega(
                    tuple(s.state for s in slots),
                    tuple(s.arr for s in slots), 1.0,
                    tuple(s.factors for s in slots), convthresh, n_live,
                    self.accept_tol, live_mask,
                    slot_launches=self.slot_launches,
                    slot_metrics=metered, **extra)
                meas = sharded.tenant_megastep_unpack(
                    hostsync.fetch(packed), self.n_window, self.S,
                    len(slots), bounds=self.in_wheel)
        wall = time.monotonic() - t0
        self.windows += 1
        _CTR_WINDOWS.inc(1)
        _CTR_GHOST_ROWS.inc(float(n_ghost * self.S))
        rows = [self.S * max(1, meas["executed"][i]) if s.live else 0
                for i, s in enumerate(slots)]
        shares = _flops.tenant_shares(rows)
        slack = _feas_slack(self.S, self.dt)
        reports = {}
        first = True
        for i, s in enumerate(slots):
            s.state = states[i]
            if not s.live:
                continue
            ex = int(meas["executed"][i])
            s.iters += ex
            s.age += ex
            if meas["refresh_hit"][i]:
                # a rejected iterate was discarded in the window: refresh
                # at the next boundary
                s.age = self.refresh_every
            fl = 0.0
            if ex:
                sweeps = float(np.mean(meas["iters"][i][:ex]))
                _segmented.bill_megastep(self.S, self.n, self.m, ex,
                                         sweeps, count_dispatch=first)
                fl += _flops.megastep_flops(self.S, self.n, self.m, ex,
                                            sweeps)
                first = False
            if self.in_wheel and meas["bound_computed"][i]:
                bsweeps = float(meas["bound_sweeps"][i])
                _segmented.bill_bound_pass(self.S, self.n, self.m,
                                           bsweeps, count_pass=(i == 0))
                fl += _flops.bound_pass_flops(self.S, self.n, self.m,
                                              bsweeps)
                s.tracker.outer_update(meas["bound_outer"][i])
                # the all-scenarios gate, per tenant: an inner bound only
                # where the whole batch was feasible, else the host rescue
                if meas["bound_inner_feas"][i] >= 1.0 - slack:
                    s.tracker.inner_update(meas["bound_inner_obj"][i])
                else:
                    self._maybe_rescue(s)
            abs_gap, rel_gap = s.tracker.gaps()
            if _trace.enabled():
                for nm, v in (("rel_gap", rel_gap), ("abs_gap", abs_gap),
                              ("best_outer", s.tracker.best_outer),
                              ("best_inner", s.tracker.best_inner)):
                    if np.isfinite(v):
                        _telemetry.tenant_counter(s.rid, s.trace_id,
                                                  nm, v, source="B")
            reports[s.rid] = {
                "executed": ex, "iters": s.iters,
                "outer": s.tracker.best_outer,
                "inner": s.tracker.best_inner,
                "abs_gap": abs_gap, "rel_gap": rel_gap,
                "wall_s": wall * shares[i], "flops": fl,
                "metered": metered[i],
                "exhausted": s.iters >= s.iter_limit,
            }
        return reports
