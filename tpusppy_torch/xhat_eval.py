"""Xhat_Eval: fix-and-evaluate candidate first-stage solutions.

Port of ``tpusppy/xhat_eval.py`` (the analogue of
``mpisppy/utils/xhat_eval.py:29-434``).  "Fixing" is a bound clamp on the
nonant columns of the batch (lb = ub = candidate) and the evaluation is one
batched ADMM solve, cold started, so trying a candidate costs one batched
solve: what makes the inner-bound spokes cheap.

Feasibility of the fixed problem is judged by the solver's primal residual
(the analogue of the reference's solver-status checks); an infeasible
candidate evaluates to +inf.

Integer recourse: the reference's external MIP solver returns integral
second-stage solutions natively; here a round-and-dive over cold batched
solves does (:meth:`Xhat_Eval._integer_dive`: fix near-integral integer
columns, force the most fractional one a row, re-solve; option
``xhat_dive_rounds``, default 12), then batched randomized-rounding retries
for the scenarios it wedged (:meth:`Xhat_Eval._retry_dive`) and host MILPs
for what is left (:meth:`Xhat_Eval._host_milp`; with
``xhat_integer_strategy`` "milp", for every scenario).

A shape-bucketed batch evaluates bucket by bucket
(:meth:`Xhat_Eval._fix_and_solve_bucketed`), an integer bucket through
the same integer machinery on its own sub-batch.
"""

from __future__ import annotations

import time

import numpy as np
import scipy.sparse as sp

from .ir import BucketedBatch
from .solvers import hostsync, scipy_backend
from .spopt import SPOpt, batch_solve_dispatch

#: What a bucket's evaluation swaps on the opt object, saved and restored
#: around it.
_BUCKET_SWAPPED = (
    "batch", "tree", "nid_sk", "_warm", "_factors", "_factors_sig",
    "_factors_age", "_factors_ref_worst", "_n_div_prev", "local_x",
    "pri_res", "dua_res", "_fixed_lb", "_fixed_ub", "_dev_consts",
    "_bucket_dev_consts", "_dev_state", "_last_all_done", "_cached_nonants",
    "_verify_csr", "_donor_dual_cache", "_donor_dual_age")


class Xhat_Eval(SPOpt):
    """An SPOpt that evaluates fixed first-stage candidates::

        ev = Xhat_Eval(options, names, scenario_creator, ...)
        z_hat = ev.evaluate(nonant_cache)   # expected objective, or +inf
    """

    def _round_int_nonants(self, cache):
        """Snap integer nonant coordinates of a candidate to integers
        (option ``xhat_round_ints``, default on); a no-op for continuous
        families."""
        if not self.options.get("xhat_round_ints", True):
            return cache
        nid = np.asarray(self.batch.tree.nonant_indices)
        ints = np.asarray(self.batch.is_int)[nid].astype(bool)
        if not ints.any():
            return cache
        cache = np.array(cache, dtype=float, copy=True)
        cache[..., ints] = np.round(cache[..., ints])
        return cache

    @staticmethod
    def _dive_round(x, ints, lb, ub, choose_up):
        """One dive clamp: snap near-integral (within 0.1) free integer
        columns, and where a row's most fractional free column is outside
        that band, force it toward the direction ``choose_up(B)`` picks
        (True: ceil).  Forced values are clipped into the current box
        first, so the box only tightens.  Returns the new (lb, ub), or None
        when nothing fractional is left."""
        free = ints[None, :] & (ub > lb)
        frac = np.where(free, np.abs(x - np.round(x)), -1.0)
        if not free.any() or frac.max() < 1e-6:
            return None
        near = free & (frac < 0.1)
        vals = np.round(np.where(near, x, 0.0))
        pick = frac.argmax(axis=1)
        # force only outside the snap band: a force would override a snap
        # and round a ~0.08 binary the wrong way
        has = free.any(axis=1) & (frac.max(axis=1) >= 0.1)
        B = x.shape[0]
        up = choose_up(B)
        force = np.zeros_like(near)
        force[np.arange(B), pick] = has
        fx = np.where(force, x, 0.0)
        fv = np.where(up[:, None], np.ceil(fx - 1e-9), np.floor(fx + 1e-9))
        vals = np.where(force, fv, vals)
        vals = np.clip(vals, lb, ub)
        clamp = near | force
        lb = np.where(clamp, np.maximum(vals, lb), lb)
        ub = np.where(clamp, np.minimum(vals, ub), ub)
        return lb, np.maximum(ub, lb)

    def _dive_solve(self, c, q2, cl, cu, lb, ub, rows=None, tile=1):
        """One cold batched solve of the dive (the engine's hand kernel on
        the card); returns the host (x, pri_res, dua_res)."""
        sol = batch_solve_dispatch(self.batch, c, q2, cl, cu, lb, ub,
                                   settings=self.admm_settings, rows=rows,
                                   tile=tile, device=self.device)
        return tuple(np.asarray(v, dtype=float) for v in hostsync.fetch(
            (sol.x, sol.pri_res, sol.dua_res)))

    def _integer_dive(self, lb, ub):
        """Drive the fractional integer columns integral: each round one
        cold batched solve, then :meth:`_dive_round` rounding the forced
        column up (covering rows stay satisfiable; the re-solve lets the
        free columns compensate).  At most ``xhat_dive_rounds`` (12)
        rounds."""
        b = self.batch
        rounds = max(1, int(self.options.get("xhat_dive_rounds", 12)))
        lb = np.array(lb, copy=True)
        ub = np.array(ub, copy=True)
        x = None
        for _ in range(rounds):
            x, self.pri_res, self.dua_res = self._dive_solve(
                b.c, b.q2, b.cl, b.cu, lb, ub)
            self.local_x = x
            nxt = self._dive_round(x, b.is_int, lb, ub,
                                   lambda B: np.ones(B, dtype=bool))
            if nxt is None:
                break
            lb, ub = nxt
        return x

    def _retry_dive(self, lb0, ub0, bad):
        """Batched randomized-rounding retries for the scenarios a plain
        dive wedged: each is tiled R times (``xhat_dive_retries``, 8), each
        replica rounds its forced column a random way (seed
        ``xhat_dive_seed``), and all re-dive together, in chunks of at most
        ``xhat_dive_retry_batch`` (512) rows.  Returns (solutions
        (len(bad), n), feasible flags): each scenario's best feasible,
        integral replica."""
        b = self.batch
        cap = max(1, int(self.options.get("xhat_dive_retry_batch", 512)))
        R = max(1, min(int(self.options.get("xhat_dive_retries", 8)), cap))
        rng = np.random.RandomState(
            int(self.options.get("xhat_dive_seed", 0)))
        ints = b.is_int
        tol = self._inwheel_feas_tol()
        rounds = max(1, int(self.options.get("xhat_dive_rounds", 12)))
        chunk = max(1, cap // R)
        xs = np.zeros((bad.size, b.num_vars))
        feas = np.zeros(bad.size, dtype=bool)
        for c0 in range(0, bad.size, chunk):
            sel = bad[c0:c0 + chunk]

            def tile(a):
                return np.repeat(a[sel], R, axis=0)

            c_t, q2_t = tile(b.c), tile(b.q2)
            cl_t, cu_t = tile(b.cl), tile(b.cu)
            lb_t, ub_t = tile(lb0), tile(ub0)
            x = pri = None
            for _ in range(rounds):
                x, pri, _ = self._dive_solve(c_t, q2_t, cl_t, cu_t, lb_t,
                                             ub_t, rows=sel, tile=R)
                nxt = self._dive_round(x, ints, lb_t, ub_t,
                                       lambda B: rng.rand(B) < 0.5)
                if nxt is None:
                    break
                lb_t, ub_t = nxt
            objs = (np.einsum("bn,bn->b", c_t, x)
                    + 0.5 * np.einsum("bn,bn->b", q2_t, x * x))
            frac = np.where(ints[None, :], np.abs(x - np.round(x)), 0.0)
            ok = (pri <= tol) & (frac.max(axis=1) < 1e-5)
            objs = np.where(ok, objs, np.inf)
            for i in range(sel.size):
                grp = objs[i * R:(i + 1) * R]
                j = int(np.argmin(grp))
                feas[c0 + i] = np.isfinite(grp[j])
                xs[c0 + i] = x[i * R + j]
        return xs, feas

    def _host_milp(self, lb, ub, only=None):
        """Per-scenario HiGHS MILPs with the nonants clamped (time limit
        ``xhat_mip_time_limit``, 2 s; gap ``xhat_mip_rel_gap``, 1e-4): the
        last resort when the dive and its retries wedge, or every
        scenario's evaluation under ``xhat_integer_strategy`` "milp".
        ``only``: the scenarios to solve.  Their host seconds add up in
        ``host_milp_secs``."""
        b = self.batch
        S = b.num_scenarios
        scens = range(S) if only is None else only
        xs = (np.array(self.local_x, copy=True) if self.local_x is not None
              else np.zeros((S, b.num_vars)))
        pri = np.zeros(S)
        limit = float(self.options.get("xhat_mip_time_limit", 2.0))
        gap = float(self.options.get("xhat_mip_rel_gap", 1e-4))
        t0 = time.perf_counter()
        for s in scens:
            res = scipy_backend.solve_lp(
                b.c[s], b.A[s], b.cl[s], b.cu[s], lb[s], ub[s],
                is_int=b.is_int, mip_rel_gap=gap, time_limit=limit)
            if res.feasible:
                xs[s] = res.x
            else:
                pri[s] = np.inf
        self.host_milp_secs = (getattr(self, "host_milp_secs", 0.0)
                               + time.perf_counter() - t0)
        self.local_x = xs
        self.pri_res = pri
        self.dua_res = np.zeros(S)
        return xs

    def _integer_evaluation(self):
        """The integer evaluation of the clamped batch: the dive, the
        batched retries for the scenarios it wedged (above the feasibility
        gate or still fractional), host MILPs for the rest; or host MILPs
        for every scenario under ``xhat_integer_strategy`` "milp" (families
        whose second stage is mostly binary scheduling)."""
        lb, ub = self._fixed_lb, self._fixed_ub
        if self.options.get("xhat_integer_strategy", "dive") == "milp":
            return self._host_milp(lb, ub)
        x = self._integer_dive(lb, ub)
        ints = self.batch.is_int[None, :]
        frac = np.where(ints, np.abs(x - np.round(x)), 0.0)
        bad = np.flatnonzero((np.asarray(self.pri_res)
                              > self._inwheel_feas_tol())
                             | (frac.max(axis=1) > 1e-5))
        if not bad.size:
            return x
        xs, feas = self._retry_dive(lb, ub, bad)
        x = np.array(x, copy=True)
        x[bad[feas]] = xs[feas]
        self.local_x = x
        pri = np.array(self.pri_res, copy=True)
        pri[bad[feas]] = 0.0
        self.pri_res = pri
        still = bad[~feas]
        if still.size:
            x = self._host_milp(lb, ub, only=still)
        return x

    def _fix_and_solve_bucketed(self, nonant_cache):
        """Fix-and-evaluate on a bucketed batch (``tpusppy/xhat_eval.py:
        202-257``): each bucket's sub-batch runs the homogeneous path in
        turn (the clamp, the cold solve and rescue; for an integer bucket
        the dive, the batched retries and the host-MILP residue), its
        results scattered into the bookkeeping layout.  The packed nonant
        slots are in the same order in every bucket as in the global tree
        (a bundle's root nonants, first).  Every solver-state attribute
        the path touches (:data:`_BUCKET_SWAPPED`: the slot, the fixing,
        the per-batch caches) is saved before the buckets run and restored
        after, so nothing keyed to a bucket outlives its evaluation; the
        device-A cache is keyed by content and the captured sweep loops by
        shape, so a bucket's entries there serve its next evaluation."""
        b = self.batch
        cache = np.asarray(nonant_cache, dtype=float)
        if cache.ndim == 1:
            cache = np.broadcast_to(cache, (b.num_scenarios, cache.shape[0]))
        S, n_max = b.c.shape
        x_out = np.zeros((S, n_max))
        pri = np.zeros(S)
        dua = np.zeros(S)
        saved = {k: getattr(self, k, None) for k in _BUCKET_SWAPPED}
        try:
            for idx, sub in b.buckets:
                self.batch = sub
                self.tree = sub.tree
                self.nid_sk = sub.tree.nid_sk()
                self._warm = self._factors = self._factors_sig = None
                self._factors_age = 0
                self.local_x = self.pri_res = self.dua_res = None
                x = self._fix_and_solve(cache[idx])
                x_out[idx, :sub.num_vars] = np.asarray(x)
                if self.pri_res is not None:
                    pri[idx] = np.asarray(self.pri_res)
                if self.dua_res is not None:
                    dua[idx] = np.asarray(self.dua_res)
        finally:
            for k, v in saved.items():
                setattr(self, k, v)
        self.local_x = x_out
        self.pri_res = pri
        self.dua_res = dua
        return x_out

    def _fix_and_solve(self, nonant_cache):
        """Clamp nonants to the candidate and solve the whole batch, cold
        (the clamped problem's geometry differs enough that stale warm
        duals slow ADMM down).  ``nonant_cache``: (K,) one candidate for
        every scenario, or (S, K) per scenario (multistage xhats fix
        per-node values).  Where the batch carries a model repair, the
        straggler rescue is off: the repair certifies feasibility.  A
        bucketed batch evaluates bucket by bucket."""
        if isinstance(self.batch, BucketedBatch):
            return self._fix_and_solve_bucketed(nonant_cache)
        nonant_cache = self._round_int_nonants(nonant_cache)
        self.fix_nonants(nonant_cache)
        try:
            b = self.batch
            if b.is_int.any() and bool(
                    (b.is_int[None, :]
                     & (self._fixed_ub > self._fixed_lb)).any()):
                return self._repair_and_verify(self._integer_evaluation())
            saved_rescue = self.options.get("straggler_rescue", True)
            if getattr(b, "repair_fn", None) is not None:
                self.options["straggler_rescue"] = False
            try:
                x = self.solve_loop(warm=False)
            finally:
                self.options["straggler_rescue"] = saved_rescue
            x = self._repair_and_verify(x)
        finally:
            self.restore_nonants()
        return x

    def _repair_and_verify(self, x):
        """Model-declared feasibility repair (``batch.repair_fn``) and exact
        verification against the original rows and bounds: verified
        scenarios get a zero residual, the rest their true violation.  A
        no-op for families without a repair."""
        rf = getattr(self.batch, "repair_fn", None)
        if rf is None:
            return x
        b = self.batch
        x = rf(np.asarray(x, float), b)
        key = (id(b.A_shared if b.A_shared is not None else b.A), b.version)
        cached = getattr(self, "_verify_csr", None)
        if cached is None or cached[0] != key:
            self._verify_csr = (key, sp.csr_matrix(b.A_shared)
                                if b.A_shared is not None else None)
            cached = self._verify_csr
        tol = float(self.options.get("repair_verify_tol", 1e-6))
        if cached[1] is not None:
            r = np.asarray((cached[1] @ x.T).T)          # (S, m)
        else:
            r = np.einsum("smn,sn->sm", np.asarray(b.A), x)
        scale = np.maximum(1.0, np.maximum(
            np.abs(np.where(np.isfinite(b.cl), b.cl, 0.0)),
            np.abs(np.where(np.isfinite(b.cu), b.cu, 0.0))))
        row_viol = np.maximum(np.maximum(b.cl - r, r - b.cu), 0.0) / scale
        bscale = np.maximum(1.0, np.maximum(
            np.abs(np.where(np.isfinite(b.lb), b.lb, 0.0)),
            np.abs(np.where(np.isfinite(b.ub), b.ub, 0.0))))
        bnd_viol = np.maximum(np.maximum(b.lb - x, x - b.ub), 0.0) / bscale
        pri = np.maximum(row_viol.max(axis=1), bnd_viol.max(axis=1))
        self.local_x = x
        self.pri_res = np.where(pri <= tol, 0.0, pri + 1.0)
        self.dua_res = np.zeros(b.num_scenarios)
        return x

    def evaluate_one(self, nonant_cache, scenario_index: int) -> float:
        """Objective of ONE scenario at the fixed candidate
        (xhat_eval.py:261-292)."""
        x = self._fix_and_solve(nonant_cache)
        if self.pri_res is not None:
            tol = self.options.get("feas_tol", 1e-3)
            if self.pri_res[scenario_index] > tol:
                return np.inf
        return float(self.batch.objective(x)[scenario_index])

    def evaluate(self, nonant_cache) -> float:
        """Expected objective at the fixed candidate; +inf if any scenario
        is infeasible (xhat_eval.py:293-330 + feas_prob check)."""
        x = self._fix_and_solve(nonant_cache)
        if self.feas_prob() < 1.0 - 1e-9:
            return np.inf
        return float(self.probs @ self.batch.objective(x))

    def objective_values(self, nonant_cache) -> np.ndarray:
        """(S,) per-scenario objectives at the fixed candidate."""
        x = self._fix_and_solve(nonant_cache)
        return self.batch.objective(x)
