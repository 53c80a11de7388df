"""Xhat_Eval: fix-and-evaluate candidate first-stage solutions.

Port of ``tpusppy/xhat_eval.py`` (the analogue of
``mpisppy/utils/xhat_eval.py:29-434``), its LP path.  "Fixing" is a bound
clamp on the nonant columns of the batch (lb = ub = candidate) and the
evaluation is one batched ADMM solve, cold started, so trying a candidate
costs one batched solve: what makes the inner-bound spokes cheap.

Feasibility of the fixed problem is judged by the solver's primal residual
(the analogue of the reference's solver-status checks); an infeasible
candidate evaluates to +inf.

A shape-bucketed batch evaluates bucket by bucket
(:meth:`Xhat_Eval._fix_and_solve_bucketed`), continuous buckets only.

Not ported yet: the integer paths (the round-and-dive, its batched retries
and the host MILP: ROADMAP Queue 1 item 6); a candidate that leaves integer
columns free, and an integer bucket, raise.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .ir import BucketedBatch
from .spopt import SPOpt

#: What a bucket's evaluation swaps on the opt object, saved and restored
#: around it.
_BUCKET_SWAPPED = (
    "batch", "tree", "nid_sk", "_warm", "_factors", "_factors_sig",
    "_factors_age", "_factors_ref_worst", "_n_div_prev", "local_x",
    "pri_res", "dua_res", "_fixed_lb", "_fixed_ub", "_dev_consts",
    "_bucket_dev_consts", "_dev_state", "_last_all_done")


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

    def _fix_and_solve_bucketed(self, nonant_cache):
        """Fix-and-evaluate on a bucketed batch (``tpusppy/xhat_eval.py:
        202-257``): each bucket's sub-batch runs the homogeneous path
        (clamp, cold solve, rescue) in turn, its results scattered into
        the bookkeeping layout.  The packed nonant slots are in the same
        order in every bucket as in the global tree (a bundle's root
        nonants, first).  An integer bucket raises: its dive is not ported
        yet (ROADMAP Queue 1 item 6)."""
        b = self.batch
        for _, sub in b.buckets:
            if np.asarray(sub.is_int).any():
                raise NotImplementedError(
                    "Xhat_Eval on a bucketed batch with integer columns: "
                    "the bucketed integer evaluation is not ported yet "
                    "(ROADMAP Queue 1 item 6)")
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
                raise NotImplementedError(
                    "Xhat_Eval: a candidate that leaves integer columns "
                    "free needs the integer dive, not ported yet (ROADMAP "
                    "Queue 1 item 6)")
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
