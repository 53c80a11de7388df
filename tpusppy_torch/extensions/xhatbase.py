"""XhatBase: in-hub incumbent (inner-bound) finders.

A copy of ``tpusppy/extensions/xhatbase.py`` (the analogue of
``mpisppy/extensions/xhatbase.py:38-230``).  The core primitive ``_try_one``
fixes the nonant columns to a candidate, solves the whole scenario batch in
one batched solve, takes the probability-weighted objective, and restores
state — the reference's fix/solve-all/restore loop collapsed into a bound
clamp + one batched ADMM call.

Multistage candidates are built from *donor scenarios per tree node*: the
candidate value of nonant slot k in scenario s is taken from the donor scenario
of the node owning (s, k).  Any donor assignment yields a nonanticipative
candidate; two-stage reduces to a single donor (the reference's
"xhat from one scenario").
"""

from __future__ import annotations

import numpy as np

from .extension import Extension


def donor_cache(opt, xk: np.ndarray, donors) -> np.ndarray:
    """(S, K) candidate cache from per-node donor scenarios.

    Args:
      opt: an SPOpt-derived object (provides tree indexing).
      xk: (S, K) nonant values to draw from.
      donors: (N,) int array, or dict {node_name: scenario index}, or a single
        int (two-stage convenience: that scenario donates everywhere it can,
        other nodes fall back to their first member scenario).
    """
    tree = opt.tree
    N = tree.num_nodes
    nid = opt.nid_sk                    # (S, K)
    if isinstance(donors, (int, np.integer)):
        base = int(donors)
        arr = np.zeros(N, dtype=np.int64)
        member = tree.membership_matrix()   # (N, S)
        for n_ in range(N):
            arr[n_] = base if member[n_, base] > 0 else int(
                np.argmax(member[n_] > 0)
            )
        donors = arr
    elif isinstance(donors, dict):
        arr = np.zeros(N, dtype=np.int64)
        name_to_id = {nm: i for i, nm in enumerate(tree.node_names)}
        for nm, s in donors.items():
            arr[name_to_id[nm]] = int(s)
        donors = arr
    donors = np.asarray(donors, dtype=np.int64)
    kidx = np.arange(nid.shape[1])[None, :]
    return xk[donors[nid], kidx]


def slam_cache(opt, xk: np.ndarray, how: str = "max") -> np.ndarray:
    """Per-node max/min "slamming" candidate (cylinders/slam_heuristic.py:24-125).

    For each nonant slot, takes the max (or min) over the scenarios of its
    owning node — a cheap integer-friendly incumbent guess.
    """
    assert how in ("max", "min")
    onehot = opt.tree.onehot_sk_n()        # (S, K, N)
    big = np.inf if how == "min" else -np.inf
    vals = np.where(onehot.transpose(2, 0, 1) > 0, xk[None], big)  # (N, S, K)
    agg = vals.max(axis=1) if how == "max" else vals.min(axis=1)   # (N, K)
    kidx = np.arange(xk.shape[1])[None, :]
    return agg[opt.nid_sk, kidx]


class XhatBase(Extension):
    """Base for in-hub xhat finders; tracks the best inner bound on the opt
    object (``opt.best_inner_bound`` / ``opt.best_xhat_cache``)."""

    def __init__(self, spopt_object):
        super().__init__(spopt_object)
        opt = self.opt
        if not hasattr(opt, "best_inner_bound"):
            opt.best_inner_bound = np.inf
            opt.best_xhat_cache = None

    # ---- the primitive ------------------------------------------------------
    def _try_one(self, cache, restore=True) -> float:
        """Evaluate one candidate; returns expected objective or +inf.

        Saves and restores the opt object's solver state so PH's warm starts
        and current iterate are unperturbed (the reference's
        _fix_nonants/._restore_nonants bracketing, xhatbase.py:38-230).
        """
        opt = self.opt
        saved = (opt._warm, opt.local_x, opt.pri_res, opt.dua_res)
        try:
            opt.fix_nonants(cache)
            x = opt.solve_loop(warm=False)
            if opt.feas_prob() < 1.0 - 1e-9:
                return np.inf
            obj = float(opt.probs @ opt.batch.objective(x))
        finally:
            opt.restore_nonants()
            if restore:
                opt._warm, opt.local_x, opt.pri_res, opt.dua_res = saved
        return obj

    def _update_if_improving(self, obj: float, cache) -> bool:
        if obj < self.opt.best_inner_bound:
            self.opt.best_inner_bound = obj
            self.opt.best_xhat_cache = np.asarray(cache).copy()
            return True
        return False

    def try_scenario(self, s: int) -> float:
        """Candidate = donor scenario s's nonants (per-node completion)."""
        xk = self.opt.nonants_of(self.opt.local_x)
        cache = donor_cache(self.opt, xk, int(s))
        obj = self._try_one(cache)
        self._update_if_improving(obj, cache)
        return obj
