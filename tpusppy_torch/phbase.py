"""PHBase: Progressive Hedging state and iteration.

Port of the legacy per-iteration loop of ``tpusppy/phbase.py``.  PH state —
duals W, penalty rho, node averages xbar — are (S, K) host arrays over the
packed nonant layout; ``Compute_Xbar`` is a one-hot node-membership
contraction and ``convergence_diff`` the scaled L1 deviation from xbar.  The
augmented objective ``W.x + (rho/2)(x - xbar)^2`` is a (q, q2) override for
the batched ADMM solve.

The device-resident megastep (N iterations per dispatch) is not part of this
slice: every iteration runs the legacy loop, the path the reference takes
under ``solver_options={"megastep": 1}``.  In a wheel the opt object's
``spcomm`` (its hub or spoke communicator) syncs after Iter0 and after every
iteration and may end the loop (``is_converged``).
"""

from __future__ import annotations

import numpy as np

from . import global_toc
from .obs import trace as _trace
from .spopt import SPOpt
from .extensions.extension import Extension


class PHBase(SPOpt):
    """PH state + iteration drivers (Iter0 / iterk_loop / post_loops)."""

    def __init__(self, *args, extensions=None, **kwargs):
        super().__init__(*args, **kwargs)
        self._options_check(["defaultPHrho", "PHIterLimit"], self.options)
        K = self.nonant_length
        S = self.batch.num_scenarios

        self.W = np.zeros((S, K))
        self.xbars = np.zeros((S, K))       # per-scenario view of node xbar
        self.xsqbars = np.zeros((S, K))
        self.rho = np.full((S, K), float(self.options["defaultPHrho"]))
        self.W_on = True
        self.prox_on = True
        self.conv = None
        self._iter = 0
        self.extobject = (extensions or Extension)(self)

        # node-membership one-hot for the xbar contraction: (S, K, N)
        self._onehot = self.tree.onehot_sk_n()

    # ---- reductions ---------------------------------------------------------
    def _nonants_cached(self) -> np.ndarray:
        """(S, K) nonants of the CURRENT ``local_x``, gathered once per
        solve (keyed on the ``local_x`` object: every solve assigns a fresh
        array)."""
        if getattr(self, "_xk_src", None) is not self.local_x:
            self._xk = self.nonants_of(self.local_x)
            self._xk_src = self.local_x
        return self._xk

    def _node_avgs(self, xk):
        """(xbars, xsqbars) as scenario-indexed (S, K): per-node
        probability-weighted E[x] and E[x^2]."""
        p = self.probs[:, None]                                  # (S, 1)
        num = np.einsum("skn,sk->nk", self._onehot, p * xk)      # (N, K)
        sqnum = np.einsum("skn,sk->nk", self._onehot, p * xk * xk)
        den = np.einsum("skn,sk->nk", self._onehot, np.broadcast_to(p, xk.shape))
        den = np.maximum(den, 1e-300)
        kidx = np.arange(self.nonant_length)[None, :]
        return ((num / den)[self.nid_sk, kidx],
                (sqnum / den)[self.nid_sk, kidx])

    @property
    def sync_version(self):
        """Monotone token of the hub-visible PH state (W, nonants,
        iteration): the hub's mailbox writes skip when it has not
        advanced."""
        return (self._iter, getattr(self, "_state_version", 0))

    def _bump_state_version(self):
        self._state_version = getattr(self, "_state_version", 0) + 1

    def Compute_Xbar(self, verbose=False):
        """Per-node weighted averages of nonants (phbase.py:27-107)."""
        xk = self._nonants_cached()
        self.xbars, self.xsqbars = self._node_avgs(xk)
        if verbose:
            global_toc(f"xbar[:8]={self.xbars[0][:8]}")

    def Update_W(self, verbose=False):
        """Dual update W += rho (x - xbar) (phbase.py:293-318)."""
        xk = self._nonants_cached()
        self.W = self.W + self.rho * (xk - self.xbars)
        self._bump_state_version()
        if verbose:
            global_toc(f"W[0][:8]={self.W[0][:8]}")

    def convergence_diff(self) -> float:
        """Scaled norm of x - xbar (phbase.py:321-343)."""
        xk = self._nonants_cached()
        dev = np.abs(xk - self.xbars).mean(axis=1)
        return float(self.probs @ dev)

    # ---- augmented objective ------------------------------------------------
    def _augmented_q(self):
        """(q, q2) for the PH subproblem (attach_PH_to_objective)."""
        idx = self.tree.nonant_indices
        q = np.array(self.batch.c, copy=True)
        if self.W_on:
            q[:, idx] += self.W
        if self.prox_on:
            q[:, idx] += -self.rho * self.xbars
        return q, self._augmented_q2()

    def _augmented_q2(self):
        q2 = np.array(self.batch.q2, copy=True)
        if self.prox_on:
            q2[:, self.tree.nonant_indices] += self.rho
        return q2

    def solve_ph_subproblems(self):
        self.extobject.pre_solve_loop()
        q, q2 = self._augmented_q()
        self.solve_loop(q=q, q2=q2)
        self.extobject.post_solve_loop()

    # ---- drivers ------------------------------------------------------------
    def Iter0(self) -> float:
        """Initial solves with W and prox off; returns the trivial bound
        (phbase.py:758-872)."""
        self.extobject.pre_iter0()
        self._iter = 0
        with _trace.span(None, "iter0"):
            self.solve_loop()  # plain objective
        feas = self.feas_prob()
        if feas < 1.0 - 1e-6:
            # residuals above feas_tol are either a truly infeasible
            # scenario (the reference's hard quit) or a first-order solver
            # plateau: check the worst offenders host-exactly
            from .solvers import scipy_backend

            tol = self._feas_tol()
            pri0 = np.asarray(self.pri_res)
            bad = np.flatnonzero(~(pri0 <= tol))
            key = np.where(np.isnan(pri0[bad]), np.inf, pri0[bad])
            worst = bad[np.argsort(-key)][:16]
            b = self.batch
            truly_bad = []
            for s in worst:
                r = scipy_backend.solve_lp(
                    np.zeros(b.num_vars), b.A[s], b.cl[s], b.cu[s],
                    b.lb[s], b.ub[s])
                if not r.feasible:
                    truly_bad.append(int(s))
            if truly_bad:
                raise RuntimeError(
                    f"Infeasibility detected at iter0; feasible mass "
                    f"{feas:.4f}, host-verified infeasible scenarios "
                    f"{truly_bad} (cf. phbase.py:818-823 hard quit)"
                )
            checked_all = len(worst) == bad.size
            global_toc(
                f"iter0: {bad.size} scenario(s) above feas_tol are a "
                "solver plateau (host feasibility check passed on "
                + ("ALL of them" if checked_all
                   else f"the {len(worst)} worst — a sampled check")
                + ") — continuing", True)
        # CERTIFIED trivial bound: weak duality, not the primal objective
        self.trivial_bound = self.Edualbound()
        eb = self.Ebound()
        if np.isfinite(eb) and abs(eb - self.trivial_bound) > \
                1e-3 * max(1.0, abs(eb)):
            global_toc(
                f"iter0: certified trivial bound {self.trivial_bound:.4e} "
                f"(primal objective {eb:.4e} is solver-tolerance-loose "
                "and NOT used as a bound)", True)
        self.Compute_Xbar()
        self.Update_W()
        self.conv = self.convergence_diff()
        self.extobject.post_iter0()
        if self.spcomm is not None:
            self.spcomm.sync()
            self.extobject.post_iter0_after_sync()
        global_toc(
            f"Iter0 trivial bound {self.trivial_bound:.4f} conv {self.conv:.3e}",
            self.options.get("display_progress", False),
        )
        return self.trivial_bound

    def iterk_loop(self):
        """Main PH loop (phbase.py:875-979), one legacy iteration at a
        time."""
        convthresh = self.options.get("convthresh", 0.0)
        max_iters = self.options["PHIterLimit"]
        k = self._iter + 1     # continues a carried state (convert.py)
        while k <= max_iters:
            k = self._iterk_one(k, convthresh)
            if k is None:
                break
            k += 1

    def _iterk_one(self, k, convthresh):
        """One legacy PH iteration.  Returns ``k`` to continue, or None to
        terminate the loop."""
        self._iter = k
        with _trace.span(None, "ph_iter") as _sp:
            self.extobject.miditer()
            self.solve_ph_subproblems()
            self.Compute_Xbar()
            self.Update_W()
            self.conv = self.convergence_diff()
            if _trace.enabled():
                _sp.add(iter=k, conv=self.conv)
            self.extobject.enditer()
        if self.spcomm is not None:
            self.spcomm.sync()
            self.extobject.enditer_after_sync()
            if self.spcomm.is_converged():
                global_toc("Cylinder termination", True)
                return None
        if self.options.get("display_progress", False):
            global_toc(f"PH iter {k} conv {self.conv:.6e} "
                       f"Eobj {self.Eobjective():.4f}")
        if self.conv is not None and self.conv < convthresh:
            global_toc(
                f"Convergence threshold {convthresh} reached at iter {k}",
                self.options.get("display_progress", False),
            )
            return None
        return k

    def post_loops(self) -> float:
        """Final expected objective (phbase.py:982-1037)."""
        self.extobject.post_everything()
        return self.Eobjective()
