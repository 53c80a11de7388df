"""PHBase: Progressive Hedging state and iteration.

Port of the legacy per-iteration loop of ``tpusppy/phbase.py``.  PH state —
duals W, penalty rho, node averages xbar — are (S, K) host arrays over the
packed nonant layout; ``Compute_Xbar`` is a one-hot node-membership
contraction and ``convergence_diff`` the scaled L1 deviation from xbar.  The
augmented objective ``W.x + (rho/2)(x - xbar)^2`` is a (q, q2) override for
the batched ADMM solve.

The wheel megastep is the default, as in the reference: where its gates
allow (:meth:`PHBase._megastep_request`), ``iterk_loop`` runs the frozen
iterations in windows of N (:mod:`.parallel.sharded`), the PH update on the
device and one packed fetch a window, and the legacy per-iteration body
refreshes between windows.  ``solver_options={"megastep": 1}`` keeps the
legacy loop throughout, ``{"megastep": k}`` asks for N = k.  With the
``in_wheel_bounds`` option each window ends with the Lagrangian outer and
xhat-at-xbar inner bound pass, posted to the hub as source ``'M'``, so a
hub with no spokes certifies a gap by itself.  In a wheel the opt object's
``spcomm`` (its hub or spoke communicator) syncs after Iter0 and after every
legacy iteration or window and may end the loop (``is_converged``).

A shape-bucketed batch (bundles of two sizes, :class:`~.ir.BucketedBatch`)
runs the same protocol: its legacy iterations solve bucket by bucket, and
its windows run every bucket's frozen solve with one PH update across the
buckets (:meth:`PHBase._megastep_dispatch`); a window opens when every
bucket's slot is ready, and the oldest bucket's factors bound its width
(:meth:`PHBase._mega_age`); its bound pass sums each bucket's partial
sums, and its integer pass drops the SLAM slams (a node's extreme over
one bucket is not nonanticipative across buckets).

An integer family's in-wheel bounds take the integer tiers
(:mod:`.solvers.integer`): each bound pass runs the batched rounding sweep
and reduced-cost fixing on the device, the host rescue sweeps the same
ladder, a family with second-stage integers certifies its candidates by
host MIPs (source ``'I'``), and the gap-ranked MILP escalation lifts the
outer bound within one shared host budget
(``integer_escalation_budget_s``).

Not ported yet, and raising ``NotImplementedError`` when asked for: the
autotuned window width, bound cadence and integer ladder
(``megastep_autotune``, ``in_wheel_bound_autotune``,
``in_wheel_int_autotune``; ROADMAP Queue 1 item 5).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from . import global_toc
from .ir import BucketedBatch, batch_parts
from .obs import metrics as _metrics
from .obs import trace as _trace
from .solvers import hostsync, segmented
from .solvers import integer as integer_solvers
from .spopt import SPOpt
from .extensions.extension import Extension

#: PH options that only parts not ported yet read.
UNPORTED_OPTIONS = {
    "megastep_autotune": "Queue 1 item 5 (the autotuner)",
    "in_wheel_bound_autotune": "Queue 1 item 5 (the autotuner)",
    "in_wheel_int_autotune": "Queue 1 item 5 (the autotuner)",
}


def _check_options(opt):
    """Raise on an option only a part not ported yet reads."""
    for name, item in UNPORTED_OPTIONS.items():
        if opt.options.get(name):
            raise NotImplementedError(
                f"option {name!r} is not ported yet (ROADMAP {item})")


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
        _check_options(self)

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

            tol = self._inwheel_feas_tol()
            pri0 = np.asarray(self.pri_res)
            bad = np.flatnonzero(~(pri0 <= tol))
            key = np.where(np.isnan(pri0[bad]), np.inf, pri0[bad])
            worst = bad[np.argsort(-key)][:16]
            truly_bad = []
            for s in worst:
                sub, j = self._scenario_part(s)
                r = scipy_backend.solve_lp(
                    np.zeros(sub.num_vars), sub.A[j], sub.cl[j], sub.cu[j],
                    sub.lb[j], sub.ub[j])
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
        self._apply_resume()
        self.conv = self.convergence_diff()
        self.extobject.post_iter0()
        if self.spcomm is not None:
            self.spcomm.sync()
            self.extobject.post_iter0_after_sync()
        global_toc(
            f"Iter0 trivial bound {self.trivial_bound:.4f} conv {self.conv:.3e}",
            self.options.get("display_progress", False),
        )
        # the service tier's time-to-first-iteration seam: a hook fault
        # never costs the run
        cb = self.options.get("on_iter0_done")
        if cb is not None:
            try:
                cb()
            except Exception:
                pass
        return self.trivial_bound

    def _apply_resume(self):
        """Re-seat checkpointed PH state where a resume was asked for
        (the spinner sets ``_resume_ckpt``), at the end of Iter0: the plain
        warm-up solve has filled the warm state and the trivial bound, and
        the W, xbars and rho it derived are replaced by the checkpoint's
        (:func:`.resilience.checkpoint.restore_ph`), which also sets
        ``_iter_base``: :meth:`iterk_loop` starts past it, so
        ``PHIterLimit`` stays the total across restarts.  The factors are
        Iter0's, built without the prox term, so the first resumed
        iteration refreshes.  Warm duals are not checkpointed (as in the
        reference): a resumed run agrees with an uninterrupted one to
        solver tolerance, not bit for bit."""
        ck = getattr(self, "_resume_ckpt", None)
        if ck is None:
            return
        from .resilience import checkpoint as _ckpt

        _ckpt.restore_ph(self, ck)
        # the state is the checkpoint's iteration's: Iter0's sync (and its
        # capture, where one is due) sees that iteration
        self._iter = self._iter_base
        self._resume_ckpt = None

    def _scenario_part(self, s):
        """``(part, row)``: the batch part (a bucket's sub-batch, or the
        batch) holding scenario ``s``, and its row there."""
        for idx, sub in batch_parts(self.batch):
            hit = np.flatnonzero(np.asarray(idx) == s)
            if hit.size:
                return sub, int(hit[0])
        raise IndexError(s)

    # ---- the wheel megastep (N frozen iterations a window) ------------------
    def _megastep_request(self) -> int:
        """The window width N (>= 2) when megastep windows may drive this
        hub's iterations, else 0 (the legacy loop throughout).

        Gates, each falling back to legacy: ``ADMMSettings.megastep`` (1 is
        legacy); the trivial extension (a callout per iteration cannot run
        inside a window); no nonant fixing; W and prox on; a frozen
        cadence (``solver_refresh_every`` > 2).  N is the megastep setting
        when it is above 1, else the refresh window ``refresh_every - 1``
        (one legacy refresh and one window per cadence block), within the
        card's cap (:func:`.solvers.segmented.megastep_cap`).  The H100 has
        no segmentation regime, so no shape is sent to legacy, and a
        bucketed batch takes the same cap (its window runs every bucket's
        solve an iteration, as the reference's; the reference sums the
        buckets' TPU worst cases against a worker's kill, which the card
        has no counterpart of)."""
        st = self.admm_settings
        req = int(st.megastep or 0)
        if req == 1:
            return 0
        if type(self.extobject) is not Extension:
            return 0
        if self._fixed_lb is not None or self._fixed_ub is not None:
            return 0
        if not (self.W_on and self.prox_on):
            return 0
        refresh_every = self._refresh_every()
        if refresh_every <= 2:
            return 0
        cap = self._megastep_cap_with_bounds(
            lambda bp: segmented.megastep_cap(bound_pass=bp))
        n_sel = req if req > 1 else refresh_every - 1
        n_sel = min(n_sel, refresh_every - 1, cap)
        return n_sel if n_sel >= 2 else 0

    def _mega_age(self) -> int:
        """The factors' age a window reads: the homogeneous slot's, or the
        OLDEST bucket slot's (every bucket sweeps in each window
        iteration, so the stalest factors bound the window)."""
        if isinstance(self.batch, BucketedBatch):
            slots = getattr(self, "_bucket_slots", None) or []
            if not slots:
                return 10 ** 9
            return max(s.get("age", 0) for s in slots)
        return self._factors_age

    def _mega_slots_ready(self, refresh_every) -> bool:
        """Factors and warm state present, not aged out, and the factors'
        validity signature matching the PH objective's (each bucket's, on
        a bucketed batch)."""
        b = self.batch
        if isinstance(b, BucketedBatch):
            slots = getattr(self, "_bucket_slots", None)
            if not slots or len(slots) != len(b.buckets):
                return False
            q2_full = self._augmented_q2()
            lb, ub = (np.asarray(v) for v in self._bounds())
            for (idx, sub), slot in zip(b.buckets, slots):
                if slot.get("warm") is None or slot.get("factors") is None:
                    return False
                if slot.get("age", 0) >= refresh_every:
                    return False
                n = sub.num_vars
                if self._solve_sig(q2_full[idx, :n], lb[idx, :n],
                                   ub[idx, :n]) != slot.get("sig"):
                    return False
            return True
        if self._factors is None or self._warm is None:
            return False
        if self._factors_age >= refresh_every:
            return False
        return self._solve_sig(self._augmented_q2(), *self._bounds()) \
            == self._factors_sig

    def _megastep_dispatch(self, n_req, n_live, convthresh,
                           bound_live=None):
        """One window on the homogeneous or the bucketed path."""
        solve = (self._megastep_solve_bucketed
                 if isinstance(self.batch, BucketedBatch)
                 else self._megastep_solve)
        return solve(n_req, n_live, convthresh, self.W, self.xbars,
                     self.rho, bound_live=bound_live)

    # ---- in-wheel certification ---------------------------------------------
    def _megastep_cap_with_bounds(self, cap_fn):
        """The window cap with the bound pass's reservation; where the
        reservation would leave no megastep (a cap under 2), in-wheel
        certification is declined for this family, loudly, and the plain
        cap kept."""
        if not self._inwheel_on():
            return cap_fn(False)
        # the reservation counts the pass's frozen evaluations: C
        # candidates and a re-certification for the integer sweep
        cap = cap_fn(self._inwheel_pass_evals())
        if cap >= 2:
            return cap
        cap_plain = cap_fn(False)
        if cap_plain >= 2 and not getattr(self, "_inwheel_cap_declined",
                                          False):
            self._inwheel_cap_declined = True
            global_toc(
                "in_wheel_bounds: the bound pass's reservation would leave "
                "no megastep for this shape: in-wheel certification "
                "declined (bound spokes remain the certification path)",
                True)
        return cap_plain

    def _inwheel_on(self) -> bool:
        """Whether windows run the bound pass: option ``in_wheel_bounds``,
        minimization only (the weak-duality assembly and the feasibility
        gate are minimization's, like the spokes they replace)."""
        if not self.options.get("in_wheel_bounds"):
            return False
        if getattr(self, "_inwheel_cap_declined", False):
            return False
        if not self.is_minimizing:
            if not getattr(self, "_inwheel_min_warned", False):
                self._inwheel_min_warned = True
                global_toc(
                    "in_wheel_bounds: maximization families are not "
                    "supported (bound spokes remain the certification "
                    "path): disabled", True)
            return False
        return True

    def _inwheel_inner_ok(self) -> bool:
        """Whether the in-wheel INNER bound may be taken: every integer
        column is a nonant slot (the candidate rounds those; a
        second-stage integer would need the integer evaluation)."""
        ok = getattr(self, "_inwheel_inner_ok_cache", None)
        if ok is None:
            ok = True
            for _, sub in batch_parts(self.batch):
                free = np.ones(sub.num_vars, dtype=bool)
                free[sub.tree.nonant_indices] = False
                if np.asarray(sub.is_int, bool)[free].any():
                    ok = False
                    break
            self._inwheel_inner_ok_cache = ok
            if not ok:
                global_toc(
                    "in_wheel_bounds: second-stage integer columns: the "
                    "in-wheel INNER bound is not certified (outer only)",
                    True)
        return ok

    def _inwheel_every(self) -> int:
        """Bound-pass cadence in windows: ``in_wheel_bound_every``, else
        every window."""
        every = self.options.get("in_wheel_bound_every")
        return max(1, int(every)) if every else 1

    def _install_inwheel_outer(self, ob: float, char: str = 'M'):
        """Track and install one certified in-wheel outer bound (source
        ``'M'``, the window's pass; ``'I'``, the integer escalation)."""
        if not np.isfinite(ob):
            return
        if ob > getattr(self, "inwheel_outer_bound", -np.inf):
            self.inwheel_outer_bound = ob
            self.inwheel_outer_source = char
        c = self.spcomm
        if c is not None and hasattr(c, "OuterBoundUpdate"):
            c.OuterBoundUpdate(ob, char=char)

    def _consume_inwheel_bounds(self, meas):
        """Install one window's bound evidence through the hub's typed
        updates (source char ``'M'``), so gaps and termination see it as
        they see spoke bounds; tracked on the opt too for runs without a
        hub.  The inner bound is offered only when the evaluation was
        feasible on the whole batch (the all-scenarios rule, with a
        dtype-aware slack) and is a true candidate value; a miss counts in
        ``megastep.bound_pass_infeasible`` and may run the host rescue.
        An integer pass also counts its candidates, feasible candidates
        and fixed slots (``integer.*``); on a family with second-stage
        integers its best candidate is certified by host MIPs instead, and
        every pass may run one round of the gap-ranked escalation."""
        if not meas.get("bound_computed"):
            return
        self._install_inwheel_outer(float(meas["bound_outer"]))
        int_pass = "int_best_idx" in meas
        if int_pass:
            _metrics.inc("integer.candidates", integer_solvers.n_candidates(
                self._inwheel_int_thresholds()))
            _metrics.inc("integer.feasible_hits", meas["int_feas_cands"])
            _metrics.inc("integer.rcfix_slots", meas["int_rcfix_slots"])
            self._int_best_idx = meas["int_best_idx"]
        slack = integer_solvers.feas_slack(self.batch.num_scenarios,
                                           self.admm_settings.tdtype())
        feasible = meas["bound_inner_feas"] >= 1.0 - slack
        if feasible and self._inwheel_inner_ok():
            self.inwheel_inner_source = "M"
            self._offer_inwheel_inner(float(meas["bound_inner_obj"]))
        elif int_pass and not self._inwheel_inner_ok():
            # second-stage integers: the device evaluation relaxes them,
            # and the LP rescue cannot certify either; host MIPs can
            if not feasible:
                _metrics.inc("megastep.bound_pass_infeasible")
            self._maybe_integer_inner_mip(meas["int_best_idx"])
        elif not feasible:
            _metrics.inc("megastep.bound_pass_infeasible")
            self._maybe_inwheel_rescue()
        self._maybe_integer_escalation()

    def _offer_inwheel_inner(self, ib: float, char: str = 'M'):
        """Track and install one certified in-wheel incumbent value
        (source ``'M'``, the window's pass or the host rescue; ``'I'``, the
        integer escalation)."""
        if not np.isfinite(ib):
            return
        if ib < getattr(self, "inwheel_inner_bound", np.inf):
            self.inwheel_inner_bound = ib
        c = self.spcomm
        if c is not None and hasattr(c, "InnerBoundUpdate"):
            c.InnerBoundUpdate(ib, char=char)

    def _maybe_inwheel_rescue(self):
        """Cadence gate in front of :meth:`_inwheel_host_rescue`: the
        first feasibility-gate miss, then every ``in_wheel_rescue_every``-th
        (default 4: a rescue is S host LPs).  A declined rescue retries
        after a growing backoff (the next miss, then 2 on, ... up to the
        cadence).  ``in_wheel_host_rescue=False`` turns it off."""
        if not self.options.get("in_wheel_host_rescue", True):
            return
        if not self._inwheel_inner_ok():
            return
        every = max(1, int(self.options.get("in_wheel_rescue_every", 4)))
        miss = getattr(self, "_inwheel_gate_misses", 0)
        self._inwheel_gate_misses = miss + 1
        if miss < getattr(self, "_inwheel_next_rescue", 0):
            return
        ib = self._inwheel_host_rescue()
        if ib is None:
            declines = getattr(self, "_inwheel_rescue_declines", 0) + 1
            self._inwheel_rescue_declines = declines
            self._inwheel_next_rescue = miss + min(declines, every)
        else:
            self._inwheel_next_rescue = miss + every
            self.inwheel_inner_source = "host rescue"
            self._offer_inwheel_inner(ib)

    def _inwheel_host_rescue(self):
        """The host solver's inner bound of the SAME candidate the device
        pass evaluates (the consensus xbars through the single candidate rule,
        :func:`.cylinders.xhatxbar_bounder.clamp_candidate`), by
        per-scenario host solves: f32 clamped evaluations park above the
        feasibility gate (ROADMAP Queue 3), and the rescue certifies what
        the device pass cannot.  Under the integer sweep it sweeps the
        device's ladder instead (:func:`.solvers.integer.host_candidates`),
        the device's best candidate first, then the SLAM-up slam, then the
        rest; the first feasible one wins and counts in
        ``integer.feasible_hits``.  Returns the bound, or None where every
        candidate has an infeasible scenario or the host solver fails (a
        rescue declines, it never ends the wheel)."""
        from .cylinders.xhatxbar_bounder import clamp_candidate

        if getattr(self, "_host_state_stale", False):
            self._sync_host_state()
        _metrics.inc("megastep.bound_rescues")
        xbars = np.asarray(self.xbars, dtype=float)
        try:
            if self._inwheel_int_sweep_on():
                th = self._inwheel_int_thresholds()
                cands = integer_solvers.host_candidates(self, th)
                first = [min(getattr(self, "_int_best_idx", 0),
                             len(cands) - 1), len(th)]
                for ci in dict.fromkeys(first + list(range(len(cands)))):
                    total = self._inwheel_eval_candidate_host(cands[ci])
                    if total is not None:
                        _metrics.inc("integer.feasible_hits")
                        return total
                return None
            # the candidate rule per part (a bucket carries its own is_int)
            cand = np.array(xbars, copy=True)
            for idx, sub in batch_parts(self.batch):
                rows = np.asarray(idx)
                cand[rows], _, _ = clamp_candidate(
                    sub, sub.tree.nonant_indices, xbars[rows],
                    self._inwheel_threshold())
            return self._inwheel_eval_candidate_host(cand)
        except Exception as e:      # a failed rescue declines, loudly
            global_toc(f"in-wheel host rescue failed ({e!r}): declined",
                       True)
            return None

    def _inwheel_eval_candidate_host(self, cand_sk):
        """Expected objective of one fixed (S, K) candidate by per-scenario
        host solves, as the reference's (``tpusppy/phbase.py:688-726``):
        HiGHS at its default tolerances for an LP scenario, the exact host
        QP for a quadratic one, part by part (a bucket's sub-batch).  None
        when any scenario is infeasible: a candidate off a row that couples
        nonant columns alone (farmer's land row, which an f32 consensus
        leaves a few 1e-6 over) is refused as there."""
        from .solvers import scipy_backend

        probs = np.asarray(self.probs, dtype=float)
        cand_sk = np.asarray(cand_sk, dtype=float)
        total = 0.0
        for idx, sub in batch_parts(self.batch):
            rows = np.asarray(idx)
            lb = np.array(sub.lb, copy=True)
            ub = np.array(sub.ub, copy=True)
            nid = sub.tree.nonant_indices
            lb[:, nid] = cand_sk[rows]
            ub[:, nid] = cand_sk[rows]
            const = np.broadcast_to(np.asarray(sub.const, float),
                                    (sub.num_scenarios,))
            # a shared-A part converts its one matrix to CSR once (HiGHS
            # reads the same matrix either way)
            A_csr = (sp.csr_matrix(sub.A_shared)
                     if sub.A_shared is not None else None)
            objs = np.empty(sub.num_scenarios)
            for s in range(sub.num_scenarios):
                q2s = np.asarray(sub.q2[s])
                if q2s.any():
                    r = scipy_backend.solve_qp_with_duals(
                        sub.c[s], q2s, sub.A[s], sub.cl[s], sub.cu[s],
                        lb[s], ub[s], const=const[s])
                else:
                    r = scipy_backend.solve_lp(
                        sub.c[s], sub.A[s] if A_csr is None else A_csr,
                        sub.cl[s], sub.cu[s], lb[s], ub[s], const=const[s])
                objs[s] = r.obj
            if not np.isfinite(objs).all():
                return None
            total += float(probs[rows] @ objs)
        return total

    # ---- the integer host escalation (doc/integer.md) -----------------------
    def _integer_budget(self):
        """The wheel's one :class:`~.solvers.integer.EscalationBudget`
        (option ``integer_escalation_budget_s``, default 30 host seconds):
        every host escalation, the MILP lift and the MIP certification
        alike, draws from it."""
        b = getattr(self, "_int_budget", None)
        if b is None:
            b = self._int_budget = integer_solvers.EscalationBudget(
                float(self.options.get("integer_escalation_budget_s",
                                       30.0)))
        return b

    def _integer_escalation_on(self) -> bool:
        """Whether the gap-ranked host escalation is armed: option
        ``integer_escalation`` (default on), in-wheel bounds on, and an
        integer homogeneous family (the MILP lift reads ``batch.A[s]``)."""
        if not self.options.get("integer_escalation", True):
            return False
        if not self._inwheel_on() or isinstance(self.batch, BucketedBatch):
            return False
        return bool(np.asarray(self.batch.is_int).any())

    def _integer_gap_target(self):
        """(rel_gap, abs_gap) the escalation aims at: the hub's, else the
        opt options'."""
        opts = getattr(self.spcomm, "options", None) or {}
        return (opts.get("rel_gap", self.options.get("rel_gap")),
                opts.get("abs_gap", self.options.get("abs_gap")))

    def _integer_bounds_now(self):
        """(inner, outer): the best known bounds, in-wheel and the hub's."""
        ib = getattr(self, "inwheel_inner_bound", np.inf)
        ob = getattr(self, "inwheel_outer_bound", -np.inf)
        c = self.spcomm
        if c is not None:
            ib = min(ib, getattr(c, "BestInnerBound", np.inf))
            ob = max(ob, getattr(c, "BestOuterBound", -np.inf))
        return ib, ob

    def _maybe_integer_inner_mip(self, best_idx: int):
        """Certify the sweep's candidates by per-scenario host MIPs
        (:func:`~.solvers.integer.escalate_inner`), the inner leg of a
        family with SECOND-STAGE integers: the device's best candidate
        first, then the SLAM-up slam, then the rest, the first certified
        one installed as source ``'I'``.  On the rescue's cadence
        (``in_wheel_rescue_every``), from the shared budget."""
        if not self.options.get("in_wheel_host_rescue", True):
            return
        if not self._integer_escalation_on():
            return
        every = max(1, int(self.options.get("in_wheel_rescue_every", 4)))
        cnt = getattr(self, "_int_mip_calls", 0)
        self._int_mip_calls = cnt + 1
        if cnt % every:
            return
        budget = self._integer_budget()
        if budget.remaining <= 0.05:
            return
        ib = None
        try:
            th = self._inwheel_int_thresholds()
            cands = integer_solvers.host_candidates(self, th)
            first = [min(max(int(best_idx), 0), len(cands) - 1), len(th)]
            for ci in dict.fromkeys(first + list(range(len(cands)))):
                if budget.remaining <= 0.05:
                    break
                ib = integer_solvers.escalate_inner(self, budget, cands[ci])
                if ib is not None:
                    break
        except Exception as e:   # a failed escalation declines, loudly
            integer_solvers.declined("integer inner escalation", e)
            return
        if ib is not None:
            _metrics.inc("integer.feasible_hits")
            self.inwheel_inner_source = "I"
            self._offer_inwheel_inner(ib, char='I')

    def _maybe_integer_escalation(self):
        """ONE round of the gap-ranked host MILP escalation, where the
        certified gap still misses its target and an incumbent exists: on
        the ``integer_escalation_every`` window cadence (default 4), a
        slice of the shared budget (``integer_escalation_slice_s``, default
        all of it) lifts the per-scenario LP certificates with the LARGEST
        estimated gap first (the device's best candidate's per-scenario
        value as the estimate), installs the lifted outer bound as source
        ``'I'``, and recovers incumbents from the lift's minimizers
        (:meth:`_integer_lift_incumbents`)."""
        if not self._integer_escalation_on():
            return
        budget = self._integer_budget()
        if budget.remaining <= 0.05:
            return
        ib, ob = self._integer_bounds_now()
        if not np.isfinite(ib):
            return          # no incumbent yet: nothing to close against
        rel, abs_ = self._integer_gap_target()
        gap = ib - ob
        relgap = (gap / (abs(ob) or 1.0)) if np.isfinite(ob) else np.inf
        hit = ((rel is not None and relgap <= float(rel))
               or (abs_ is not None and gap <= float(abs_)))
        if hit or (rel is None and abs_ is None):
            return          # certified already, or no target to chase
        every = max(1, int(self.options.get("integer_escalation_every", 4)))
        cnt = getattr(self, "_int_esc_calls", 0)
        self._int_esc_calls = cnt + 1
        if cnt % every:
            return
        upper = None
        try:
            th = self._inwheel_int_thresholds()
            if th is not None:
                cands = integer_solvers.host_candidates(self, th)
                bi = min(getattr(self, "_int_best_idx", 0), len(cands) - 1)
                u, ok = integer_solvers.candidate_upper_perscen(
                    self, cands[bi])
                upper = np.where(ok, u, np.inf)
        except Exception as e:
            # the ranking falls back to probability order
            integer_solvers.declined("integer escalation ranking", e)
            upper = None
        try:
            ob2, X = integer_solvers.escalate_outer(
                self, budget,
                want_s=self.options.get("integer_escalation_slice_s"),
                upper_perscen=upper, want_x=True)
        except Exception as e:
            integer_solvers.declined("integer outer escalation", e)
            return
        if ob2 is None or not np.isfinite(ob2):
            return
        self._install_inwheel_outer(ob2, char='I')
        self._integer_lift_incumbents(X, budget)

    def _integer_lift_incumbents(self, X, budget):
        """Incumbents from the MILP lift's per-scenario minimizers, where
        every scenario was lifted gap-closed: their rounded per-node
        consensus and their SLAM-up slam, certified host-exactly (LPs, or
        per-scenario MIPs with second-stage integers), then the
        restricted-EF dive on their agreement
        (:func:`~.solvers.integer.restricted_ef_incumbent`); the best is
        installed as source ``'I'``."""
        if X is None or np.isnan(np.asarray(X)[:, 0]).any():
            return
        from .cylinders.xhatxbar_bounder import xbar_candidate
        from .extensions.xhatbase import slam_cache

        try:
            nid = self.tree.nonant_indices
            xk = np.asarray(X, dtype=float)[:, nid]
            ints = integer_solvers.int_mask_rows(self)
            lo = np.asarray(self.batch.lb)[:, nid]
            hi = np.asarray(self.batch.ub)[:, nid]
            up = slam_cache(self, xk, how="max")
            cands = [xbar_candidate(self, xk, threshold=0.5),
                     np.clip(np.where(ints, np.ceil(up - 1e-9), up), lo,
                             hi)]
            inner_ok = self._inwheel_inner_ok()
            best = None
            for cand in cands:
                if inner_ok:
                    if budget.remaining <= 0.05:
                        break
                    with budget.timed():
                        ib = self._inwheel_eval_candidate_host(cand)
                else:
                    ib = integer_solvers.escalate_inner(self, budget, cand)
                if ib is not None and (best is None or ib < best):
                    best = ib
            ib = integer_solvers.restricted_ef_incumbent(self, X, budget)
            if ib is not None and (best is None or ib < best):
                best = ib
            if best is not None:
                _metrics.inc("integer.feasible_hits")
                self.inwheel_inner_source = "I"
                self._offer_inwheel_inner(best, char='I')
        except Exception as e:
            integer_solvers.declined("integer lift-incumbent recovery", e)

    # ---- windows in the loop ------------------------------------------------
    def _megastep_window(self, k, max_iters, convthresh, n_req):
        """One window starting at iteration ``k``: returns ``(executed,
        conv_hit)``; ``executed == 0`` means the slot was not ready (stale
        or aged factors, an unclean last measurement, or a first iterate
        the window rejected) and the caller runs a legacy iteration, which
        refreshes and rescues."""
        refresh_every = self._refresh_every()
        if not self._mega_slots_ready(refresh_every):
            return 0, False
        # the last measurement must be clean, as the legacy frozen path's
        # acceptance test; an eps-converged batch is clean whatever its
        # residual ladder says
        pri, dua = self.pri_res, self.dua_res
        if pri is None or dua is None:
            return 0, False
        _, tol_qp = self._straggler_tols()
        if not bool(np.all((pri <= tol_qp) & (dua <= tol_qp))):
            if not getattr(self, "_last_all_done", False):
                return 0, False
        n_live = min(n_req, refresh_every - self._mega_age(),
                     max_iters - k + 1)
        if n_live < 1:
            return 0, False
        bound_live = None
        if self._inwheel_on():
            wc = getattr(self, "_mega_window_count", 0)
            self._mega_window_count = wc + 1
            bound_live = (wc % self._inwheel_every() == 0)
        meas = self._megastep_dispatch(n_req, n_live, convthresh,
                                       bound_live=bound_live)
        if bound_live is not None:
            # valid on whatever state the window ended with, the incoming
            # one too when its first iterate was rejected
            self._consume_inwheel_bounds(meas)
        executed = meas["executed"]
        if executed == 0:
            return 0, False
        self._windows_run = getattr(self, "_windows_run", 0) + 1
        self._apply_megastep_meas(k, meas)
        # a window the acceptance test cut short is not convergence
        return executed, bool(self.conv < convthresh)

    def _apply_megastep_meas(self, k, meas):
        """Install a window's measurement as the host PH state (copies).  A
        lean measurement leaves the host mirrors of x, W and xbars STALE
        until :meth:`_sync_host_state`; the residuals and the scalar
        stats install either way."""
        executed = meas["executed"]
        full = "W" in meas
        if full:
            self.W = np.array(meas["W"], dtype=float)
            self.xbars = np.array(meas["xbars"], dtype=float)
            self.local_x = np.array(meas["x"], dtype=float)
        else:
            self._host_state_stale = True
        self.pri_res = np.array(meas["pri"], dtype=float)
        self.dua_res = np.array(meas["dua"], dtype=float)
        self._last_all_done = bool(np.all(meas["done"]))
        if full:
            # xsqbars is not packed: its host twin from the window's x
            _, self.xsqbars = self._node_avgs(self._nonants_cached())
        self.conv = float(meas["conv"][executed - 1])
        self._iter = k + executed - 1
        self._bump_state_version()
        global_toc(
            f"PH megastep {k}..{self._iter} conv {self.conv:.6e}",
            self.options.get("display_progress", False))

    def _sync_host_state(self):
        """Refresh the host mirrors of x, W and xbars from the device state
        of lean windows: ONE fetch, counted in
        ``phstate.boundary_fetches``, at the boundaries that read them
        (hub payloads, the legacy iteration, the end of the loop, the host
        rescue).  A no-op when the mirrors are current."""
        st = self._dev_state
        if st is None or not getattr(self, "_host_state_stale", False):
            self._host_state_stale = False
            return
        W, xbars, x = hostsync.fetch((st.W, st.xbars, st.x))
        self.W = np.array(W, dtype=float)
        self.xbars = np.array(xbars, dtype=float)
        self.local_x = np.array(x, dtype=float)
        self._host_state_stale = False
        _, self.xsqbars = self._node_avgs(self._nonants_cached())
        self._bump_state_version()
        _metrics.inc("phstate.boundary_fetches")
        if _trace.enabled():
            _trace.instant(None, "phstate_boundary_fetch", iter=self._iter)

    def _spcomm_needs_host_state(self) -> bool:
        """Whether the coming ``spcomm.sync()`` reads host PH state: W or
        nonant payloads to spokes, or a checkpoint capture that is due
        (which must find current mirrors, and fetches nothing itself)."""
        c = self.spcomm
        if c is None:
            return False
        if getattr(c, "has_w_spokes", False) or \
                getattr(c, "has_nonant_spokes", False):
            return True
        due = getattr(c, "checkpoint_due", None)
        return bool(due and due(self._iter))

    def iterk_loop(self):
        """Main PH loop (phbase.py:875-979).  Where the megastep is allowed
        (:meth:`_megastep_request`), iterations run in windows, with the
        hub sync and the termination checks at window ends; the legacy
        per-iteration body refreshes between them (and runs every
        iteration under ``megastep`` 1)."""
        convthresh = self.options.get("convthresh", 0.0)
        max_iters = self.options["PHIterLimit"]
        # continues a carried state (convert.py) or a resumed checkpoint's
        # iteration count: the limit stays the total
        k = max(self._iter, int(getattr(self, "_iter_base", 0))) + 1
        mega_n = self._megastep_request()
        while k <= max_iters:
            if mega_n:
                executed, conv_hit = self._megastep_window(
                    k, max_iters, convthresh, mega_n)
                if executed:
                    k += executed
                    if self.spcomm is not None:
                        if self._spcomm_needs_host_state():
                            self._sync_host_state()
                        self.spcomm.sync()
                        self.extobject.enditer_after_sync()
                        if self.spcomm.is_converged():
                            global_toc("Cylinder termination", True)
                            break
                    if conv_hit:
                        global_toc(
                            f"Convergence threshold {convthresh} reached "
                            f"at iter {self._iter}",
                            self.options.get("display_progress", False))
                        break
                    continue
            # the legacy body assembles the objective from the host mirrors
            self._sync_host_state()
            k = self._iterk_one(k, convthresh)
            if k is None:
                break
            k += 1
        # whatever reads follow (post_loops' Eobjective, callers) gets
        # current host state
        self._sync_host_state()

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
