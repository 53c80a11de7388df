"""Lagrangian outer-bound spoke.

A copy of ``tpusppy/cylinders/lagrangian_bounder.py`` (the analogue of
``mpisppy/cylinders/lagrangian_bounder.py:5-95``): take the hub's PH dual
weights W, solve every scenario subproblem with W active and the prox term
OFF, and report the certified (weak-duality) bound of the W-augmented
subproblems, a valid lower (outer) bound for minimization since PH keeps
the probability-weighted W summing to zero per node.  One batched solve per
fresh W; with ``lagrangian_dual_donors`` the bound also takes host-exact
donor duals (:meth:`~tpusppy_torch.spopt.SPOpt.dual_donor_bounds`), and
with ``lagrangian_skip_solve`` it comes from the donors alone.

On an integer family, ``lagrangian_milp_lift`` lifts the per-scenario LP
certificates to host MILP dual bounds every ``every``-th pass
(:func:`~tpusppy_torch.solvers.milp_bound.milp_lift`), and
``lagrangian_milp_ascent`` polishes the final W by subgradient ascent on
the integer Lagrangian dual (:func:`~tpusppy_torch.solvers.milp_bound.
milp_dual_ascent`): the reference spoke's MIP subproblem minima.

:func:`in_wheel_outer_bound` is the host twin of the megastep's in-wheel
outer bound.
"""

from __future__ import annotations

import time

import numpy as np

from .. import global_toc
from ..obs import metrics as _metrics
from ..solvers import milp_bound
from .spoke import OuterBoundWSpoke


def in_wheel_outer_bound(opt) -> float:
    """The Lagrangian outer bound of ``opt``'s CURRENT state without a
    fresh solve: the W-augmented objective (W on, prox off) through the
    weak-duality assembly with the warm state's row duals.  The host twin
    of the bound the megastep's in-wheel pass computes on the device
    (``parallel.sharded._bound_pass_terms``).  Syncs stale host mirrors
    first; needs a prior solve."""
    if getattr(opt, "_host_state_stale", False):
        opt._sync_host_state()
    b = opt.batch
    q = np.array(b.c, copy=True)
    q[:, opt.tree.nonant_indices] += np.asarray(opt.W, dtype=float)
    return opt.Edualbound(q=q, q2=b.q2)


def _has_ints(opt) -> bool:
    return bool(np.asarray(opt.batch.is_int).any())


class LagrangianOuterBound(OuterBoundWSpoke):
    """'L' spoke: Lagrangian dual bound from hub Ws
    (lagrangian_bounder.py:5-95)."""

    converger_spoke_char = 'L'

    def lagrangian_prep(self):
        """The reference's PH_Prep(attach_prox=False) + _reenable_W: the
        opt object needs no model surgery, only the W-on/prox-off mode."""
        self.opt.W_on = True
        self.opt.prox_on = False

    def lagrangian(self) -> float:
        """Solve the W-augmented batch and return its certified bound
        (lagrangian_bounder.py:19-56).  The objective is the opt object's
        own ``_augmented_q`` (W on, prox off).  ``lagrangian_milp_lift``
        (a dict of :func:`~tpusppy_torch.solvers.milp_bound.milp_lift`
        keyword arguments and ``every``) lifts the per-scenario
        certificates of an integer family to host MILP dual bounds,
        valid at any completed subset of scenarios."""
        opt = self.opt
        q, q2 = opt._augmented_q()
        donor_cfg = opt.options.get("lagrangian_dual_donors")
        # lagrangian_skip_solve: the batched solve only produces ADMM
        # duals, which at full scale plateau far looser than donor duals
        # and take the card from the other cylinders
        skip_solve = bool(opt.options.get("lagrangian_skip_solve")
                          and donor_cfg)
        if opt.options.get("lagrangian_skip_solve") and not donor_cfg:
            # skipping the solve is only sound when donors supply the
            # bound: the skip is declined, loudly, once
            _metrics.inc("lagrangian.skip_declined")
            if not getattr(self, "_skip_declined_warned", False):
                self._skip_declined_warned = True
                global_toc(
                    "WARNING: lagrangian_skip_solve is set but "
                    "lagrangian_dual_donors is not: the skip is DECLINED "
                    "(the full batched solve runs)", True)
        if not skip_solve:
            opt.solve_loop(q=q, q2=q2)
        base = None
        if donor_cfg:
            donors = opt.dual_donor_bounds(q=q, q2=q2, **dict(donor_cfg))
            if donors is not None:
                base = donors
                if not skip_solve:
                    base = np.maximum(
                        opt.Edualbound_perscen(q=q, q2=q2), donors)
            elif skip_solve:
                # no donor dual at all: fall back to the solve
                opt.solve_loop(q=q, q2=q2)
        lift_cfg = opt.options.get("lagrangian_milp_lift")
        if lift_cfg and _has_ints(opt):
            every = max(1, int(lift_cfg.get("every", 1)))
            if getattr(self, "dk_iter", 1) % every == 0:
                if base is None:
                    base = opt.Edualbound_perscen(q=q, q2=q2)
                kw = {k: v for k, v in lift_cfg.items() if k != "every"}
                t0 = time.perf_counter()
                lifted, n = milp_bound.milp_lift(opt.batch, q, base, **kw)
                self.milp_secs = (getattr(self, "milp_secs", 0.0)
                                  + time.perf_counter() - t0)
                self.last_milp_lift_count = n
                return float(opt.probs @ lifted)
        if base is not None:
            return float(opt.probs @ base)
        return opt.Edualbound(q=q, q2=q2)

    def _set_weights_and_solve(self) -> float:
        self.opt.W = np.asarray(self.localWs, dtype=float).copy()
        return self.lagrangian()

    def main(self):
        self.lagrangian_prep()
        self.opt.W = np.zeros(
            (self.opt.batch.num_scenarios, self.opt.nonant_length))
        self.trivial_bound = self.lagrangian()
        self.bound = self.trivial_bound
        self.dk_iter = 1
        while not self.got_kill_signal():
            if self.new_Ws:
                bound = self._set_weights_and_solve()
                if bound is not None and np.isfinite(bound):
                    self.bound = bound
                self.dk_iter += 1

    def finalize(self):
        """One final pass with the last Ws (lagrangian_bounder.py:85-95).

        ``lagrangian_milp_ascent`` (keyword arguments of
        :func:`~tpusppy_torch.solvers.milp_bound.milp_dual_ascent`, and
        ``skip_if_gap_at``: skip it where the hub's payload shows a gap at
        or below that) then polishes the final W by projected subgradient
        ascent on the INTEGER Lagrangian dual of an integer family; every
        iterate certifies, and the best is reported."""
        self.final_bound = self._set_weights_and_solve()
        if np.isfinite(self.final_bound):
            self.bound = self.final_bound
        ascent_cfg = dict(self.opt.options.get("lagrangian_milp_ascent")
                          or {})
        skip_at = float(ascent_cfg.pop("skip_if_gap_at", 0.0))
        if ascent_cfg and skip_at > 0.0 and self._locals.shape[0] >= 2:
            ob, ib = self.hub_outer_bound, self.hub_inner_bound
            # the hub's own gap convention; crossed bounds never skip
            if (self.opt.is_minimizing and np.isfinite(ob)
                    and np.isfinite(ib) and abs(ob) > 0
                    and 0 <= (ib - ob) / abs(ob) <= skip_at):
                ascent_cfg = None
        if ascent_cfg and _has_ints(self.opt):
            opt = self.opt

            def base_fn(W):
                opt.W = np.asarray(W, dtype=float)
                q, q2 = opt._augmented_q()
                # the MILP lift supplies the certificates; host-rescuing
                # stalled LPs each step would eat the ascent's budget
                saved = opt.options.get("straggler_rescue", True)
                opt.options["straggler_rescue"] = False
                try:
                    opt.solve_loop(q=q, q2=q2)
                finally:
                    opt.options["straggler_rescue"] = saved
                return q, opt.Edualbound_perscen(q=q, q2=q2)

            t0 = time.perf_counter()
            best, _ = milp_bound.milp_dual_ascent(
                opt.batch, opt.W, base_fn, **ascent_cfg)
            self.milp_secs = (getattr(self, "milp_secs", 0.0)
                              + time.perf_counter() - t0)
            if np.isfinite(best) and (not np.isfinite(self.final_bound)
                                      or best > self.final_bound):
                self.final_bound = best
                self.bound = best
        return self.final_bound
