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

:func:`in_wheel_outer_bound` is the host twin of the megastep's in-wheel
outer bound.  Not ported yet: the MILP lift and ascent of integer families
(ROADMAP Queue 1 item 6), which raise when asked for on one.
"""

from __future__ import annotations

import numpy as np

from .. import global_toc
from ..obs import metrics as _metrics
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
        opt object needs no model surgery, only the W-on/prox-off mode.
        The integer MILP lift and ascent raise here."""
        opts = self.opt.options
        for name in ("lagrangian_milp_lift", "lagrangian_milp_ascent"):
            if opts.get(name) and _has_ints(self.opt):
                raise NotImplementedError(
                    f"{name}: the MILP bound of an integer family is not "
                    "ported yet (ROADMAP Queue 1 item 6)")
        self.opt.W_on = True
        self.opt.prox_on = False

    def lagrangian(self) -> float:
        """Solve the W-augmented batch and return its certified bound
        (lagrangian_bounder.py:19-56).  The objective is the opt object's
        own ``_augmented_q`` (W on, prox off)."""
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
        """One final pass with the last Ws (lagrangian_bounder.py:85-95)."""
        self.final_bound = self._set_weights_and_solve()
        if np.isfinite(self.final_bound):
            self.bound = self.final_bound
        return self.final_bound
