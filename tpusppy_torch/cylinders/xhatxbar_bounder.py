"""XhatXbar inner-bound spoke: round the per-node average and evaluate it.

A copy of ``tpusppy/cylinders/xhatxbar_bounder.py`` (the analogue of
``mpisppy/cylinders/xhatxbar_bounder.py:31-118``): the candidate is the
probability-weighted per-node mean of the hub's nonants (xbar), with
integer slots rounded — nonanticipative by construction, and often good
once PH is nearly converged.

An integer family's default ladder is the in-wheel integer sweep's,
:data:`~tpusppy_torch.solvers.integer.DEFAULT_THRESHOLDS` (one candidate
rule, two execution paths).  :func:`in_wheel_inner_bound` is the host twin
of the megastep's in-wheel inner bound.
"""

from __future__ import annotations

import numpy as np

from ..ir import batch_parts
from ..solvers.integer import DEFAULT_THRESHOLDS
from .spoke import InnerBoundNonantSpoke


def candidate_rule(batch, nid, cand: np.ndarray,
                   threshold: float = 0.5) -> np.ndarray:
    """The host-side xhat candidate rule: round integer nonant slots at
    ``threshold``, then clip to the nonant box.  The clip matters: the mean
    of eps-accurate solutions carries tolerance noise, and a clamped
    column eps outside its box makes the whole evaluation read
    infeasible."""
    ints = np.asarray(batch.is_int, bool)[nid]
    if ints.any():
        cand = np.where(ints[None, :],
                        np.floor(cand + (1.0 - threshold)), cand)
    return np.clip(cand, np.asarray(batch.lb)[:, nid],
                   np.asarray(batch.ub)[:, nid])


def clamp_candidate(batch, nid, cand: np.ndarray, threshold: float = 0.5):
    """:func:`candidate_rule` plus the clamp: ``(cand, lb, ub)`` with fresh
    full bound copies whose nonant columns are fixed at the candidate."""
    cand = candidate_rule(batch, nid, cand, threshold)
    lb = np.array(batch.lb, copy=True)
    ub = np.array(batch.ub, copy=True)
    lb[:, nid] = cand
    ub[:, nid] = cand
    return cand, lb, ub


def xbar_candidate(opt, xk: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """(S, K) per-node weighted mean of xk, integer slots rounded up when
    their fractional part is at least ``threshold``
    (xhatxbar_bounder.py:31-80)."""
    onehot = opt.tree.onehot_sk_n()           # (S, K, N)
    p = opt.probs[:, None]
    num = np.einsum("skn,sk->nk", onehot, p * xk)
    den = np.einsum("skn,sk->nk", onehot, np.broadcast_to(p, xk.shape))
    xbar_nk = num / np.maximum(den, 1e-300)
    kidx = np.arange(xk.shape[1])[None, :]
    cand = xbar_nk[opt.nid_sk, kidx]
    return candidate_rule(opt.batch, opt.tree.nonant_indices, cand,
                          threshold)


def in_wheel_inner_bound(opt, threshold: float = 0.5, feas_tol=None):
    """The xhat-at-xbar inner bound of ``opt``'s CURRENT state: the host
    twin of the megastep's in-wheel pass (``parallel.sharded.
    _bound_pass_terms``).  The candidate is ``opt.xbars`` through
    :func:`candidate_rule`, clamped onto the nonant columns and evaluated
    by ONE frozen solve on the cached factors under the PH-augmented
    objective (same minimizer on the clamped box, matching factors); the
    PLAIN expected objective is reported.  Returns ``(inner, feas_mass)``,
    the mass of scenarios whose primal residual is under ``feas_tol``
    (``inner`` is an incumbent only when it is 1).  Needs frozen-ready
    state."""
    from ..solvers import admm, hostsync, shared_admm

    if getattr(opt, "_host_state_stale", False):
        opt._sync_host_state()
    if opt._factors is None or opt._warm is None:
        raise RuntimeError("in_wheel_inner_bound requires frozen-ready "
                           "state (a prior refresh solve)")
    b = opt.batch
    nid = np.asarray(opt.tree.nonant_indices)
    cand, lb, ub = clamp_candidate(b, nid, np.array(opt.xbars, dtype=float),
                                   threshold)
    q, q2 = opt._augmented_q()
    st = opt.admm_settings
    dt = st.tdtype()
    A_d, cl_d, cu_d = opt._device_consts(dt)

    def t(v):
        return admm._tensor(v, dt, opt.device)

    x, z, y, yx = (t(v) for v in opt._warm)
    x0 = x.clone()
    x0[:, nid] = t(cand)
    args = (t(q), t(q2), A_d, cl_d, cu_d, t(lb), t(ub))
    frozen = (shared_admm.solve_shared_frozen if b.A_shared is not None
              else admm.solve_batch_frozen)
    sol = frozen(*args, factors=opt._factors, settings=st,
                 warm=(x0, z, y, yx))
    xs, pri = hostsync.fetch((sol.x, sol.pri_res))
    obj = (np.einsum("sn,sn->s", np.asarray(b.c), xs)
           + 0.5 * np.einsum("sn,sn->s", np.asarray(b.q2), xs * xs)
           + np.broadcast_to(np.asarray(b.const), (b.num_scenarios,)))
    if feas_tol is None:
        feas_tol = opt._inwheel_feas_tol()
    probs = np.asarray(opt.probs, dtype=float)
    return float(probs @ obj), float(probs @ (pri < feas_tol))


class XhatXbarInnerBound(InnerBoundNonantSpoke):
    """'X' spoke (xhatxbar_bounder.py:31-118).

    ``xhat_xbar_options: {"thresholds": [...]}`` evaluates a rounding
    ladder per fresh nonants (default: [0.5], or the integer sweep's
    ladder on a family with integer nonants).
    """

    converger_spoke_char = 'X'

    def _sweep(self, xk, final=False):
        for th in self._thresholds:
            cand = xbar_candidate(self.opt, xk, threshold=th)
            obj = self.opt.evaluate(cand)
            self.update_if_improving(obj)
            # mid-run sweeps yield to fresher nonants; the final pass
            # finishes the ladder
            if not final and self.peek_kill_signal():
                return

    def main(self):
        th = self.opt.options.get("xhat_xbar_options", {}).get("thresholds")
        if th is None:
            # a bucketed batch carries is_int per bucket
            ints = any(np.asarray(sub.is_int,
                                  bool)[sub.tree.nonant_indices].any()
                       for _, sub in batch_parts(self.opt.batch))
            th = list(DEFAULT_THRESHOLDS) if ints else [0.5]
        self._thresholds = list(th)
        self._seen = False
        while not self.got_kill_signal():
            if self.new_nonants:
                self._seen = True
                self._sweep(self.localnonants)

    def finalize(self):
        """Final ladder pass with the last hub nonants."""
        if getattr(self, "_seen", False):
            self._sweep(self.localnonants, final=True)
        return super().finalize()
