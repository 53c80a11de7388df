"""XhatXbar inner-bound spoke: round the per-node average and evaluate it.

A copy of ``tpusppy/cylinders/xhatxbar_bounder.py`` (the analogue of
``mpisppy/cylinders/xhatxbar_bounder.py:31-118``): the candidate is the
probability-weighted per-node mean of the hub's nonants (xbar), with
integer slots rounded — nonanticipative by construction, and often good
once PH is nearly converged.

Not ported yet: ``in_wheel_inner_bound``, which waits for the megastep
(ROADMAP Queue 1 item 3), and the integer families' rounding ladder
(Queue 1 item 6): an integer family evaluates the thresholds it is given.
"""

from __future__ import annotations

import numpy as np

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


class XhatXbarInnerBound(InnerBoundNonantSpoke):
    """'X' spoke (xhatxbar_bounder.py:31-118).

    ``xhat_xbar_options: {"thresholds": [...]}`` evaluates a rounding
    ladder per fresh nonants (default [0.5]).
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
            nid = self.opt.tree.nonant_indices
            if bool(np.asarray(self.opt.batch.is_int, bool)[nid].any()):
                raise NotImplementedError(
                    "XhatXbarInnerBound on an integer family: its default "
                    "rounding ladder is not ported yet (ROADMAP Queue 1 "
                    "item 6); pass xhat_xbar_options thresholds")
            th = [0.5]
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
