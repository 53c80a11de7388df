"""XhatShuffle inner-bound spoke: shuffled scenario cycling over hub nonants.

A copy of ``tpusppy/cylinders/xhatshufflelooper_bounder.py`` (the analogue
of ``mpisppy/cylinders/xhatshufflelooper_bounder.py:20-300``).  Each pass:
take the hub's current nonant values, pick the next donor scenario from a
seeded shuffle (the reference's ``ScenarioCycler``, multistage-aware via
per-node donor completion), fix the nonant columns to the donated
candidate, solve the whole batch in one batched solve (``Xhat_Eval``), and
push the expected objective to the hub when it improves the incumbent.

The donor-MILP mode (``xhat_looper_options`` ``donor_milp``, two-stage
trees): a candidate is the donor scenario's exact host MILP solution
(HiGHS, ``donor_milp_gap``, ``donor_milp_time``), the reference's donor
semantics (its donors are solved MIP scenario instances), cached per donor;
once every donor has been tried the spoke goes back to hub-nonant donors.
"""

from __future__ import annotations

import time

import numpy as np

from ..extensions.xhatbase import donor_cache
from ..solvers import scipy_backend
from .spoke import InnerBoundNonantSpoke


class ScenarioCycler:
    """Seeded shuffled cycle over donor scenario indices
    (xhatshufflelooper_bounder.py:158-300); ``reverse`` iterates each
    shuffle backwards.  The same seed gives the reference's sequence."""

    def __init__(self, num_scenarios: int, seed: int = 0,
                 reverse: bool = False):
        self._S = int(num_scenarios)
        self._rng = np.random.default_rng(seed)
        self._reverse = reverse
        self._order = []
        self._pos = 0

    def _reshuffle(self):
        self._order = list(self._rng.permutation(self._S))
        if self._reverse:
            self._order.reverse()
        self._pos = 0

    def get_next(self) -> int:
        if self._pos >= len(self._order):
            self._reshuffle()
        s = self._order[self._pos]
        self._pos += 1
        return int(s)


class XhatShuffleInnerBound(InnerBoundNonantSpoke):
    """'X' spoke (xhatshufflelooper_bounder.py:20-157)."""

    converger_spoke_char = 'X'

    def xhatbase_prep(self):
        """The cycler, the pass length and the donor-MILP mode; the opt
        object (Xhat_Eval) evaluates candidates directly."""
        lopts = self.opt.options.get("xhat_looper_options", {})
        self.cycler = ScenarioCycler(
            self.opt.batch.num_scenarios,
            seed=int(lopts.get("seed", 0)),
            reverse=bool(lopts.get("reverse", False)),
        )
        self.scen_limit = int(lopts.get("scen_limit", 3))
        self.donor_milp = bool(lopts.get("donor_milp", False)) and \
            self.opt.tree.num_stages == 2
        self.donor_milp_gap = float(lopts.get("donor_milp_gap", 1e-3))
        self.donor_milp_time = float(lopts.get("donor_milp_time", 30.0))
        self._milp_donor_cache: dict = {}
        self._milp_evaluated: set = set()
        self.milp_secs = 0.0

    def _donor_milp_candidate(self, donor):
        """(K,) candidate from the donor scenario's exact MILP, cached (the
        plain-objective scenario optimum does not change between passes);
        None for an infeasible donor, or one whose time limit left no
        incumbent (not cached: it gets another try on a later pass)."""
        if donor in self._milp_donor_cache:
            return self._milp_donor_cache[donor]
        b = self.opt.batch
        t0 = time.perf_counter()
        res = scipy_backend.solve_lp(
            b.c[donor], b.A[donor], b.cl[donor], b.cu[donor],
            b.lb[donor], b.ub[donor], is_int=b.is_int,
            mip_rel_gap=self.donor_milp_gap,
            time_limit=self.donor_milp_time)
        self.milp_secs += time.perf_counter() - t0
        cand = (np.asarray(res.x)[self.opt.tree.nonant_indices]
                if res.feasible else None)
        if cand is not None or res.status == "2":
            self._milp_donor_cache[donor] = cand
        return cand

    def _try_candidates(self, final=False):
        """Try up to scen_limit donors against the current hub nonants (or
        their MILP candidates), yielding to the kill sentinel between them
        (``peek_kill_signal`` keeps a payload posted meanwhile fresh)
        except on the final pass."""
        xk = self.localnonants
        for _ in range(self.scen_limit):
            donor = self.cycler.get_next()
            if self.donor_milp:
                if donor in self._milp_evaluated:
                    # a donor's MILP candidate never changes: once every
                    # donor has been tried, back to hub-nonant donors
                    if (len(self._milp_evaluated)
                            >= self.opt.batch.num_scenarios):
                        self.donor_milp = False
                    continue
                cache = self._donor_milp_candidate(donor)
                if cache is None:
                    continue
                self._milp_evaluated.add(donor)
            else:
                cache = donor_cache(self.opt, xk, donor)
            obj = self.opt.evaluate(cache)
            self.update_if_improving(obj)
            if not final and self.peek_kill_signal():
                return

    def main(self):
        self.xhatbase_prep()
        self._seen = False
        while not self.got_kill_signal():
            if self.new_nonants:
                self._seen = True
                self._try_candidates()

    def finalize(self):
        """One final candidate pass with the last hub nonants (a fast hub
        can otherwise outrun the spoke and end on a stale incumbent)."""
        if getattr(self, "_seen", False):
            self._try_candidates(final=True)
        return super().finalize()
