"""XhatShuffle inner-bound spoke: shuffled scenario cycling over hub nonants.

A copy of ``tpusppy/cylinders/xhatshufflelooper_bounder.py`` (the analogue
of ``mpisppy/cylinders/xhatshufflelooper_bounder.py:20-300``).  Each pass:
take the hub's current nonant values, pick the next donor scenario from a
seeded shuffle (the reference's ``ScenarioCycler``, multistage-aware via
per-node donor completion), fix the nonant columns to the donated
candidate, solve the whole batch in one batched solve (``Xhat_Eval``), and
push the expected objective to the hub when it improves the incumbent.

Not ported yet: the donor-MILP mode (``donor_milp``, ROADMAP Queue 1 item
6), which raises.
"""

from __future__ import annotations

import numpy as np

from ..extensions.xhatbase import donor_cache
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
        """The cycler and the pass length; the opt object (Xhat_Eval)
        evaluates candidates directly."""
        lopts = self.opt.options.get("xhat_looper_options", {})
        if lopts.get("donor_milp"):
            raise NotImplementedError(
                "xhat_looper_options donor_milp: donor MILPs are not ported "
                "yet (ROADMAP Queue 1 item 6)")
        self.cycler = ScenarioCycler(
            self.opt.batch.num_scenarios,
            seed=int(lopts.get("seed", 0)),
            reverse=bool(lopts.get("reverse", False)),
        )
        self.scen_limit = int(lopts.get("scen_limit", 3))

    def _try_candidates(self, final=False):
        """Try up to scen_limit donors against the current hub nonants,
        yielding to the kill sentinel between them (``peek_kill_signal``
        keeps a payload posted meanwhile fresh) except on the final
        pass."""
        xk = self.localnonants
        for _ in range(self.scen_limit):
            donor = self.cycler.get_next()
            obj = self.opt.evaluate(donor_cache(self.opt, xk, donor))
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
