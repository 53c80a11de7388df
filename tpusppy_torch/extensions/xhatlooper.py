"""XhatLooper: try scenarios in order as xhat candidates each iteration.

A copy of ``tpusppy/extensions/xhatlooper.py``, the analogue of
``mpisppy/extensions/xhatlooper.py`` (and the simple looper spoke,
cylinders/xhatlooper_bounder.py:12): after iter0 and after each PH
iteration, walk up to ``xhat_looper_options["scen_limit"]`` scenarios,
evaluate each as an incumbent candidate, and keep the best.
"""

from __future__ import annotations

from .xhatbase import XhatBase


class XhatLooper(XhatBase):
    def __init__(self, spopt_object):
        super().__init__(spopt_object)
        xo = self.opt.options.get("xhat_looper_options", {})
        self.scen_limit = int(xo.get("scen_limit", 1))
        self._next = 0

    def _loop(self):
        S = self.opt.batch.num_scenarios
        for _ in range(min(self.scen_limit, S)):
            self.try_scenario(self._next % S)
            self._next += 1

    def post_iter0(self):
        self._loop()

    def enditer(self):
        self._loop()
