"""XhatXbar: evaluate (rounded) xbar as the incumbent candidate.

A copy of ``tpusppy/extensions/xhatxbar.py``, the analogue of
``mpisppy/extensions/xhatxbar.py`` and the spoke at
``cylinders/xhatxbar_bounder.py:31``: xbar is already nonanticipative by
construction, so the candidate cache is just the per-scenario xbars
(integers are rounded inside ``fix_nonants``).
"""

from __future__ import annotations

from .xhatbase import XhatBase


class XhatXbar(XhatBase):
    def _try(self):
        xbars = getattr(self.opt, "xbars", None)
        if xbars is None:
            return None
        obj = self._try_one(xbars)
        self._update_if_improving(obj, xbars)
        return obj

    def post_iter0(self):
        self._try()

    def enditer(self):
        self._try()
