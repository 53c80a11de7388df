"""PH: synchronous Progressive Hedging driver.

Mirrors ``mpisppy/opt/ph.py:18-71``: a thin driver over PHBase —
``Iter0 -> iterk_loop -> post_loops``.
"""

from ..phbase import PHBase


class PH(PHBase):
    """Synchronous PH optimizer."""

    def ph_main(self, finalize=True):
        """Run PH; returns (conv, Eobj, trivial_bound) like opt/ph.py:25-71."""
        self.trivial_bound = self.Iter0()
        self.iterk_loop()
        eobj = self.post_loops() if finalize else None
        return self.conv, eobj, self.trivial_bound
