"""WXBarReader: warm-start W / xbar from files before iteration 1.

A copy of ``tpusppy/extensions/wxbarreader.py`` (the analogue of
``mpisppy/utils/wxbarreader.py``): options ``init_W_fname`` /
``init_Xbar_fname`` / ``init_separate_W_files``, read at the end of Iter0
through :func:`..resilience.checkpoint.read_wxbar`: a ``.npz`` path
restores W, xbar and rho from a wheel checkpoint at once, any other path
reads the reference's csv formats (:mod:`..utils.wxbarutils`).
"""

from __future__ import annotations

from ..resilience import checkpoint as _checkpoint
from .extension import Extension


class WXBarReader(Extension):
    def __init__(self, opt):
        super().__init__(opt)
        self.W_fname = opt.options.get("init_W_fname")
        self.Xbar_fname = opt.options.get("init_Xbar_fname")
        self.sep_files = opt.options.get("init_separate_W_files", False)

    def post_iter0(self):
        if self.W_fname or self.Xbar_fname:
            _checkpoint.read_wxbar(self.opt, self.W_fname, self.Xbar_fname,
                                   sep_files=self.sep_files)
