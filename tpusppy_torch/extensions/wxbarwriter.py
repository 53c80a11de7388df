"""WXBarWriter: write W / xbar each iteration.

A copy of ``tpusppy/extensions/wxbarwriter.py`` (the analogue of
``mpisppy/utils/wxbarwriter.py``): options ``W_fname`` / ``Xbar_fname`` /
``separate_W_files``, written at the end of each iteration through
:func:`..resilience.checkpoint.write_wxbar`: a ``.npz`` target gets a
checkpoint (atomic, versioned, W, xbar and rho together, loadable by
``WheelSpinner(resume=...)``), a csv target the reference's
append-per-iteration ``scenario,varname,value`` rows.
"""

from __future__ import annotations

import os

from ..resilience import checkpoint as _checkpoint
from .extension import Extension


class WXBarWriter(Extension):
    def __init__(self, opt):
        super().__init__(opt)
        self.W_fname = opt.options.get("W_fname")
        self.Xbar_fname = opt.options.get("Xbar_fname")
        self.sep_files = opt.options.get("separate_W_files", False)
        # start fresh (the csv writers append per iteration; npz
        # checkpoints replace atomically and need no unlink)
        for fname in (self.W_fname, self.Xbar_fname):
            if (fname and not self.sep_files
                    and not str(fname).endswith(".npz")
                    and os.path.exists(fname)):
                os.remove(fname)

    def enditer(self):
        if self.W_fname or self.Xbar_fname:
            _checkpoint.write_wxbar(self.opt, self.W_fname, self.Xbar_fname,
                                    sep_files=self.sep_files)
