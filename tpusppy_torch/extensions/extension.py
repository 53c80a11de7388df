"""Extension plugin ABC — hub-side callout points.

A copy of the base class of ``tpusppy/extensions/extension.py`` (which mirrors
``mpisppy/extensions/extension.py:12-169``), with the callout points the
legacy PH loop calls from PHBase.Iter0/iterk_loop/post_loops and
SPOpt.solve_loop; the hub/spoke ``*_after_sync`` points come with the wheel.  Extensions receive the opt
object (``self.opt``) and may read or mutate PH state arrays (W, rho, xbar,
local_x ...).
"""


class Extension:
    """Base class; subclasses override any subset of the callouts."""

    def __init__(self, spopt_object):
        self.opt = spopt_object

    def pre_solve(self):            # before each batch solve
        pass

    def post_solve(self):           # after each batch solve
        pass

    def pre_solve_loop(self):
        pass

    def post_solve_loop(self):
        pass

    def pre_iter0(self):
        pass

    def post_iter0(self):
        pass

    def miditer(self):              # after xbar/W update, before the solve
        pass

    def enditer(self):              # after the solve
        pass

    def post_everything(self):
        pass
