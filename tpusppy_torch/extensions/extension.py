"""Extension plugin ABC — hub-side callout points.

A copy of ``tpusppy/extensions/extension.py`` (which mirrors
``mpisppy/extensions/extension.py:12-169``): the callout points the legacy
PH loop calls from PHBase.Iter0/iterk_loop/post_loops and SPOpt.solve_loop,
with the ``*_after_sync`` points a wheel's hub calls after each sync with
its spokes, and :class:`MultiExtension` composition.  Extensions receive
the opt object (``self.opt``) and may read or mutate PH state arrays (W,
rho, xbar, local_x ...).
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

    def post_iter0_after_sync(self):
        pass

    def miditer(self):              # after xbar/W update, before the solve
        pass

    def enditer(self):              # after the solve
        pass

    def enditer_after_sync(self):
        pass

    def post_everything(self):
        pass


class MultiExtension(Extension):
    """Compose several extensions (extension.py:113-169)."""

    _CALLOUTS = frozenset((
        "pre_solve", "post_solve", "pre_solve_loop", "post_solve_loop",
        "pre_iter0", "post_iter0", "post_iter0_after_sync", "miditer",
        "enditer", "enditer_after_sync", "post_everything"))

    def __init__(self, spopt_object, ext_classes=None):
        super().__init__(spopt_object)
        ext_classes = ext_classes or spopt_object.options.get("ext_classes",
                                                              [])
        self.extensions = [cls(spopt_object) for cls in ext_classes]

    def __getattribute__(self, name):
        if name in MultiExtension._CALLOUTS:
            exts = object.__getattribute__(self, "extensions")

            def fanout():
                for e in exts:
                    getattr(e, name)()

            return fanout
        return object.__getattribute__(self, name)
