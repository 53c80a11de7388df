"""Single-dispatch twins of the segmented solve entry points.

``tpusppy/solvers/segmented.py`` splits oversized sweep loops into bounded
dispatches sized from TPU FLOP budgets (a remote TPU worker kills long
executions) and can pipeline them speculatively.  Neither applies to the
port yet: both functions here are ONE solve call, so the amortized solve
loop keeps the reference's shape.  At the shapes the parity tests use, the
reference does not segment either.
"""

from __future__ import annotations

from ..obs import trace as _trace


def solve_factored_segmented(factored_fn, args, settings, warm=None):
    """Adaptive solve; returns ``(sol, factors)``."""
    with _trace.span("dispatch", "adaptive_solve"):
        return factored_fn(*args, settings=settings, warm=warm)


def solve_frozen_segmented(frozen_fn, args, factors, settings, warm=None):
    """Sweep-only solve on a refresh solve's ``factors``; returns ``sol``."""
    with _trace.span("dispatch", "frozen_solve"):
        return frozen_fn(*args, factors, settings=settings, warm=warm)
