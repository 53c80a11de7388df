"""FLOP model of the batched ADMM engines, for the megastep's billing.

The part of ``tpusppy/solvers/flops.py`` that the megastep's billing
reads (:func:`sweep_flops`, :func:`megastep_flops`,
:func:`bound_pass_flops`) and the tenant window's attribution
(:func:`tenant_shares`); the reference's TPU peak table and MFU
accounting have no use here (the card's window cap is not sized from a
rate: :func:`.segmented.megastep_cap`).  The model counts the dominant
matrix work only (a multiply-add is 2 flops): one ADMM sweep per scenario
is one (n, n) x-update apply plus an A and an A' matvec,
``(n^2 + 2nm) * 2`` flops, scaled by ``sparse_factor`` for a
:class:`~.sparse.SparseA`.  These are model flops of the algorithm, the
same in both packages; they are not a measurement of this card.
"""

from __future__ import annotations


def sweep_flops(S, n, m, sparse_factor=1.0):
    """Model flops of ONE ADMM sweep over an S-scenario batch."""
    return S * (n * float(n) + 2.0 * n * m) * 2.0 * sparse_factor


def megastep_flops(S, n, m, n_iters, sweeps, sparse_factor=1.0):
    """Model flops of one megastep window: ``n_iters`` frozen PH iterations
    of ``sweeps`` ADMM sweeps each (the executed count, never the
    requested one; the refresh runs outside the window)."""
    return max(0, int(n_iters)) * sweep_flops(S, n, m, sparse_factor) \
        * max(float(sweeps), 1.0)


def bound_pass_flops(S, n, m, sweeps, sparse_factor=1.0, n_evals=1):
    """Model flops of one in-wheel bound pass: ``n_evals`` frozen
    evaluations at the measured ``sweeps``, plus one sweep-equivalent for
    the Lagrangian dual-objective assembly (an A'y product and closed-form
    per-coordinate minima)."""
    return sweep_flops(S, n, m, sparse_factor) \
        * (max(1, int(n_evals)) * max(float(sweeps), 1.0) + 1.0)


def tenant_shares(rows):
    """Live-row-fraction weights of a shared window: K tenants share one
    window, and its wall and flops split ``rows_t / sum(rows)``, where
    ``rows_t`` is ``S_t * max(1, executed_t)`` for a live tenant and 0 for
    a ghost slot.  All zeros gives all-zero shares."""
    rows = [max(0.0, float(r)) for r in rows]
    total = sum(rows)
    if total <= 0.0:
        return [0.0] * len(rows)
    return [r / total for r in rows]
