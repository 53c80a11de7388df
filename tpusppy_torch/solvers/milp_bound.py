"""Partial MILP lift for Lagrangian outer bounds.

A copy of ``tpusppy/solvers/milp_bound.py``, host HiGHS work through the
port's :func:`.scipy_backend.solve_lp` (its MIP result carries HiGHS's
best bound, ``SolveResult.dual_bound``).

The reference's Lagrangian spoke inherits the hub's MIP solver, so its
per-scenario subproblem minima are INTEGER minima
(mpisppy/cylinders/lagrangian_bounder.py:19-56 with a persistent MIP solver
behind it): its dual bound closes the integrality gap that a pure
LP-relaxation bound cannot.

The port's device path solves LP relaxations (batched ADMM), so the spoke's
baseline certificate is the per-scenario LP dual objective
(:meth:`tpusppy_torch.spopt.SPOpt.Edualbound_perscen`).  This module lifts
it:

    For ANY subset M of scenarios,
        bound = sum_{s in M} p_s * milp_dual_bound_s
              + sum_{s not in M} p_s * lp_dual_s
    is a certified lower bound on the EF optimum: each term independently
    lower-bounds its scenario's integer minimum of the W-augmented
    objective, and the probability-weighted W sums to zero per node.

So the lift is budget-elastic: spend ``budget_s`` host-seconds solving
scenario MILPs (HiGHS); whatever fraction completes tightens the bound,
the rest keep their LP certificate.  Even a time-limited MILP contributes:
HiGHS's best bound (``SolveResult.dual_bound``) is certified at any stop.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait

import numpy as np

from . import scipy_backend


def milp_lift(batch, q, base_perscen, *, budget_s=30.0, mip_rel_gap=1e-4,
              time_limit=30.0, workers=None, order=None, want_x=False):
    """Lift per-scenario LP dual bounds to MILP dual bounds, budget-bound.

    ``q``: (S, n) per-scenario objective (c + W on nonant columns — the
    caller's W-augmented objective, prox off).  ``base_perscen``: (S,)
    certified LP dual bounds including ``batch.const``.  Returns
    ``(lifted (S,), n_lifted)`` — or ``(lifted, n_lifted, X)`` with
    ``want_x`` where ``X`` is the (S, n) MILP minimizers (NaN rows for
    unlifted scenarios; :func:`milp_dual_ascent` consumes them as
    subgradients).  Every entry keeps the LP certificate whenever that is
    the tighter bound — both certify the scenario's integer minimum.

    ``order``: scenario visit order (default: descending probability, so a
    truncated budget lifts the heaviest terms first).  ``workers`` threads
    solve concurrently (HiGHS releases the GIL); on single-core hosts this
    degrades gracefully to serial.
    """
    S = batch.num_scenarios
    lifted = np.array(base_perscen, dtype=float, copy=True)
    X = np.full((S, batch.num_vars), np.nan) if want_x else None
    if not bool(np.asarray(batch.is_int).any()):
        # continuous family: LP bound is already exact
        return (lifted, 0, X) if want_x else (lifted, 0)
    probs = np.asarray(batch.tree.scen_prob, dtype=float)
    if order is None:
        order = np.argsort(-probs, kind="stable")
    q = np.asarray(q, dtype=float)
    const = np.broadcast_to(np.asarray(batch.const), (S,))
    deadline = time.monotonic() + float(budget_s)
    workers = workers or min(8, os.cpu_count() or 1)
    # shared-A families: one csr conversion for the whole lift round
    import scipy.sparse as _sp

    A_sh = getattr(batch, "A_shared", None)
    A_csr = _sp.csr_matrix(np.asarray(A_sh)) if A_sh is not None else None

    def solve(s):
        rem = deadline - time.monotonic()
        if rem <= 0.05:
            return s, None
        res = scipy_backend.solve_lp(
            q[s], A_csr if A_csr is not None else batch.A[s],
            batch.cl[s], batch.cu[s],
            batch.lb[s], batch.ub[s], is_int=batch.is_int,
            mip_rel_gap=mip_rel_gap,
            time_limit=min(float(time_limit), rem))
        return s, res

    n_lifted = 0
    order = list(order)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        pending = set()
        while order or pending:
            while order and len(pending) < workers:
                if time.monotonic() >= deadline:
                    order = []
                    break
                pending.add(ex.submit(solve, order.pop(0)))
            if not pending:
                break
            done, pending = wait(pending, return_when=FIRST_COMPLETED)
            for fut in done:
                s, res = fut.result()
                db = None if res is None else res.dual_bound
                if db is not None and np.isfinite(db):
                    # RESULT-PLUMBING CONTRACT (regression-tested): a
                    # time-limited best-bound that is LOOSER than the
                    # scenario's existing LP certificate is never
                    # installed — both certify the same integer minimum,
                    # so the per-scenario max is the certificate
                    cand = db + float(const[s])
                    if cand > lifted[s]:
                        lifted[s] = cand
                    if X is not None and res.feasible \
                            and res.status == "0":
                        # only gap-closed solves install X: the rows are
                        # documented as MILP MINIMIZERS (milp_dual_ascent
                        # consumes them as subgradients), and a
                        # time-limited incumbent is merely feasible
                        X[s] = res.x
                    n_lifted += 1
    return (lifted, n_lifted, X) if want_x else (lifted, n_lifted)


def milp_dual_ascent(batch, W, base_fn, *, steps=8, budget_s=120.0,
                     step0=None, mip_rel_gap=1e-3, time_limit=30.0,
                     workers=None):
    """Projected subgradient ascent on the INTEGER Lagrangian dual.

    The Lagrangian dual value L(W) = sum_s p_s min{(c_s + W_s).x : x in
    X_s^int} is concave in W with subgradient (x_s* - xbar*) per scenario;
    ascent steps tighten the certified bound past what the hub's PH weights
    reach (PH's W targets the LP-relaxation dual; the integer dual optimum
    sits above it by part of the integrality gap).  Reference analogue: the
    Lagranger spoke takes its own steps on W rather than mirroring the hub
    (mpisppy/cylinders/lagranger_bounder.py).

    ``base_fn(W) -> (q (S, n), base_perscen (S,))`` supplies the
    W-augmented objective and the LP fallback certificates for partial
    lifts.  Every iterate's value is a VALID bound (any W with
    probability-weighted zero mean certifies); the best is kept.  Returns
    ``(best_bound, best_W)``.
    """
    nid = np.asarray(batch.tree.nonant_indices)
    probs = np.asarray(batch.tree.scen_prob, dtype=float)
    W = np.array(W, dtype=float, copy=True)
    deadline = time.monotonic() + float(budget_s)
    best = -np.inf
    best_W = W.copy()
    step = step0
    for _ in range(int(steps)):
        rem = deadline - time.monotonic()
        if rem <= 1.0:
            break
        q, base = base_fn(W)
        lifted, n, X = milp_lift(
            batch, q, base, budget_s=rem, mip_rel_gap=mip_rel_gap,
            time_limit=time_limit, workers=workers, want_x=True)
        val = float(probs @ lifted)
        if val > best:
            best, best_W = val, W.copy()
        ok = ~np.isnan(X[:, 0])
        if not ok.all():
            break                 # partial lift: subgradient incomplete
        xs = X[:, nid]
        g = xs - (probs @ xs)[None, :]
        gn = np.sqrt(float((probs[:, None] * g * g).sum()))
        if gn < 1e-12:
            break                 # consensus among integer minimizers
        if step is None:
            # scale the first step to move the dual by ~0.1% of |best|
            step = 1e-3 * max(abs(best), 1.0) / gn
        W = best_W + step * g
        W = W - (probs @ W)[None, :]    # probability-weighted zero mean
        step *= 0.7
    return best, best_W
