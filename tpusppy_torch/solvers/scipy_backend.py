"""HiGHS (scipy) validation backend.

The reference delegates every subproblem/EF solve to an external commercial
solver through Pyomo's SolverFactory (spopt.py:839-903).  The port's primary
solver is the batched ADMM (:mod:`tpusppy_torch.solvers.admm`); this module
is the analogue of the external-solver path — a CPU LP/MILP solve via
scipy's vendored HiGHS — used for golden-value tests and as a fallback backend.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.optimize as sopt
import scipy.sparse as sp


@dataclasses.dataclass
class SolveResult:
    x: np.ndarray
    obj: float
    duals: np.ndarray | None
    status: str
    feasible: bool
    # MIP solves: HiGHS's best dual (lower) bound — certified even when the
    # solve stops on a gap/time limit; None for LP/IPM paths
    dual_bound: float | None = None


def solve_lp(c, A, cl, cu, lb, ub, is_int=None, q2=None, const=0.0,
             mip_rel_gap=None, time_limit=None) -> SolveResult:
    """Solve one canonical-form problem with HiGHS.

    Quadratic objectives are not supported by scipy's HiGHS wrapper; callers
    with q2 != 0 must use the ADMM backend (this mirrors the reference, where
    solver capability gates algorithm choice, e.g. sc.py:18-21).
    """
    if q2 is not None and np.any(q2 != 0):
        raise NotImplementedError("HiGHS backend is LP/MILP only; use admm for QP")
    m, n = A.shape
    if not sp.issparse(A):
        A = sp.csr_matrix(np.asarray(A))
    constraints = sopt.LinearConstraint(A, cl, cu) if m else ()
    integrality = None
    if is_int is not None and np.any(is_int):
        integrality = np.where(is_int, 1, 0)
    options = {}
    if mip_rel_gap is not None:
        options["mip_rel_gap"] = mip_rel_gap
    if time_limit is not None:
        options["time_limit"] = time_limit
    res = sopt.milp(
        c=c,
        constraints=constraints,
        integrality=integrality,
        bounds=sopt.Bounds(lb, ub),
        options=options,
    )
    # milp status: 0 optimal, 1 iteration/time limit (may carry an incumbent),
    # 2 infeasible, 3 unbounded, 4 other
    feasible = res.x is not None and res.status in (0, 1)
    x = res.x if res.x is not None else np.zeros(n)
    obj = float(c @ x + const) if res.x is not None else np.inf
    db = getattr(res, "mip_dual_bound", None)
    if db is None and res.status == 0:
        db = obj                 # LP optimal: the solve itself is the bound
    elif db is not None:
        db = float(db + const)
    # scipy.milp does not expose duals; LP duals come from linprog when needed.
    return SolveResult(x=x, obj=obj, duals=None, status=str(res.status),
                       feasible=feasible, dual_bound=db)


def solve_lp_with_duals(c, A, cl, cu, lb, ub, const=0.0,
                        time_limit=None, feas_tol=None) -> SolveResult:
    """Continuous LP with row duals via linprog (for Benders/Lagrangian
    checks and the straggler rescue).  ``A`` goes through scipy.sparse:
    UC-scale matrices are ~0.3% dense, and linprog's dense input path
    both copies and scans the full (m, n) array per call.
    ``time_limit``: HiGHS wall-clock cap in seconds (budgeted callers —
    e.g. donor-dual rounds — must not hang on one degenerate LP).
    ``feas_tol``: HiGHS's primal feasibility tolerance (its default,
    1e-7, when None)."""
    # linprog wants A_ub x <= b_ub and A_eq x = b_eq; split rows.
    if not sp.issparse(A):
        A = sp.csr_matrix(np.asarray(A))
    eq = np.isfinite(cl) & np.isfinite(cu) & (cl == cu)
    ub_rows = np.isfinite(cu) & ~eq
    lb_rows = np.isfinite(cl) & ~eq
    A_ub = (sp.vstack([A[ub_rows], -A[lb_rows]], format="csr")
            if (ub_rows.any() or lb_rows.any()) else None)
    b_ub = np.concatenate([cu[ub_rows], -cl[lb_rows]]) if A_ub is not None else None
    A_eq = A[eq] if eq.any() else None
    b_eq = cl[eq] if eq.any() else None
    options = {"time_limit": float(time_limit)} if time_limit else {}
    if feas_tol is not None:
        options["primal_feasibility_tolerance"] = float(feas_tol)
    res = sopt.linprog(c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
                       bounds=np.stack([lb, ub], axis=1), method="highs",
                       options=options or None)
    duals = None
    if res.status == 0:
        duals = np.zeros(A.shape[0])
        if A_eq is not None:
            duals[np.flatnonzero(eq)] = res.eqlin.marginals
        k = 0
        for rows, sign in ((ub_rows, 1.0), (lb_rows, -1.0)):
            cnt = int(rows.sum())
            if cnt:
                duals[np.flatnonzero(rows)] += sign * res.ineqlin.marginals[k:k + cnt]
                k += cnt
    x = res.x if res.x is not None else np.zeros(A.shape[1])
    return SolveResult(x=x, obj=float(res.fun + const) if res.status == 0 else np.inf,
                       duals=duals, status=str(res.status), feasible=res.status == 0)


def solve_qp_with_duals(c, q2, A, cl, cu, lb, ub, const=0.0,
                        tol=1e-9, max_iter=60) -> SolveResult:
    """One host-exact diagonal-Hessian QP with row duals (the QP sibling of
    :func:`solve_lp_with_duals`): :func:`solve_qp_batch_with_duals` on a
    batch of one; ``obj`` includes ``const`` and is inf where infeasible."""
    c = np.asarray(c, float)
    q2 = np.asarray(q2, float)
    x, y, feasible = solve_qp_batch_with_duals(
        c[None], q2[None], A, np.asarray(cl, float)[None],
        np.asarray(cu, float)[None], np.asarray(lb, float)[None],
        np.asarray(ub, float)[None], tol=tol, max_iter=max_iter)
    obj = float(c @ x[0] + 0.5 * (q2 @ (x[0] * x[0])) + const)
    return SolveResult(x=x[0], obj=obj if feasible[0] else np.inf,
                       duals=y[0], status="ipm", feasible=bool(feasible[0]))


def solve_qp_batch_with_duals(c, q2, A, cl, cu, lb, ub, tol=1e-9,
                              max_iter=60):
    """Host-exact diagonal-Hessian QPs with row duals, k scenarios at once:
    the QP sibling of :func:`solve_lp_with_duals` for the straggler rescue
    (scipy's HiGHS wrapper is LP/MILP only, so this is a self-contained
    dense Mehrotra predictor-corrector IPM in numpy).

        min c.x + 0.5 x'diag(q2)x   s.t. cl <= Ax <= cu, lb <= x <= ub

    Row duals y follow the framework's convention (y > 0 active at cu,
    y < 0 at cl — the convention :func:`tpusppy_torch.solvers.admm.
    dual_objective` certifies bounds with).  Equality rows (cl == cu) are
    handled through an explicit augmented KKT block, not a large penalty.
    Vectorized over a leading scenario axis: the per-iteration
    factorization is one LAPACK-batched (k, n+me, n+me) solve, so rescuing
    dozens of stragglers costs one IPM run (the caller is
    ``spopt._rescue_stragglers``).

    ``A`` may be (m, n) — shared across scenarios, the shared-A family
    case, keeping the rescue at zero extra constraint memory — or
    (k, m, n).  Returns ``(x (k, n), y (k, m), feasible (k,) bool)``.
    Scenarios are grouped by equality-row pattern (the augmented KKT block
    must be structurally shared inside one batched solve); family slices
    share the pattern, so the common case is a single group.
    """
    c = np.atleast_2d(np.asarray(c, float))
    q2 = np.atleast_2d(np.asarray(q2, float))
    k, n = c.shape
    A = np.asarray(A, float)
    shared = A.ndim == 2
    m = A.shape[-2]
    cl = np.broadcast_to(np.asarray(cl, float), (k, m))
    cu = np.broadcast_to(np.asarray(cu, float), (k, m))
    lb = np.broadcast_to(np.asarray(lb, float), (k, n))
    ub = np.broadcast_to(np.asarray(ub, float), (k, n))
    eq = (np.where(np.isfinite(cu), cu, 1e18)
          - np.where(np.isfinite(cl), cl, -1e18)) < 1e-9
    x = np.zeros((k, n))
    y = np.zeros((k, m))
    feasible = np.zeros(k, bool)
    groups = {}
    for s in range(k):
        groups.setdefault(eq[s].tobytes(), []).append(s)
    for idx in groups.values():
        idx = np.asarray(idx)
        Ag = A if shared else A[idx]
        xg, yg, fg, _, _ = _qp_ipm_batch(
            c[idx], q2[idx], Ag, cl[idx], cu[idx], lb[idx], ub[idx],
            tol, max_iter)
        x[idx], y[idx], feasible[idx] = xg, yg, fg
    return x, y, feasible


def _qp_ipm_batch(c, q2, A, cl, cu, lb, ub, tol, max_iter):
    """Core batched Mehrotra IPM; every scenario in the batch must share
    one equality-row pattern (callers group).  Equality rows enter an
    augmented quasi-definite KKT system

        [ A_in' Dz A_in + diag(q2 + Dx)   A_eq' ] [dx   ]   [rhs_x]
        [ A_eq                            -dI   ] [dy_eq] = [rp_eq]

    solved LAPACK-batched; inequality-row duals stay condensed through Dz.
    Returns (x, y, feasible, res, mu), all with the leading k axis.
    """
    k, n = c.shape
    shared = A.ndim == 2
    m = A.shape[-2]

    # Ruiz equilibration + cost normalization: the raw UC family (|c| ~ 1e4,
    # |A| rows ~ 1e3) collapses Mehrotra step lengths to ~1e-7 from the
    # first iteration without it.  Same posture as the ADMM solver's
    # scaling; duals unscale as y = k_c E y_hat, box duals fold into the
    # returned stationarity identity automatically.
    finL_c = np.isfinite(cl) & (cl > -1e17)
    finU_c = np.isfinite(cu) & (cu < 1e17)
    finL_b = np.isfinite(lb) & (lb > -1e17)
    finU_b = np.isfinite(ub) & (ub < 1e17)
    Aref = np.abs(A) if shared else np.abs(A).mean(axis=0)
    D = np.ones(n)
    E = np.ones(m)
    for _ in range(10):
        Am = Aref * E[:, None] * D[None, :]
        rm = Am.max(axis=1)
        cm = Am.max(axis=0)
        # all-zero rows/columns (preallocated cut slots, ir.with_extra) must
        # keep unit scale — dividing by sqrt(eps) diverges 1e6x per sweep
        E /= np.where(rm > 0, np.sqrt(np.maximum(rm, 1e-12)), 1.0)
        D /= np.where(cm > 0, np.sqrt(np.maximum(cm, 1e-12)), 1.0)
    A = A * (E[:, None] * D[None, :])
    c = c * D
    q2 = q2 * D * D
    kc = np.maximum(1.0, np.abs(c).max(axis=1, initial=0.0))[:, None]
    c = c / kc
    q2 = q2 / kc
    cl = np.where(finL_c, cl * E, -np.inf)
    cu = np.where(finU_c, cu * E, np.inf)
    lb = np.where(finL_b, lb / D, -np.inf)
    ub = np.where(finU_b, ub / D, np.inf)

    def Ax(v):      # (k, n) -> (k, m)
        return v @ A.T if shared else np.einsum("kmn,kn->km", A, v)

    def ATy(v):     # (k, m) -> (k, n)
        return v @ A if shared else np.einsum("kmn,km->kn", A, v)

    big = 1e18
    cl = np.where(np.isfinite(cl), cl, -big)
    cu = np.where(np.isfinite(cu), cu, big)
    lb = np.where(np.isfinite(lb), lb, -big)
    ub = np.where(np.isfinite(ub), ub, big)
    eq1 = (cu[0] - cl[0]) < 1e-9           # shared pattern (callers group)
    eq = eq1[None, :]
    idx_eq = np.flatnonzero(eq1)
    me = idx_eq.size
    A_eq = (A[idx_eq] if shared else A[:, idx_eq, :])   # (me, n) / (k, me, n)
    fzL = (cl > -big / 2) & ~eq
    fzU = (cu < big / 2) & ~eq
    fxL = lb > -big / 2
    fxU = ub < big / 2

    scale = np.maximum(1.0, np.maximum(np.abs(c).max(axis=1, initial=0.0),
                                       np.abs(q2).max(axis=1, initial=0.0)))

    def interior(v, lo, hi, finL, finU):
        mid = np.where(finL & finU, 0.5 * (lo + hi), v)
        v = np.where(finL & finU, mid, v)
        v = np.where(finL & ~finU, np.maximum(v, lo + 1.0), v)
        v = np.where(~finL & finU, np.minimum(v, hi - 1.0), v)
        return v

    x = interior(np.zeros((k, n)), lb, ub, fxL, fxU)
    z = interior(Ax(x), cl, cu, fzL, fzU)
    z = np.where(eq, cl, z)
    y = np.zeros((k, m))
    sL = np.where(fzL, 1.0, 0.0)
    sU = np.where(fzU, 1.0, 0.0)
    piL = np.where(fxL, 1.0, 0.0)
    piU = np.where(fxU, 1.0, 0.0)
    delta = 1e-10 * max(1.0, float(np.abs(A_eq).max(initial=0.0)))

    def gaps():
        gL = np.where(fzL, np.maximum(z - cl, 1e-14), 1.0)
        gU = np.where(fzU, np.maximum(cu - z, 1e-14), 1.0)
        hL = np.where(fxL, np.maximum(x - lb, 1e-14), 1.0)
        hU = np.where(fxU, np.maximum(ub - x, 1e-14), 1.0)
        return gL, gU, hL, hU

    n_compl = np.maximum(
        fzL.sum(axis=1) + fzU.sum(axis=1) + fxL.sum(axis=1) + fxU.sum(axis=1),
        1)
    res = np.full(k, np.inf)
    mu = np.full(k, np.inf)
    eye = np.arange(n)
    M = None if me else np.empty(0)   # KKT block allocated once, first use
    for _ in range(max_iter):
        gL, gU, hL, hU = gaps()
        rd = -(c + q2 * x + ATy(y) - piL + piU)
        rp = -(Ax(x) - z)
        ry = -(y - sU + sL)
        mu = ((sL * np.where(fzL, gL, 0.0)).sum(axis=1)
              + (sU * np.where(fzU, gU, 0.0)).sum(axis=1)
              + (piL * np.where(fxL, hL, 0.0)).sum(axis=1)
              + (piU * np.where(fxU, hU, 0.0)).sum(axis=1)) / n_compl
        res = np.maximum(
            np.abs(rd).max(axis=1, initial=0.0) / scale,
            np.maximum(np.abs(rp).max(axis=1, initial=0.0),
                       np.abs(np.where(eq, 0.0, ry)).max(axis=1, initial=0.0)))
        done = (res < tol) & (mu < tol)
        if done.all():
            break

        Dz = np.where(eq, 0.0, sL / gL * fzL + sU / gU * fzU)
        Dx = piL / hL * fxL + piU / hU * fxU
        # broadcasted matmul, NOT einsum: np.einsum("mn,km,mp->knp") does
        # not dispatch to batched GEMM and is ~65x slower at these shapes
        if shared:
            H = np.matmul(A.T, Dz[:, :, None] * A)
        else:
            H = np.matmul(np.swapaxes(A, 1, 2), Dz[:, :, None] * A)
        H[:, eye, eye] += q2 + Dx + 1e-11 * scale[:, None]
        if me:
            if M is None:
                M = np.zeros((k, n + me, n + me))
                M[:, :n, n:] = A_eq.T if shared else np.swapaxes(A_eq, 1, 2)
                M[:, n:, :n] = A_eq
                M[:, n:, n:] = -delta * np.eye(me)
            M[:, :n, :n] = H
        else:
            M = H
        rp_eq = rp[:, idx_eq]

        def newton(mu_t, dsL0, dsU0, dpiL0, dpiU0, dz0, dx0):
            cL = mu_t - sL * gL * fzL - dsL0 * dz0 * fzL
            cU = mu_t - sU * gU * fzU + dsU0 * dz0 * fzU
            bL = mu_t - piL * hL * fxL - dpiL0 * dx0 * fxL
            bU = mu_t - piU * hU * fxU + dpiU0 * dx0 * fxU
            rhs_y = np.where(
                eq, 0.0,
                ry + np.where(fzU, cU / gU, 0.0) - np.where(fzL, cL / gL, 0.0))
            rhs_x = (rd + np.where(fxL, bL / hL, 0.0)
                     - np.where(fxU, bU / hU, 0.0))
            rhs = rhs_x + ATy(Dz * rp - rhs_y)
            rhs_full = np.concatenate([rhs, rp_eq], axis=1)
            try:
                sol = np.linalg.solve(M, rhs_full[..., None])[..., 0]
            except np.linalg.LinAlgError:
                sol = np.stack([
                    np.linalg.lstsq(M[i], rhs_full[i], rcond=None)[0]
                    for i in range(k)])
            dx = sol[:, :n]
            dy = Dz * (Ax(dx) - rp) + rhs_y
            if me:
                dy[:, idx_eq] = sol[:, n:]
            dz = np.where(eq, 0.0, Ax(dx) - rp)
            dsL = np.where(fzL, (cL - sL * dz) / gL, 0.0)
            dsU = np.where(fzU, (cU + sU * dz) / gU, 0.0)
            dpiL = np.where(fxL, (bL - piL * dx) / hL, 0.0)
            dpiU = np.where(fxU, (bU + piU * dx) / hU, 0.0)
            return dx, dz, dy, dsL, dsU, dpiL, dpiU

        def steplen(dz, dx, dsL, dsU, dpiL, dpiU):
            def ratio(v, dv, mask):
                r = np.where(mask & (dv < 0),
                             -v / np.where(dv < 0, dv, -1.0), np.inf)
                return r.min(axis=1, initial=np.inf)
            ap = np.minimum(np.minimum(ratio(gL, dz, fzL), ratio(gU, -dz, fzU)),
                            np.minimum(ratio(hL, dx, fxL), ratio(hU, -dx, fxU)))
            ad = np.minimum(
                np.minimum(ratio(sL, dsL, fzL), ratio(sU, dsU, fzU)),
                np.minimum(ratio(piL, dpiL, fxL), ratio(piU, dpiU, fxU)))
            return np.minimum(1.0, 0.995 * ap), np.minimum(1.0, 0.995 * ad)

        zero = np.zeros_like
        dx_a, dz_a, dy_a, dsL_a, dsU_a, dpiL_a, dpiU_a = newton(
            0.0, zero(sL), zero(sU), zero(piL), zero(piU), zero(z), zero(x))
        ap_a, ad_a = steplen(dz_a, dx_a, dsL_a, dsU_a, dpiL_a, dpiU_a)
        apc, adc = ap_a[:, None], ad_a[:, None]
        mu_aff = (((sL + adc * dsL_a) * np.where(fzL, gL + apc * dz_a, 0.0)
                   ).sum(axis=1)
                  + ((sU + adc * dsU_a) * np.where(fzU, gU - apc * dz_a, 0.0)
                     ).sum(axis=1)
                  + ((piL + adc * dpiL_a) * np.where(fxL, hL + apc * dx_a, 0.0)
                     ).sum(axis=1)
                  + ((piU + adc * dpiU_a) * np.where(fxU, hU - apc * dx_a, 0.0)
                     ).sum(axis=1)) / n_compl
        sigma = np.minimum(
            1.0, np.maximum(0.0, mu_aff / np.maximum(mu, 1e-300))) ** 3
        dx, dz, dy, dsL, dsU, dpiL, dpiU = newton(
            (sigma * mu)[:, None], dsL_a, dsU_a, dpiL_a, dpiU_a, dz_a, dx_a)
        ap, ad = steplen(dz, dx, dsL, dsU, dpiL, dpiU)
        ap = np.where(done, 0.0, ap)[:, None]   # freeze converged scenarios
        ad = np.where(done, 0.0, ad)[:, None]
        x = x + ap * dx
        z = np.where(eq, cl, z + ap * dz)
        y = y + ad * dy
        sL = np.where(fzL, sL + ad * dsL, 0.0)
        sU = np.where(fzU, sU + ad * dsU, 0.0)
        piL = np.where(fxL, piL + ad * dpiL, 0.0)
        piU = np.where(fxU, piU + ad * dpiU, 0.0)

    # same acceptance rule as before: KKT residuals AND complementarity
    # both small (in the equilibrated frame — the frame the step lives
    # in), else the scenario is not a valid rescue
    lim = max(1e3 * tol, 1e-6)
    feasible = (res < lim) & (mu < lim)
    return x * D[None, :], y * (kc * E[None, :]), feasible, res, mu
