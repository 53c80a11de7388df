"""Batched OSQP-style ADMM QP/LP solver in PyTorch — the subproblem engine.

Port of ``tpusppy/solvers/admm.py``.  The whole
scenario batch is solved by one batched program: batched Cholesky
factorizations (``torch.linalg``), an inner sweep loop whose
``check_every``-sweep blocks run in the hand-written ``fused_sweeps`` CUDA
kernel (:mod:`.cuda_kernels`), and PH's per-iteration objective update is
just a new (q, rho) plus a warm start.

Canonical form per scenario (see :mod:`tpusppy_torch.ir`):

    minimize    0.5 x' diag(q2) x + c' x
    subject to  cl <= A x <= cu,   lb <= x <= ub

Splitting (OSQP, Stellato et al.): z_a = A x and z_x = x; the variable-bound
block contributes only diagonal terms to the x-update system

    (diag(q2) + sigma I + A' R_a A + R_x) x~ =
        sigma x - q + A'(R_a z_a - y_a) + (R_x z_x - y_x)

with per-row penalties R (equality rows boosted, free rows damped).  Ruiz
equilibration preconditions the batch; adaptive-rho restarts refactorize.

Differences from the JAX package: the batch dimension is explicit, the inner
``lax.while_loop`` runs in :mod:`.device_loop` (on CUDA as replays of a
CUDA graph of :data:`BLOCKS_PER_REPLAY` sweep blocks, the host reading one
stop flag a replay, counted as ``admm.loop_checks``), the restart
``lax.scan`` is a Python loop that reads nothing from the device, and there
is no dense ``P`` term.  Every entry point takes ``device=``; without it,
the device of the first tensor argument, else CUDA
(:func:`tpusppy_torch.resolve_device`).

The mixed-precision frozen sweep (doc/precision.md,
``ADMMSettings.sweep_precision``): :func:`solve_batch_frozen` runs a sweep
phase at "default" (bf16) or "high" (bf16x3) with the defect against K,
every residual, the Ax re-anchor and the vote exact, then, where it did not
converge, a full-precision refinement phase of ``precision_refine_iters``
sweeps on the same factors (:func:`_frozen_sweep_phases`); the host guard
(:func:`precision_guard_trips`) sends a parked lowered solve back to
"highest".  Refresh and adaptive solves, polish and the bounds are never
lowered.  As in the reference, the kernel runs "default" lowered and "high"
exact (``fused_sweeps``' per-scenario products have no passes to save,
``pallas_kernels.py:73-76``), while the tensor path (``use_kernel=False``)
runs both through :func:`.precision.contract`, "high" as bf16x3: a test
with the kernel on holds the kernel's mode, one with it off the
reference's XLA sweep.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from . import cuda_kernels, device_loop, hostsync, precision
from .cuda_kernels import matvec as _mv
from .cuda_kernels import rmatvec as _rmv

BIG = 1e20  # stand-in for +inf inside kernels (keeps arithmetic finite)

#: Sweep blocks a CUDA-graph replay of the dense engine's loop runs (the
#: host reads the stop flag once a replay).  250, the block cap at the
#: default max_iter and check_every, is a multiple, so a solve that runs to
#: its cap runs no block past it; one that stops earlier runs at most 9
#: gated blocks and one speculative replay past it (PERF.md).  Without the
#: plateau exit (farmer) every block is alike: one graph a run.
BLOCKS_PER_REPLAY = 10


@dataclasses.dataclass(frozen=True)
class ADMMSettings:
    sigma: float = 1e-6
    alpha: float = 1.6
    rho: float = 0.1
    rho_eq_scale: float = 1e3
    rho_min: float = 1e-6
    rho_max: float = 1e6
    max_iter: int = 1000          # inner iterations per rho setting
    restarts: int = 4             # rho-adaptation refactorizations
    check_every: int = 4          # sweeps per termination check
    solve_refine: int = 2         # refinement passes per x-update solve
    eps_abs: float = 1e-8
    eps_rel: float = 1e-8
    scaling_iters: int = 10
    polish: bool = True           # active-set KKT polish (OSQP-style)
    polish_passes: int = 4        # active-set correction passes
    polish_delta: float = 1e-8
    # The hand-written CUDA sweep kernels (cuda_kernels.py).  "auto" and
    # True run every sweep block through the kernel's wrapper, which raises
    # on a CUDA shape the kernel does not take (the TPU's measured loss band
    # does not carry over to Hopper); False always takes the batched tensor
    # path.  On CPU tensors the wrapper runs its plain version, which is the
    # same recurrence.
    use_kernel: bool | str = "auto"
    # Per-ROW rho adaptation between restarts: rows (and variable boxes) with
    # persistent primal violation get their penalty boosted.
    rho_row_adapt: bool = True
    rho_row_boost: float = 10.0
    rho_row_max: float = 1e6
    dtype: str = "float64"
    # In-loop plateau exit (see tpusppy ADMMSettings.sweep_plateau_rtol);
    # 0 disables.  ``BatchSolution.done`` reports true eps-convergence.
    sweep_plateau_rtol: float = 0.0
    sweep_plateau_window: int = 32
    # Shared-A factors keep the dense K for refinement (False drops it from
    # SharedFactors; frozen solves then refine matrix-free through A).
    factors_keep_K: bool = True
    # Mixed-precision frozen sweep (doc/precision.md): None or "highest"
    # leaves every path exact; "default" (bf16) or "high" (bf16x3) runs
    # the frozen sweep phase lowered with the x-update defect, every
    # residual and the Ax re-anchor exact, then, if not eps-converged, a
    # full-precision refinement phase of ``precision_refine_iters`` sweeps
    # on the same factors.  Refresh/adaptive solves and bounds never lower.
    sweep_precision: str | None = None
    precision_refine_iters: int = 64
    # Host guard (spopt._solve_amortized): a lowered frozen solve whose
    # worst residual exceeds ``precision_guard`` x the last full-precision
    # refresh floor (and is not converged) re-runs at "highest" on the same
    # factors.  <= 0 disables.
    precision_guard: float = 10.0
    # The PH megastep (doc/pipeline.md; ``phbase.PHBase._megastep_request``):
    # a hub runs N frozen PH iterations a window on the device with one
    # packed fetch.  0 = auto (N from the refresh cadence, within
    # ``segmented.megastep_cap``), 1 = the legacy per-iteration loop, k > 1
    # asks for N = k.  Read on the host (PHBase), never inside a solve.
    megastep: int = 0

    def tdtype(self) -> torch.dtype:
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        return dt

    def sweep_mode(self) -> str:
        """Effective frozen-sweep precision (the port has no lowered
        ``matmul_precision``: its solves are exact outside the sweep)."""
        return self.sweep_precision or "highest"


class BatchSolution(NamedTuple):
    x: torch.Tensor       # (S, n)
    z: torch.Tensor       # (S, m) constraint-row auxiliaries
    y: torch.Tensor       # (S, m) constraint-row duals
    yx: torch.Tensor      # (S, n) variable-bound duals
    pri_res: torch.Tensor  # (S,)
    dua_res: torch.Tensor  # (S,)
    iters: torch.Tensor   # (S,) total inner iterations used (same for all)
    done: torch.Tensor    # (S,) met the eps tolerances
    raw: tuple            # pre-polish (x, z, y, yx) — the only valid warm start


class Factors(NamedTuple):
    """Reusable solve state for the frozen-factor path: Ruiz scaling, the
    adapted rho vectors and the x-update system's inverse depend only on
    (A, q2, bounds), so PH reuses them across iterations."""

    D: torch.Tensor       # (S, n) Ruiz column scaling
    E: torch.Tensor       # (S, m) Ruiz row scaling
    cost: torch.Tensor    # (S,) objective scaling
    rho_a: torch.Tensor   # (S, m) row penalties actually used last
    rho_x: torch.Tensor   # (S, n) variable-box penalties actually used last
    Kinv: torch.Tensor    # (S, n, n) explicit inverse of the x-update system
    K: torch.Tensor       # (S, n, n) exact K for iterative refinement


class _BoundMasks(NamedTuple):
    """Finiteness/equality classification of the UNSCALED bounds."""

    fin_cl: torch.Tensor
    fin_cu: torch.Tensor
    fin_lb: torch.Tensor
    fin_ub: torch.Tensor
    eq: torch.Tensor
    eqx: torch.Tensor


class _IterState(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor   # (S, m)
    zx: torch.Tensor  # (S, n)
    y: torch.Tensor
    yx: torch.Tensor
    pri: torch.Tensor
    dua: torch.Tensor
    prinorm: torch.Tensor
    duanorm: torch.Tensor
    k: torch.Tensor      # () int64: sweeps run at this rho setting
    best: torch.Tensor   # () best batch gmean eps-normalized residual
    stall: torch.Tensor  # () int64: consecutive non-improving windows


def _counters(dt, dev):
    """(k, best, stall) of a fresh sweep loop, on the device."""
    return (torch.zeros((), dtype=torch.int64, device=dev),
            torch.full((), torch.inf, dtype=dt, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))


def _initial_state(x0, z0, zx0, y0, yx0) -> _IterState:
    S = x0.shape[0]
    dt, dev = x0.dtype, x0.device
    inf = torch.full((S,), torch.inf, dtype=dt, device=dev)
    one = torch.ones((S,), dtype=dt, device=dev)
    return _IterState(x0, z0, zx0, y0, yx0, inf, inf, one, one,
                      *_counters(dt, dev))


def _clean_bounds(lo, hi):
    lo = torch.nan_to_num(lo, nan=-BIG, neginf=-BIG, posinf=BIG)
    hi = torch.nan_to_num(hi, nan=BIG, neginf=-BIG, posinf=BIG)
    return torch.clamp(lo, min=-BIG), torch.clamp(hi, max=BIG)


def _ruiz(A, q2, iters):
    """Ruiz equilibration of [P A'; A 0] restricted to diagonal scalings:
    (D, E) with E A D of ~unit inf-norm rows/cols."""
    S, m, n = A.shape
    D = torch.ones((S, n), dtype=A.dtype, device=A.device)
    E = torch.ones((S, m), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        As = A * E[:, :, None] * D[:, None, :]
        Ps = q2 * D * D
        col = torch.maximum(As.abs().amax(dim=1), Ps.abs())
        row = As.abs().amax(dim=2)
        # empty rows/columns keep unit scaling
        col = torch.where(col < 1e-12, 1.0, col)
        row = torch.where(row < 1e-12, 1.0, row)
        D = D / torch.sqrt(col)
        E = E / torch.sqrt(row)
    return D, E


def _explicit_inverse(K):
    """K^-1 of an SPD batch: Cholesky, then two triangular solves against
    I, as the reference does.  A failed factorization yields NaN for that
    scenario (as the reference's does) instead of raising, so one bad
    scenario cannot stop the batch."""
    L, info = torch.linalg.cholesky_ex(K)
    L = torch.where((info == 0)[:, None, None], L, torch.nan)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device).expand_as(K)
    t = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.linalg.solve_triangular(L.mT, t, upper=True).contiguous()


def _factor(q2, A, rho_a, rho_x, sigma):
    """(K^-1, K) for K = diag(q2) + sigma I + A' diag(rho_a) A + diag(rho_x).

    The hot loop applies K^-1 as a matvec; refinement against the exact K
    (kept alongside) recovers the digits the explicit inverse loses."""
    n = A.shape[-1]
    K = torch.matmul(A.transpose(1, 2), rho_a[:, :, None] * A)
    K = K + torch.eye(n, dtype=A.dtype, device=A.device)[None] * sigma
    K = K + torch.diag_embed(q2 + rho_x)
    return _explicit_inverse(K), K


def _chol_solve(LK, b, refine=2, prec=None):
    """K^-1 b via the explicit inverse + refinement against the exact K.
    ``prec``: None or "highest" is exact; a lowered mode runs the K^-1
    applies at that mode (:func:`.precision.contract`) while the defect
    ``b - K x`` stays exact (defect at full precision, correction at
    low)."""
    Kinv, K = LK
    if not precision.is_low(prec):
        x = _mv(Kinv, b)
        for _ in range(refine):
            r = b - _mv(K, x)
            x = x + _mv(Kinv, r)
        return x
    x = precision.contract("snk,sk->sn", Kinv, b, prec)
    for _ in range(refine):
        r = b - precision.contract("snk,sk->sn", K, x, "highest")
        x = x + precision.contract("snk,sk->sn", Kinv, r, prec)
    return x


def _done_mask(pri, dua, prinorm, duanorm, st: ADMMSettings):
    """Per-scenario eps-convergence (the inner loop's own OSQP test)."""
    eps_pri = st.eps_abs + st.eps_rel * torch.clamp(prinorm, min=1.0)
    eps_dua = st.eps_abs + st.eps_rel * torch.clamp(duanorm, min=1.0)
    return (pri < eps_pri) & (dua < eps_dua)


def plateau_due(b, st: ADMMSettings, min_k=0) -> bool:
    """Whether block ``b`` of a sweep loop (from 0) ends a plateau window:
    the reference's ``((k // ck) + 1) % period == 0 and k >= min_k`` at the
    block's sweep count ``k = b * ck``, known on the host (with the plateau
    exit off, never).  ``min_k``: stall counting starts only at this sweep
    index (the shared engine's adaptive solve passes its gamma cadence)."""
    if st.sweep_plateau_rtol <= 0:
        return False
    ck = max(1, st.check_every)
    period = max(1, -(-st.sweep_plateau_window // ck))
    return (b + 1) % period == 0 and b * ck >= min_k


def _plateau_update(s, pri, dua, prinorm, duanorm, st: ADMMSettings):
    """(best, stall) after a block that ends a plateau window
    (:func:`plateau_due`), on the device: the geometric mean of
    per-scenario eps-normalized residual excesses clipped to [1, 1e6]
    against the best so far."""
    eps_pri = st.eps_abs + st.eps_rel * torch.clamp(prinorm, min=1.0)
    eps_dua = st.eps_abs + st.eps_rel * torch.clamp(duanorm, min=1.0)
    excess = torch.maximum(pri / eps_pri, dua / eps_dua)
    excess = torch.clamp(torch.nan_to_num(excess, nan=1e6, posinf=1e6),
                         1.0, 1e6)
    gmean = torch.exp(torch.mean(torch.log(excess)))
    improved = (gmean < (1.0 - st.sweep_plateau_rtol) * s.best) | (
        gmean <= 1.0 + st.sweep_plateau_rtol)
    stall = torch.where(improved, 0, s.stall + 1)
    best = torch.minimum(s.best, gmean)
    return best, stall


def _vote(s, st: ADMMSettings):
    """The reference while_loop's exit test on a state, as a 0-dim bool on
    the device: the sweep cap, every scenario eps-converged, or (with the
    plateau exit on) two stalled windows."""
    stop = (s.k >= st.max_iter) | _done_mask(s.pri, s.dua, s.prinorm,
                                              s.duanorm, st).all()
    if st.sweep_plateau_rtol > 0:
        stop = stop | (s.stall >= 2)
    return stop


def _kernel_on(st: ADMMSettings) -> bool:
    """Whether sweep blocks go through the kernel's wrapper (which launches
    the kernel on CUDA tensors, or raises on a shape it does not take) or
    straight to the plain version."""
    if isinstance(st.use_kernel, str) and st.use_kernel != "auto":
        raise ValueError(
            f"use_kernel must be True, False, or 'auto'; got "
            f"{st.use_kernel!r}")
    return bool(st.use_kernel)


def _residuals(q, q2, A, aq, x, z, zx, y, yx, Ax):
    """(pri, dua, prinorm, duanorm) of an iterate with its re-anchored Ax
    (``aq``: max |q| a scenario)."""
    pri = torch.maximum((Ax - z).abs().amax(dim=1),
                        (x - zx).abs().amax(dim=1))
    Aty = _rmv(A, y)
    Pxv = q2 * x
    dua = (Pxv + q + Aty + yx).abs().amax(dim=1)
    prinorm = torch.maximum(Ax.abs().amax(dim=1), z.abs().amax(dim=1))
    duanorm = torch.maximum(
        torch.maximum(Pxv.abs().amax(dim=1), Aty.abs().amax(dim=1)), aq)
    return pri, dua, prinorm, duanorm


def _kernel_prec(prec) -> str:
    """The mode ``fused_sweeps`` runs for a sweep phase at ``prec``, the
    reference's ``kprec`` (``tpusppy/solvers/admm.py:521-527``): "default"
    lowered, anything else exact."""
    return "default" if prec == "default" else "highest"


def _xla_sweeps(q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x, x, z, zx, y,
                yx, Ax, n_sweeps, n_refine, sigma, alpha, prec, stop=None):
    """The reference's XLA sweep at a lowered ``prec`` (``_admm_core``'s
    ``sweep`` with ``lo = precision.contract(..., prec)``): the tensor
    path's block (``use_kernel=False``) at "default" and "high" (bf16x3),
    the A', K^-1 and A products lowered, the K defect exact.  Returns the
    inputs where ``stop`` is set, as the plain versions do."""
    cuda_kernels.bump("plain_calls", "fused_sweeps")
    state_in = (x, z, zx, y, yx, Ax)
    sigma, alpha, beta = float(sigma), float(alpha), 1.0 - float(alpha)

    def lo(spec, a, b):
        return precision.contract(spec, a, b, prec)

    for _ in range(n_sweeps):
        rhs = (sigma * x - q + lo("smn,sm->sn", A, rho_a * z - y)
               + (rho_x * zx - yx))
        xt = _chol_solve((Kinv, K), rhs, refine=n_refine, prec=prec)
        Axt = lo("smn,sn->sm", A, xt)
        x_new = alpha * xt + beta * x
        Ax_new = alpha * Axt + beta * Ax
        za_arg = alpha * Axt + beta * z + y / rho_a
        z_new = torch.clamp(za_arg, cl, cu)
        y_new = y + rho_a * (alpha * Axt + beta * z - z_new)
        zx_arg = alpha * xt + beta * zx + yx / rho_x
        zx_new = torch.clamp(zx_arg, lb, ub)
        yx_new = yx + rho_x * (alpha * xt + beta * zx - zx_new)
        x, z, zx, y, yx, Ax = x_new, z_new, zx_new, y_new, yx_new, Ax_new
    return cuda_kernels._gate(stop, state_in, (x, z, zx, y, yx, Ax))


def _block(ops, cur, plateau, st: ADMMSettings, prec="highest"):
    """One sweep block of the dense engine's loop, in place on ``cur``
    (the :class:`_IterState` fields, the carried Ax, the stop flag): the
    ``check_every`` sweeps in ``fused_sweeps`` gated by the flag (at the
    kernel mode of ``prec``, :func:`_kernel_prec`, on the operand made for
    it; with the kernel off, the plain version, or at a lowered ``prec``
    the reference's XLA sweep), one exact matvec that re-anchors Ax (the
    relaxation, alpha=1.6, amplifies carried rounding across sweeps), the
    residuals, the plateau update where the block ends a window
    (``plateau``, :func:`plateau_due`), the commit (nothing where the flag
    was set), then the exit vote."""
    q, q2, A, cl, cu, lb, ub, Kinv, K, rho_a, rho_x, aq, operand = ops
    s = _IterState(*cur[:12])
    Ax, flag = cur[12], cur[13]
    ce = max(1, st.check_every)
    args = (q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x, s.x, s.z, s.zx,
            s.y, s.yx, Ax, ce, st.solve_refine, st.sigma, st.alpha)
    if _kernel_on(st):
        x, z, zx, y, yx, _ = cuda_kernels.fused_sweeps(
            *args, _kernel_prec(prec), operand=operand, stop=flag)
    elif precision.is_low(prec):
        x, z, zx, y, yx, _ = _xla_sweeps(*args, prec, stop=flag)
    else:
        x, z, zx, y, yx, _ = cuda_kernels.fused_sweeps_plain(*args,
                                                             stop=flag)
    Ax = _mv(A, x)
    pri, dua, prinorm, duanorm = _residuals(q, q2, A, aq, x, z, zx, y, yx,
                                            Ax)
    best, stall = s.best, s.stall
    if plateau:
        best, stall = _plateau_update(s, pri, dua, prinorm, duanorm, st)
    device_loop.commit(flag != 0, cur, (x, z, zx, y, yx, pri, dua, prinorm,
                                        duanorm, s.k + ce, best, stall, Ax))
    device_loop.raise_flag(flag, _vote(_IterState(*cur[:12]), st))


def _admm_core(q, q2, A, cl, cu, lb, ub, state: _IterState, LK, rho_a,
               rho_x, st: ADMMSettings, prec=None) -> _IterState:
    """Inner ADMM sweep loop at fixed rho, on the device
    (:mod:`.device_loop`, :func:`_block`).  Returns the final state.  The
    exit rule is the reference's while_loop's: max_iter, eps, the plateau
    stall, voted on the device after every block.  ``prec``: the sweep
    phase's mode (None is "highest"); residuals and the re-anchor stay
    exact whatever it is.  The kernel's lowered operand is made here, once
    a solve, before any capture."""
    prec = precision.canon(prec)
    S, _, n = A.shape
    ce = max(1, st.check_every)
    Kinv, K = LK[0].contiguous(), LK[1].contiguous()
    operand = (cuda_kernels.dense_operand(A, Kinv, _kernel_prec(prec))
               if _kernel_on(st) else None)
    ops = (q, q2, A, cl, cu, lb, ub, Kinv, K, rho_a,
           rho_x.expand(S, n).contiguous(), q.abs().amax(dim=1), operand)
    loop = [*state, _mv(A, state.x), _vote(state, st).to(torch.int32)]
    out = device_loop.run(functools.partial(_block, st=st, prec=prec), ops,
                          loop, BLOCKS_PER_REPLAY, -(-st.max_iter // ce),
                          key=("admm", st, prec),
                          phase=lambda b: plateau_due(b, st))
    return _IterState(*out[:12])


def _fresh(state: _IterState) -> _IterState:
    return state._replace(**dict(zip(("k", "best", "stall"), _counters(
        state.x.dtype, state.x.device))))


def _solve_scaled(q, q2, A, cl, cu, lb, ub, warm, masks, st: ADMMSettings):
    """Adaptive-rho outer loop; everything already Ruiz-scaled.  ``masks``
    classifies the UNSCALED bounds."""
    S, m, n = A.shape
    dt, dev = A.dtype, A.device
    eq = masks.eq
    loose = ~masks.fin_cl & ~masks.fin_cu

    def rho_vec(base):
        r = torch.where(eq, base * st.rho_eq_scale, base)
        return torch.where(loose, st.rho_min, r)

    def rho_x_vec(base):
        # clamped columns (lb == ub) get the same boost as equality rows
        return torch.where(masks.eqx, base * st.rho_eq_scale,
                           base.expand(S, n))

    if warm is None:
        x0 = torch.zeros((S, n), dtype=dt, device=dev)
        z0 = torch.clamp(torch.zeros((S, m), dtype=dt, device=dev), cl, cu)
        y0 = torch.zeros((S, m), dtype=dt, device=dev)
        yx0 = torch.zeros((S, n), dtype=dt, device=dev)
    else:
        x0, z0, y0, yx0 = warm
    state = _initial_state(x0, z0, torch.clamp(x0, lb, ub), y0, yx0)

    base = torch.full((S,), st.rho, dtype=dt, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    mult = torch.ones((S, m), dtype=dt, device=dev)
    multx = torch.ones((S, n), dtype=dt, device=dev)
    rho_a = torch.zeros((S, m), dtype=dt, device=dev)
    rho_x = torch.zeros((S, n), dtype=dt, device=dev)
    LK = (torch.zeros((S, n, n), dtype=dt, device=dev),) * 2
    for _ in range(st.restarts):
        rho_a = rho_vec(base[:, None])
        rho_x = rho_x_vec(base[:, None])
        if st.rho_row_adapt:
            rho_a = torch.clamp(rho_a * mult, max=st.rho_row_max)
            rho_x = torch.clamp(rho_x * multx, max=st.rho_row_max)
        LK = _factor(q2, A, rho_a, rho_x, st.sigma)
        state = _admm_core(q, q2, A, cl, cu, lb, ub, _fresh(state), LK,
                           rho_a, rho_x, st)
        total = total + state.k
        # OSQP rho adaptation on NORMALIZED residuals; converged scenarios
        # keep their rho (their restarts do zero sweeps)
        done = _done_mask(state.pri, state.dua, state.prinorm,
                          state.duanorm, st)
        eps_pri = st.eps_abs + st.eps_rel * torch.clamp(state.prinorm,
                                                        min=1.0)
        pri_rel = state.pri / torch.clamp(state.prinorm, min=1e-10)
        dua_rel = state.dua / torch.clamp(state.duanorm, min=1e-10)
        ratio = torch.sqrt(torch.clamp(pri_rel, min=1e-12)
                           / torch.clamp(dua_rel, min=1e-12))
        new_base = torch.clamp(base * torch.clamp(ratio, 0.1, 10.0),
                               st.rho_min, st.rho_max)
        base = torch.where(done, base, new_base)
        if st.rho_row_adapt:
            # boost the dominant violated rows of genuinely stuck scenarios
            stuck = (state.pri > 100.0 * eps_pri)[:, None]
            gate = torch.maximum(0.3 * state.pri, 10.0 * eps_pri)[:, None]
            Ax = _mv(A, state.x)
            viol = torch.maximum(cl - Ax, Ax - cu)
            mult = torch.where(stuck & (viol > gate),
                               mult * st.rho_row_boost, mult)
            violx = torch.maximum(lb - state.x, state.x - ub)
            multx = torch.where(stuck & (violx > gate),
                                multx * st.rho_row_boost, multx)
    return state, total, rho_a, rho_x, LK


def _solve_linear(M, rhs):
    """Batched ``solve(M, rhs)``; a singular system yields NaN for that
    scenario instead of raising (JAX's behaviour).  On the card it waits
    for any other thread's graph capture to end, which it would break."""
    with device_loop.outside_capture(M.device):
        sol, info = torch.linalg.solve_ex(M, rhs.unsqueeze(-1))
    return torch.where((info == 0)[:, None], sol.squeeze(-1), torch.nan)


def _polish(state: _IterState, q, q2, A, cl, cu, lb, ub, masks,
            st: ADMMSettings) -> _IterState:
    """OSQP-style polish: guess the active set from dual signs + slacks,
    solve the resulting equality-constrained KKT system, and accept per
    scenario only where it improves the worst residual."""
    S, m, n = A.shape
    dt, dev = A.dtype, A.device
    fin_cl, fin_cu = masks.fin_cl, masks.fin_cu
    tol_cl = 1e-6 * (1.0 + torch.where(fin_cl, cl.abs(), 0.0))
    tol_cu = 1e-6 * (1.0 + torch.where(fin_cu, cu.abs(), 0.0))
    ytol = 1e-6 * torch.clamp(state.y.abs().amax(dim=1, keepdim=True),
                              min=1.0)
    act_lo = ((state.y < -ytol) | (state.z < cl + tol_cl)) & fin_cl
    act_up = ((state.y > ytol) | (state.z > cu - tol_cu)) & fin_cu

    fin_lb, fin_ub = masks.fin_lb, masks.fin_ub
    tol_lb = 1e-6 * (1.0 + torch.where(fin_lb, lb.abs(), 0.0))
    tol_ub = 1e-6 * (1.0 + torch.where(fin_ub, ub.abs(), 0.0))
    yxtol = 1e-6 * torch.clamp(state.yx.abs().amax(dim=1, keepdim=True),
                               min=1.0)
    v_lo = ((state.yx < -yxtol) | (state.zx < lb + tol_lb)) & fin_lb
    v_up = ((state.yx > yxtol) | (state.zx > ub - tol_ub)) & fin_ub

    eq = masks.eq
    eye_n = torch.eye(n, dtype=dt, device=dev)[None]
    ftol = 1e-7
    # AL penalty decoupled from polish_delta (see the JAX package)
    delta = max(st.polish_delta, 1e-7)
    AL_ITERS = 4

    def kkt_solve_full(act_lo, act_up, v_lo, v_up):
        """Row-replacement saddle LU at (n+m) — the float32 option."""
        row_act = act_lo | act_up
        row_b = torch.where(act_up, cu, cl)
        var_act = v_lo | v_up
        var_b = torch.where(v_up, ub, lb)
        N = n + m
        eye_m = torch.eye(m, dtype=dt, device=dev)[None]
        pd = max(st.polish_delta, 1e-6 if dt == torch.float32 else 0.0)
        Qblock = torch.diag_embed(q2) + pd * eye_n
        va = var_act[:, :, None]
        ra = row_act[:, :, None]
        M = torch.zeros((S, N, N), dtype=dt, device=dev)
        rhs = torch.zeros((S, N), dtype=dt, device=dev)
        M[:, :n, :n] = torch.where(va, eye_n, Qblock)
        M[:, :n, n:] = torch.where(va, 0.0, A.transpose(1, 2))
        rhs[:, :n] = torch.where(var_act, var_b, -q)
        M[:, n:, :n] = torch.where(ra, A, 0.0)
        M[:, n:, n:] = torch.where(ra, -pd * eye_m, eye_m)
        rhs[:, n:] = torch.where(row_act, row_b, 0.0)
        sol = _solve_linear(M, rhs)
        xp, yp = sol[:, :n], sol[:, n:]
        r_d = q2 * xp + q + _rmv(A, yp)
        yxp = torch.where(var_act, -r_d, 0.0)
        return xp, yp, yxp

    def kkt_solve_reduced(act_lo, act_up, v_lo, v_up):
        row_act = act_lo | act_up
        row_b = torch.where(act_up, cu, cl)
        var_act = v_lo | v_up
        var_b = torch.where(v_up, ub, lb)
        w_row = row_act.to(dt) / delta
        w_var = var_act.to(dt) / delta
        K = torch.matmul(A.transpose(1, 2), w_row[:, :, None] * A)
        K = K + delta * eye_n
        K = K + torch.diag_embed(q2 + w_var)
        Kinv = _explicit_inverse(K)
        ra = row_act.to(dt)
        va = var_act.to(dt)
        nu = torch.zeros_like(row_b)
        mu = torch.zeros_like(var_b)
        xp = torch.zeros_like(q)
        for _ in range(AL_ITERS):
            rhs = (-q + _rmv(A, w_row * row_b - ra * nu)
                   + (w_var * var_b - va * mu))
            xp = _chol_solve((Kinv, K), rhs, refine=1)
            Ax = _mv(A, xp)
            nu = nu + w_row * (Ax - row_b)
            mu = mu + w_var * (xp - var_b)
        yp, yxp = ra * nu, va * mu
        # exact bound-dual recovery at bound-active coordinates
        r_d = q2 * xp + q + _rmv(A, yp) + yxp
        yxp = torch.where(var_act, yxp - r_d, yxp)
        return xp, yp, yxp

    kkt_solve = (kkt_solve_full if dt == torch.float32
                 else kkt_solve_reduced)

    def refine_add_only(xp, yp, yxp, sets):
        """ADD violated rows at the violated side, never drop."""
        act_lo, act_up, v_lo, v_up = sets
        Ax = _mv(A, xp)
        act_lo = act_lo | (Ax < cl - ftol) | eq
        act_up = act_up | (Ax > cu + ftol) | eq
        v_lo = (v_lo | (xp < lb - ftol)) & fin_lb
        v_up = (v_up | (xp > ub + ftol)) & fin_ub
        return act_lo, act_up, v_lo, v_up

    def refine_textbook(xp, yp, yxp, sets):
        """Add-and-drop: also prune actives whose dual sign is wrong."""
        act_lo, act_up, v_lo, v_up = sets
        Ax = _mv(A, xp)
        act_lo = (act_lo & ~(yp > ftol)) | (Ax < cl - ftol) | eq
        act_up = (act_up & ~(yp < -ftol)) | (Ax > cu + ftol) | eq
        v_lo = ((v_lo & ~(yxp > ftol)) | (xp < lb - ftol)) & fin_lb
        v_up = ((v_up & ~(yxp < -ftol)) | (xp > ub + ftol)) & fin_ub
        return act_lo, act_up, v_lo, v_up

    sets0 = (act_lo | eq, act_up | eq, v_lo, v_up)
    first = kkt_solve(*sets0)

    def run_passes(refine):
        sets = sets0
        xp, yp, yxp = first
        for _ in range(st.polish_passes):
            sets = refine(xp, yp, yxp, sets)
            xp, yp, yxp = kkt_solve(*sets)
        Ax = _mv(A, xp)
        zp = torch.clamp(Ax, cl, cu)
        zxp = torch.clamp(xp, lb, ub)
        pri = torch.maximum((Ax - zp).abs().amax(dim=1),
                            (xp - zxp).abs().amax(dim=1))
        Aty = _rmv(A, yp)
        dua = (q2 * xp + q + Aty + yxp).abs().amax(dim=1)
        return xp, zp, zxp, yp, yxp, pri, dua

    # run BOTH refinement disciplines; per scenario keep the better one
    cand = run_passes(refine_add_only)
    cand2 = run_passes(refine_textbook)
    worse2 = (torch.maximum(cand2[5], cand2[6])
              >= torch.maximum(cand[5], cand[6]))
    cand = tuple(
        torch.where(worse2[:, None] if a.ndim == 2 else worse2, a, b)
        for a, b in zip(cand, cand2))
    xp, zp, zxp, yp, yxp, pri, dua = cand

    better = torch.maximum(pri, dua) < torch.maximum(state.pri, state.dua)

    def pick(a, b):
        return torch.where(better[:, None], a, b)

    return state._replace(
        x=pick(xp, state.x), z=pick(zp, state.z), zx=pick(zxp, state.zx),
        y=pick(yp, state.y), yx=pick(yxp, state.yx),
        pri=torch.where(better, pri, state.pri),
        dua=torch.where(better, dua, state.dua),
    )


def _tensor(v, dtype, device):
    """``torch.as_tensor`` that copies read-only numpy arrays (views of
    other frameworks' buffers) instead of aliasing them."""
    if isinstance(v, np.ndarray) and not v.flags.writeable:
        v = np.array(v)
    return torch.as_tensor(v, dtype=dtype, device=device)


def _prep(c, q2, A, cl, cu, lb, ub, settings, device, want_masks=True):
    """Device placement, dtype casting, bound cleaning, finiteness masks."""
    dev = resolve_device(device, A, c, q2, cl, cu, lb, ub)
    dt = settings.tdtype()

    def t(v):
        return _tensor(v, dt, dev)

    c, q2, A = t(c), t(q2), t(A)
    cl, cu = _clean_bounds(t(cl), t(cu))
    lb, ub = _clean_bounds(t(lb), t(ub))
    masks = None
    if want_masks:
        masks = _BoundMasks(
            fin_cl=cl > -BIG / 2, fin_cu=cu < BIG / 2,
            fin_lb=lb > -BIG / 2, fin_ub=ub < BIG / 2,
            eq=(cu - cl).abs() < 1e-10,
            eqx=(ub - lb).abs() < 1e-10,
        )
    return c, q2, A, cl, cu, lb, ub, masks


def _scale(c, q2, A, cl, cu, lb, ub, D, E, cost, warm):
    As = A * E[:, :, None] * D[:, None, :]
    q2s = q2 * D * D * cost[:, None]
    qs = c * D * cost[:, None]
    cls, cus = cl * E, cu * E
    lbs, ubs = lb / D, ub / D
    if warm is not None:
        x0, z0, y0, yx0 = (_tensor(v, A.dtype, A.device) for v in warm)
        warm = (x0 / D, z0 * E, y0 / E * cost[:, None],
                yx0 * D * cost[:, None])
    return qs, q2s, As, cls, cus, lbs, ubs, warm


def _unscale(s, D, E, cost):
    return (s.x * D, s.z / E, s.y * E / cost[:, None],
            s.yx / D / cost[:, None])


def _solution(state, raw, D, E, cost, total, settings) -> BatchSolution:
    """``total``: the sweeps run, a 0-dim device tensor (never read)."""
    x, z, y, yx = _unscale(state, D, E, cost)
    S = x.shape[0]
    return BatchSolution(
        x=x, z=z, y=y, yx=yx, pri_res=state.pri, dua_res=state.dua,
        iters=total.to(torch.int64).expand(S).clone(),
        done=_done_mask(state.pri, state.dua, state.prinorm, state.duanorm,
                        settings),
        raw=raw)


def _solve_impl(c, q2, A, cl, cu, lb, ub, settings, warm, device,
                want_factors=False):
    c, q2, A, cl, cu, lb, ub, masks = _prep(c, q2, A, cl, cu, lb, ub,
                                            settings, device)
    D, E = _ruiz(A, q2, settings.scaling_iters)
    cost = 1.0 / torch.clamp((c * D).abs().amax(dim=1), min=1e-8)
    qs, q2s, As, cls, cus, lbs, ubs, warm = _scale(
        c, q2, A, cl, cu, lb, ub, D, E, cost, warm)
    state, total, rho_a, rho_x, LK = _solve_scaled(
        qs, q2s, As, cls, cus, lbs, ubs, warm, masks, settings)
    raw = _unscale(state, D, E, cost)
    if settings.polish:
        state = _polish(state, qs, q2s, As, cls, cus, lbs, ubs, masks,
                        settings)
    sol = _solution(state, raw, D, E, cost, total, settings)
    if want_factors:
        return sol, Factors(D=D, E=E, cost=cost, rho_a=rho_a, rho_x=rho_x,
                            Kinv=LK[0], K=LK[1])
    return sol


def solve_batch(c, q2, A, cl, cu, lb, ub,
                settings: ADMMSettings = ADMMSettings(), warm=None,
                device=None) -> BatchSolution:
    """Solve a batch of box-QP/LPs; all arrays (S, ...) as in ScenarioBatch
    (numpy or tensors).  ``warm``: optional (x, z, y, yx) from a previous
    call — PH's persistent-solver analogue."""
    return _solve_impl(c, q2, A, cl, cu, lb, ub, settings, warm, device)


def solve_batch_factored(c, q2, A, cl, cu, lb, ub,
                         settings: ADMMSettings = ADMMSettings(), warm=None,
                         device=None):
    """Adaptive solve that also returns the reusable :class:`Factors` for
    subsequent :func:`solve_batch_frozen` calls."""
    return _solve_impl(c, q2, A, cl, cu, lb, ub, settings, warm, device,
                       want_factors=True)


def _frozen_sweep_phases(run_core, state0, settings: ADMMSettings):
    """The frozen sweep of both engines (their ``_IterState``s both carry
    k, best and stall, which is all this touches); ``run_core(state, st,
    prec)`` runs one engine core.

    Full precision: one core run.  Lowered (``settings.sweep_precision``):
    a bf16 or bf16x3 sweep phase (its residuals exact, so its eps vote is
    real), then a full-precision refinement phase of at most
    ``precision_refine_iters`` sweeps on the same factors, which sweeps
    nothing when phase 1 converged (its loop's first vote stops it).  The
    residuals and ``done`` always come from exact measurements; the sweep
    count adds up across the phases.  The refinement phase's settings are
    equal from call to call (a frozen dataclass compares by value), so its
    captured graphs are reused."""
    if not precision.is_low(settings.sweep_precision):
        return run_core(state0, settings, None)
    state = run_core(state0, settings,
                     precision.canon(settings.sweep_precision))
    if settings.precision_refine_iters > 0:
        k1 = state.k
        st_r = dataclasses.replace(
            settings, max_iter=int(settings.precision_refine_iters))
        state = run_core(_fresh(state), st_r, "highest")
        _tally(state.k)
        state = state._replace(k=state.k + k1)
    return state


#: Sweeps the refinement phases ran, per device, summed on the device (no
#: host read on the solve path); :func:`refinement_sweeps` reads them.
_refine_tally: dict = {}


def _tally(k):
    t = _refine_tally.get(k.device)
    if t is None:
        t = _refine_tally[k.device] = torch.zeros((), dtype=torch.int64,
                                                  device=k.device)
    t.add_(k)


def refinement_sweeps(reset=False) -> int:
    """Sweeps run by the mixed-precision refinement phases so far, over
    every device (one host read each); ``reset`` zeroes the tally."""
    total = 0
    for t in _refine_tally.values():
        total += int(hostsync.fetch(t))
        if reset:
            t.zero_()
    return total


def solve_batch_frozen(c, q2, A, cl, cu, lb, ub, factors: Factors,
                       settings: ADMMSettings = ADMMSettings(), warm=None,
                       polish=False, device=None) -> BatchSolution:
    """Sweep-only solve reusing a refresh solve's :class:`Factors`: no Ruiz
    recomputation, factorization or rho adaptation.  Valid while
    (A, q2, bounds) are unchanged since the refresh; the residual-based loop
    still enforces accuracy.  ``polish=True`` also polishes the final
    iterate (honoring ``settings.polish``).  ``settings.sweep_precision``
    runs the mixed-precision sweep (:func:`_frozen_sweep_phases`)."""
    device = resolve_device(device, factors.Kinv, A, c)
    want_masks = polish and settings.polish
    c, q2, A, cl, cu, lb, ub, masks = _prep(
        c, q2, A, cl, cu, lb, ub, settings, device, want_masks=want_masks)
    D, E, cost = factors.D, factors.E, factors.cost
    qs, q2s, As, cls, cus, lbs, ubs, warm = _scale(
        c, q2, A, cl, cu, lb, ub, D, E, cost, warm)
    S, m, n = A.shape
    dt, dev = A.dtype, A.device
    if warm is None:
        x0 = torch.zeros((S, n), dtype=dt, device=dev)
        z0 = torch.clamp(torch.zeros((S, m), dtype=dt, device=dev), cls, cus)
        y0 = torch.zeros((S, m), dtype=dt, device=dev)
        yx0 = torch.zeros((S, n), dtype=dt, device=dev)
    else:
        x0, z0, y0, yx0 = warm
    state0 = _initial_state(x0, z0, torch.clamp(x0, lbs, ubs), y0, yx0)

    def run_core(st0, st, prec):
        return _admm_core(qs, q2s, As, cls, cus, lbs, ubs, st0,
                          (factors.Kinv, factors.K), factors.rho_a,
                          factors.rho_x, st, prec)

    state = _frozen_sweep_phases(run_core, state0, settings)
    raw = _unscale(state, D, E, cost)
    if want_masks:
        state = _polish(state, qs, q2s, As, cls, cus, lbs, ubs, masks,
                        settings)
    return _solution(state, raw, D, E, cost, state.k, settings)


def stop_stats(sol: BatchSolution):
    """[max iters, max pri_res, max dua_res, all_done] as ONE tensor."""
    dt = sol.pri_res.dtype
    return torch.stack([sol.iters.max().to(dt), sol.pri_res.max(),
                        sol.dua_res.max(), sol.done.all().to(dt)])


def precision_guard_trips(sol: BatchSolution, settings: ADMMSettings,
                          ref_worst=None, stats=None) -> bool:
    """Host guard of the mixed-precision frozen path: True when a lowered
    frozen solve must re-run at full precision.  It is not eps-converged
    AND its worst residual exceeds ``precision_guard`` x the reference
    floor, the worst residual of the last full-precision refresh of the
    same family (``ref_worst``), floored at eps; a non-finite residual
    always trips, a converged solve never.  Plateau families, whose
    full-precision floor is far above eps, never trip on residuals full
    precision could not beat either.

    ``stats``: an already fetched ``(worst residual, all_done)`` pair, so
    the guard costs no fetch; without it the guard makes one
    :func:`stop_stats` fetch."""
    if not settings.sweep_precision or settings.sweep_precision == "highest":
        return False
    if settings.precision_guard <= 0:
        return False
    if stats is not None:
        worst, all_done = float(stats[0]), bool(stats[1])
    else:
        st4 = hostsync.fetch(stop_stats(sol))
        worst, all_done = float(max(st4[1], st4[2])), bool(st4[3])
    if all_done:
        return False
    if not np.isfinite(worst):
        return True
    floor = max(settings.eps_abs, settings.eps_rel)
    bar = settings.precision_guard * max(float(ref_worst or 0.0), floor)
    return worst > bar


def measure_pack(sol: BatchSolution):
    """Everything the host PH iteration reads from one solve as ONE flat
    tensor: ``[pri_res (S) | dua_res (S) | iters_max | all_done | x (S*n)]``
    (:func:`measure_unpack` splits it on the host)."""
    dt = sol.pri_res.dtype
    return torch.cat([
        sol.pri_res.to(dt), sol.dua_res.to(dt),
        sol.iters.max().to(dt)[None], sol.done.all().to(dt)[None],
        sol.x.to(dt).reshape(-1)])


def measure_unpack(vec, S, n):
    """Split a fetched :func:`measure_pack` vector into ``pri`` (S,),
    ``dua`` (S,), ``iters`` (int), ``all_done`` (bool) and ``x`` (S, n)."""
    vec = np.asarray(vec)
    return {
        "pri": vec[:S],
        "dua": vec[S:2 * S],
        "iters": int(vec[2 * S]),
        "all_done": bool(vec[2 * S + 1]),
        "x": vec[2 * S + 2:].reshape(S, n),
    }


def dual_cut(c, q2, A, cl, cu, lb, ub, y, x_hint, clamp_mask,
             margin_scale=100.0):
    """Benders-cut data valid for ANY duals ``y`` (weak duality):
    ``Q(x') >= base + g[clamp] . x'`` with ``g = c + A'y``.  Returns
    ``(base (S,), g (S, n))``.  Tensors on one device."""
    cl, cu = _clean_bounds(cl, cu)
    lb, ub = _clean_bounds(lb, ub)
    fin_cl, fin_cu = cl > -BIG / 2, cu < BIG / 2
    fin_lb, fin_ub = lb > -BIG / 2, ub < BIG / 2
    y = torch.where(~fin_cu & (y > 0), 0.0, y)
    y = torch.where(~fin_cl & (y < 0), 0.0, y)
    yp = torch.clamp(y, min=0.0)
    ym = torch.clamp(y, max=0.0)
    row_term = (-yp * torch.where(fin_cu, cu, 0.0)
                - ym * torch.where(fin_cl, cl, 0.0)).sum(dim=1)
    X = margin_scale * (1.0 + x_hint.abs().amax(dim=1, keepdim=True))
    L = torch.where(fin_lb, lb, -X)
    U = torch.where(fin_ub, ub, X)
    g = c + _rmv(A, y)
    quad = q2 > 1e-14
    xq = torch.clamp(torch.where(quad, -g / torch.where(quad, q2, 1.0), 0.0),
                     L, U)
    val_quad = 0.5 * q2 * xq * xq + g * xq
    val_lin = g * torch.where(g >= 0, L, U)
    term = torch.where(quad, val_quad, val_lin)
    base = row_term + torch.where(clamp_mask[None, :], 0.0, term).sum(dim=1)
    return base, g


def dual_objective(c, q2, A, cl, cu, lb, ub, y, x_hint, margin_scale=100.0):
    """(S,) LOWER bounds on each scenario optimum from row duals ``y``
    (weak duality; free coordinates capped at
    ``X = margin_scale * (1 + max|x_hint|)``).  :func:`dual_cut` with
    nothing clamped."""
    mask = torch.zeros(c.shape[1], dtype=torch.bool, device=c.device)
    base, _ = dual_cut(c, q2, A, cl, cu, lb, ub, y, x_hint, mask,
                       margin_scale)
    return base


def dual_objective_margin(c, q2, A, cl, cu, lb, ub, y, x_hint,
                          margin_scale=100.0, widen=10.0):
    """(S,) margins extending :func:`dual_objective`'s X-cap certificate
    from X to ``widen * X`` (~0 for tight duals)."""
    cl, cu = _clean_bounds(cl, cu)
    lb, ub = _clean_bounds(lb, ub)
    fin_lb, fin_ub = lb > -BIG / 2, ub < BIG / 2
    y = torch.where(~(cu < BIG / 2) & (y > 0), 0.0, y)
    y = torch.where(~(cl > -BIG / 2) & (y < 0), 0.0, y)
    g = c + _rmv(A, y)
    X = margin_scale * (1.0 + x_hint.abs().amax(dim=1, keepdim=True))
    need_hi = ~fin_ub & (g < 0)
    need_lo = ~fin_lb & (g > 0)
    engaged = (q2 <= 1e-14) | (g.abs() > q2 * X)
    per = torch.where((need_hi | need_lo) & engaged,
                      g.abs() * (widen - 1.0) * X, 0.0)
    return per.sum(dim=1)


def dual_objective_with_margin(c, q2, A, cl, cu, lb, ub, y, x_hint,
                               margin_scale=100.0):
    """(2, S): :func:`dual_objective` stacked with
    :func:`dual_objective_margin`, so callers fetch both at once.  It runs
    on the tensors' device and reads nothing back, so it is also the
    reference's ``dual_objective_with_margin_traced``: the in-wheel bound
    pass (``parallel.sharded._bound_pass_terms``) assembles its outer bound
    with it inside the window."""
    return torch.stack([
        dual_objective(c, q2, A, cl, cu, lb, ub, y, x_hint, margin_scale),
        dual_objective_margin(c, q2, A, cl, cu, lb, ub, y, x_hint,
                              margin_scale)])


class SingleSolution(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    pri_res: torch.Tensor
    dua_res: torch.Tensor


def solve_single(c, q2, A, cl, cu, lb, ub,
                 settings: ADMMSettings = ADMMSettings(), **kw):
    """One problem as a batch of 1 (EF solves)."""
    lift = (lambda v: v[None])
    sol = solve_batch(*(lift(v) for v in (c, q2, A, cl, cu, lb, ub)),
                      settings=settings, **kw)
    return SingleSolution(sol.x[0], sol.y[0], sol.pri_res[0], sol.dua_res[0])
