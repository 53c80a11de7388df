"""Shared-constraint-matrix ADMM: one A and one factorization for the batch.

Port of ``tpusppy/solvers/shared_admm.py``.  Families whose scenarios differ
only in costs, rhs and bounds (stochastic unit commitment above all: wind
enters the balance and reserve rhs) share ONE constraint matrix.  The batch
then stores A once, the Ruiz scaling and row penalties are shared, and there
is ONE factorization of the x-update system for the whole batch.
Per-scenario diagonal deviations (PH prox terms that differ across
scenarios, ``dq2``) are absorbed by iterative refinement against the exact
per-scenario system, and a per-scenario penalty scale ``gamma`` adapts
inside the sweep loop without refactoring.

Three factorization regimes, by the type of A (:func:`_factor_shared`):

- a dense (m, n) tensor: dense K and its explicit inverse; every
  ``check_every`` block of sweeps runs in the hand-written CUDA kernel
  ``fused_sweeps_shared`` (:mod:`.cuda_kernels`);
- a :class:`~.sparse.SparseA` with block/Woodbury structure: the structured
  factorization (:mod:`.structured_kkt`), K None;
- a SparseA without structure: a dense explicit inverse, K None.

Without K (the sparse regimes, or factors from ``factors_keep_K=False``)
the refinement applies K matrix-free through A, and every sweep block runs
in ``fused_sweeps_sparse`` on the ELL form of A (a dense A's ELL form is A
itself).  That kernel takes a dense (n, n) K^-1, or, in the structured
regime, the block/Woodbury operator in its kernel layout
(:class:`~.structured_kkt.KernelWoodbury`, made once per factorization
and kept in ``SharedFactors.Kinv_op``); no dense (n, n) matrix is made
there.

No active-set polish on this path: outer bounds stay certified through weak
duality (:func:`tpusppy_torch.solvers.admm.dual_objective` takes the shared
A, dense or sparse) and LP-exact residue is left to the host straggler
rescue (``spopt.SPOpt._rescue_stragglers``).

Differences from the JAX package: the sweep ``while_loop`` runs in
:mod:`.device_loop` (on CUDA as CUDA-graph replays of
:data:`BLOCKS_PER_REPLAY` blocks with a dense A and
:data:`SPARSE_BLOCKS_PER_REPLAY` in ``fused_sweeps_sparse``, the host
reading one stop flag a replay, counted as ``admm.loop_checks``), as in
:func:`tpusppy_torch.solvers.admm._admm_core`; the restart ``scan`` is a
Python loop that reads nothing from the device; the sparse engines' sweep
blocks always run in the fused kernel, which applies the Woodbury operator
as the reference's XLA path does (the reference's Pallas kernel takes its
densified matrix).

The mixed-precision frozen sweep (``ADMMSettings.sweep_precision``,
doc/precision.md): :func:`solve_shared_frozen` runs
:func:`.admm._frozen_sweep_phases`.  A lowered phase hands its mode to both
kernels (``kernel_prec``: "default" or "high", bf16x3 in the kernels too):
the dense A's A', A and K^-1 products lowered, the K defect exact; on a
SparseA only the K^-1 applies.  With the kernel off the tensor path is the
reference's XLA block (:func:`_xla_sweeps`: ``mv_lo``/``rmv_lo`` at the
mode on a dense A and exact on a SparseA, :func:`_solve_shared_K` with an
exact ``Kmul``).  Residuals, the re-anchor and the vote stay exact.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .. import resolve_device
from . import cuda_kernels, device_loop, precision
from .admm import (ADMMSettings, BatchSolution, BIG, _clean_bounds,
                   _counters, _done_mask, _explicit_inverse,
                   _frozen_sweep_phases, _kernel_on, _plateau_update,
                   _residuals, _tensor, _vote, plateau_due)
from .cuda_kernels import matvec as _mv
from .cuda_kernels import rmatvec as _rmv
from .sparse import SparseA, dense_ell, ell_slot_major
from .structured_kkt import (KernelWoodbury, apply_kinv_like,
                             factor_structured, lowered_layout,
                             woodbury_layout)

#: Sweep blocks a CUDA-graph replay of the loop runs with a dense shared A
#: (``fused_sweeps_shared``): 8 divides the gamma cadence (32 blocks at the
#: default ``check_every``) and the plateau window (8 blocks at the
#: default ``sweep_plateau_window``), so a run needs two graphs, one with
#: the gamma rule in its last block and one without (PERF.md).
BLOCKS_PER_REPLAY = 8
#: The same with ``fused_sweeps_sparse``: one, since a block there takes
#: milliseconds (PERF.md), so a gated block past the exit costs more than
#: the flag reads a longer replay saves, and the replay queued ahead keeps
#: the card busy while the host reads the flag.
SPARSE_BLOCKS_PER_REPLAY = 1


class SharedFactors(NamedTuple):
    """Reusable solve state for the frozen path (the shared-A analogue of
    :class:`tpusppy_torch.solvers.admm.Factors`)."""

    D: torch.Tensor       # (n,) Ruiz column scaling (shared)
    E: torch.Tensor       # (m,) Ruiz row scaling (shared)
    cost: torch.Tensor    # scalar objective scaling (shared)
    rho_a: torch.Tensor   # (m,) row penalties actually used last
    rho_x: torch.Tensor   # (n,) variable-box penalties actually used last
    gamma: torch.Tensor   # (S,) per-scenario penalty scales used last
    Kinv: object          # (n, n) explicit inverse of the shared system,
                          # or a structured_kkt.BlockWoodbury operator
    K: object             # (n, n) exact shared K for dense refinement, or
                          # None: refinement then runs matrix-free through A
    q2ref: torch.Tensor   # (n,) scaled q2 the K was built with
    Kinv_op: object       # the K^-1 the sweep kernels apply: Kinv itself,
                          # or the structured_kkt.KernelWoodbury of it


class _Masks(NamedTuple):
    eq: torch.Tensor      # (m,) equality row in EVERY scenario
    loose: torch.Tensor   # (m,) two-sided-infinite row in every scenario
    eqx: torch.Tensor     # (n,) zero-width variable box in every scenario


class _IterState(NamedTuple):
    x: torch.Tensor
    z: torch.Tensor
    zx: torch.Tensor
    y: torch.Tensor
    yx: torch.Tensor
    gamma: torch.Tensor   # (S,) per-scenario penalty scale, adapts in-loop
    pri: torch.Tensor
    dua: torch.Tensor
    prinorm: torch.Tensor
    duanorm: torch.Tensor
    k: torch.Tensor       # () int64: sweeps run at this rho profile
    best: torch.Tensor    # () plateau: best batch eps-normalized residual
    stall: torch.Tensor   # () int64: consecutive non-improving windows


def _ruiz_shared(A, q2ref, iters):
    """Ruiz equilibration of the single shared A (dense or sparse); returns
    (D (n,), E (m,))."""
    m, n = A.shape
    D = torch.ones((n,), dtype=A.dtype, device=A.device)
    E = torch.ones((m,), dtype=A.dtype, device=A.device)
    sparse = isinstance(A, SparseA)
    for _ in range(iters):
        Ps = q2ref * D * D
        if sparse:
            As = A.scale(E, D)
            col = torch.maximum(As.col_absmax(), Ps.abs())
            row = As.row_absmax()
        else:
            As = A * E[:, None] * D[None, :]
            col = torch.maximum(As.abs().amax(dim=0), Ps.abs())
            row = As.abs().amax(dim=1)
        col = torch.where(col < 1e-12, 1.0, col)
        row = torch.where(row < 1e-12, 1.0, row)
        D, E = D / torch.sqrt(col), E / torch.sqrt(row)
    return D, E


def _factor_shared(q2ref, A, rho_a, rho_x, sigma):
    """``(Kinv, K, Kinv_op)`` of the SHARED K = diag(q2ref + rho_x) +
    sigma I + A'RA: one system for the whole scenario batch, in one of
    three regimes by the type of A (``Kinv_op`` is what the sweep kernels
    apply):

    - dense (m, n) tensor: dense K and its explicit inverse;
    - :class:`SparseA` with block/Woodbury structure: the structured
      factorization (no dense K; refinement runs matrix-free through A),
      with its kernel layout;
    - SparseA without structure: K assembled through a transient dense
      scatter, its explicit inverse kept and K dropped."""
    n = A.shape[1]
    sparse = isinstance(A, SparseA)
    if sparse and A.structure is not None:
        bw = factor_structured(A, A.structure, q2ref + rho_x, rho_a, sigma)
        return bw, None, woodbury_layout(bw, A)
    Ad = A.todense() if sparse else A
    K = Ad.T @ (rho_a[:, None] * Ad)
    K = K + torch.eye(n, dtype=Ad.dtype, device=Ad.device) * sigma
    K = K + torch.diag(q2ref + rho_x)
    Kinv = _explicit_inverse(K[None])[0]
    return Kinv, None if sparse else K, Kinv


def _solve_shared_K(Kinv, Kmul, dq2, gamma, b, refine, extra_if_dq2=2,
                    prec=None):
    """x with (gamma_s K + diag(dq2_s)) x_s = b_s per scenario, through the
    shared inverse and refinement against the exact per-scenario system;
    ``Kmul`` applies the exact K (a dense product, or matrix-free through
    A).  ``gamma`` (S, 1) scales the whole penalty profile per scenario.
    The ``extra_if_dq2`` passes run where any dq2 is non-zero, selected on
    the device (the reference's ``lax.cond``).  ``prec``: the K^-1
    applies' mode (:func:`.structured_kkt.apply_kinv_like`); ``Kmul``, the
    defect, stays exact.  The tensor path's x-update at a lowered mode."""
    def steps(x, k):
        for _ in range(k):
            r = b - (gamma * Kmul(x) + dq2 * x)
            x = x + apply_kinv_like(Kinv, r / gamma, prec)
        return x

    x = steps(apply_kinv_like(Kinv, b / gamma, prec), refine)
    if extra_if_dq2 > 0:
        x = torch.where((dq2 != 0).any(), steps(x, extra_if_dq2), x)
    return x


def _xla_sweeps(q, A, Kinv, K, diagK, cl, cu, lb, ub, rho_a, rho_x, dq2, g,
                x, z, zx, y, yx, Ax, n_sweeps, n_refine, n_extra, sigma,
                alpha, prec, stop=None):
    """The reference's XLA block (``shared_admm._core``'s ``block``) at a
    lowered ``prec``: the tensor path's (``use_kernel=False``).  On a
    dense A the A' and A products run at ``prec`` (``mv_lo``/``rmv_lo``,
    :func:`.precision.contract`); on a :class:`SparseA` they stay exact.
    The K^-1 applies (a dense inverse or the block/Woodbury operator) run
    at ``prec`` through :func:`_solve_shared_K`, whose defect ``Kmul`` is
    exact: a dense product with K, or without K the matrix-free ``diagK x
    + A'(rho_a A x)`` (``diagK`` (1, n) = q2ref + rho_x + sigma).  ``rho_a``
    (1, m) and ``rho_x`` (1, n) unscaled, ``g`` (S, 1).  Returns the inputs
    where ``stop`` is set."""
    sparse = isinstance(A, SparseA)
    cuda_kernels.bump("plain_calls", "fused_sweeps_sparse"
                      if sparse or K is None else "fused_sweeps_shared")
    state_in = (x, z, zx, y, yx, Ax)
    if isinstance(Kinv, KernelWoodbury):
        Kinv = Kinv.bw
    if sparse:
        mv_lo, rmv_lo = (lambda v: A.matvec(v)), (lambda v: A.rmatvec(v))
    else:
        mv_lo = (lambda v: precision.contract("sn,mn->sm", v, A, prec))
        rmv_lo = (lambda v: precision.contract("sm,mn->sn", v, A, prec))
    if K is not None:
        Kmul = (lambda v: v @ K)
    else:
        Kmul = (lambda v: v * diagK + _rmv(A, _mv(A, v) * rho_a))
    sigma, alpha, beta = float(sigma), float(alpha), 1.0 - float(alpha)
    sigma_s, rho_a_s, rho_x_s = g * sigma, g * rho_a, g * rho_x
    for _ in range(n_sweeps):
        rhs = (sigma_s * x - q + rmv_lo(rho_a_s * z - y)
               + (rho_x_s * zx - yx))
        xt = _solve_shared_K(Kinv, Kmul, dq2, g, rhs, n_refine, n_extra,
                             prec)
        Axt = mv_lo(xt)
        x_new = alpha * xt + beta * x
        Ax_new = alpha * Axt + beta * Ax
        za_arg = alpha * Axt + beta * z + y / rho_a_s
        z_new = torch.clamp(za_arg, cl, cu)
        y_new = y + rho_a_s * (alpha * Axt + beta * z - z_new)
        zx_arg = alpha * xt + beta * zx + yx / rho_x_s
        zx_new = torch.clamp(zx_arg, lb, ub)
        yx_new = yx + rho_x_s * (alpha * xt + beta * zx - zx_new)
        x, z, zx, y, yx, Ax = x_new, z_new, zx_new, y_new, yx_new, Ax_new
    return cuda_kernels._gate(stop, state_in, (x, z, zx, y, yx, Ax))


def _finite_rows(t):
    return torch.isfinite(t).all(dim=1)


def gamma_due(b, st: ADMMSettings) -> bool:
    """Whether block ``b`` of a sweep loop (from 0) falls on the gamma
    cadence, every ~128 sweeps: the reference's ``((k + ck) // ck) %
    period == 0`` at the block's sweep count ``k = b * ck``, known on the
    host."""
    ce = max(1, st.check_every)
    return (b + 1) % max(1, 128 // ce) == 0


def _block(ops, cur, phase, st: ADMMSettings, sparse, mode,
           prec="highest"):
    """One sweep block of the shared-A loop, in place on ``cur`` (the
    :class:`_IterState` fields, the carried Ax, the stop flag): the
    ``check_every`` sweeps gated by the flag (``fused_sweeps_shared`` in
    ``mode`` on the operand made for it, or with ``sparse``
    ``fused_sweeps_sparse`` and its matrix-free defect on A's ELL form,
    each at ``prec``; with the kernel off at a lowered ``prec``, the
    reference's XLA block, :func:`_xla_sweeps`),
    one true matvec that re-anchors Ax, the residuals, the divergence
    guard, the gamma rule and the plateau update where ``phase`` (``(gamma
    due, plateau due)``, :func:`gamma_due`, :func:`.admm.plateau_due`)
    says they fall, the commit (nothing where the flag was set), then the
    exit vote."""
    q, q2s, q2ref, A, cl, cu, lb, ub, Kinv, KD, rho_a1, rho_x1, glo, ghi, \
        aq, operand = ops
    g_due, p_due = phase
    s = _IterState(*cur[:13])
    Ax_prev, flag = cur[13], cur[14]
    ce = max(1, st.check_every)
    g = s.gamma[:, None].contiguous()
    dq2 = q2s - g * q2ref[None, :]
    # batch-global flag for the extra refinement passes, on the device
    has = (dq2 != 0).any().to(q.dtype).reshape(1, 1)
    fixed = (ce, st.solve_refine, 2, st.sigma, st.alpha)
    if not _kernel_on(st) and precision.is_low(prec):
        x, z, zx, y, yx, _ = _xla_sweeps(
            q, A, Kinv, None if sparse else KD, KD if sparse else None, cl,
            cu, lb, ub, rho_a1, rho_x1, dq2, g, s.x, s.z, s.zx, s.y, s.yx,
            Ax_prev, *fixed, prec, stop=flag)
    elif sparse:
        # KD is the exact K's diagonal part; A'RA goes through the ELL form
        ell = A.ell if isinstance(A, SparseA) else dense_ell(A)
        if not _kernel_on(st):
            sweep = cuda_kernels.fused_sweeps_sparse_plain
        elif q.device.type != "cuda":
            sweep = cuda_kernels.fused_sweeps_sparse
        else:
            # the kernel reads the ELL arrays slot-major
            sweep = functools.partial(
                cuda_kernels.fused_sweeps_sparse,
                ell_t=(A.ell_t() if isinstance(A, SparseA)
                       else ell_slot_major(ell)), operand=operand)
        x, z, zx, y, yx, _ = sweep(
            q, *ell, Kinv, KD, cl, cu, lb, ub, rho_a1, rho_x1, dq2, has, g,
            s.x, s.z, s.zx, s.y, s.yx, Ax_prev, *fixed, prec, stop=flag)
    else:
        sweep = (functools.partial(cuda_kernels.fused_sweeps_shared,
                                   mode=mode, operand=operand)
                 if _kernel_on(st) else cuda_kernels.fused_sweeps_shared_plain)
        x, z, zx, y, yx, _ = sweep(
            q, A, Kinv, KD, cl, cu, lb, ub, rho_a1, rho_x1, dq2, has, g,
            s.x, s.z, s.zx, s.y, s.yx, Ax_prev, *fixed, prec, stop=flag)
    # re-anchor the incrementally carried Ax (see admm._block)
    Ax = _mv(A, x)
    pri, dua, prinorm, duanorm = _residuals(q, q2s, A, aq, x, z, zx, y, yx,
                                            Ax)
    # Per-scenario divergence guard: a scenario whose iterates left the
    # finite range (e.g. a dq2 too large for the shared-K refinement to
    # contract) is frozen at its last finite iterate and reports INF
    # residuals, so done stays False and nothing downstream sees NaN.
    # Ax_prev is exactly A @ s.x from the previous re-anchor.
    finite = (_finite_rows(x) & _finite_rows(z) & _finite_rows(zx)
              & _finite_rows(y) & _finite_rows(yx))
    bad = ~finite | ~(pri <= BIG) | ~(dua <= BIG)
    bv = bad[:, None]
    x = torch.where(bv, s.x, x)
    z = torch.where(bv, s.z, z)
    zx = torch.where(bv, s.zx, zx)
    y = torch.where(bv, s.y, y)
    yx = torch.where(bv, s.yx, yx)
    Ax = torch.where(bv, Ax_prev, Ax)
    pri = torch.where(bad, torch.inf, pri)
    dua = torch.where(bad, torch.inf, dua)
    prinorm = torch.where(bad, s.prinorm, prinorm)
    duanorm = torch.where(bad, s.duanorm, duanorm)
    gamma, best, stall = s.gamma, s.best, s.stall
    if p_due:
        best, stall = _plateau_update(s, pri, dua, prinorm, duanorm, st)
    if g_due:
        # OSQP-style per-scenario gamma adaptation on normalized residual
        # ratios, every ~128 sweeps (the reference's cadence: adapting at
        # every checkpoint thrashes)
        done = _done_mask(pri, dua, prinorm, duanorm, st)
        pri_rel = pri / torch.clamp(prinorm, min=1e-10)
        dua_rel = dua / torch.clamp(duanorm, min=1e-10)
        ratio = torch.sqrt(torch.clamp(pri_rel, min=1e-12)
                           / torch.clamp(dua_rel, min=1e-12))
        move = (ratio > 5.0) | (ratio < 0.2)
        gnew = torch.minimum(torch.maximum(
            s.gamma * torch.clamp(ratio, 0.1, 10.0), glo), ghi)
        gamma = torch.where(done | ~move, s.gamma, gnew)
        if st.sweep_plateau_rtol > 0:
            # an actual gamma move changes the iteration: fresh plateau
            # grace
            moved = (move & ~done & (gnew != s.gamma)).any()
            best = torch.where(moved, torch.inf, best)
            stall = torch.where(moved, 0, stall)
    device_loop.commit(flag != 0, cur, (
        x, z, zx, y, yx, gamma, pri, dua, prinorm, duanorm, s.k + ce, best,
        stall, Ax))
    device_loop.raise_flag(flag, _vote(_IterState(*cur[:13]), st))


def _core(q, q2s, q2ref, A, cl, cu, lb, ub, state: _IterState, Kinv, K,
          rho_a, rho_x, glo, ghi, st: ADMMSettings,
          adaptive=False, prec=None) -> _IterState:
    """Inner sweep loop at a fixed shared rho profile, with IN-LOOP
    per-scenario gamma adaptation, on the device (:mod:`.device_loop`,
    :func:`_block`).

    Scaling the whole penalty profile (rho_a, rho_x, sigma) by gamma_s keeps
    the x-update system an exact multiple of the shared K, so adapting gamma
    needs no refactorization.  ``glo``/``ghi`` bound gamma: wide for LP
    batches (dq2 = 0, exact at any gamma), near 1 for QP (keeps the dq2
    refinement contractive).  ``Kinv`` is the operand the kernels apply:
    a dense (n, n) K^-1, or a KernelWoodbury (with a SparseA and no K).
    Blocks run in ``fused_sweeps_shared`` when A is dense and K is given,
    else in ``fused_sweeps_sparse``.  The exit rule is the reference's
    while_loop's, voted on the device after every block.  ``prec``: the
    sweep phase's mode (None is "highest"); the kernels' lowered operands
    are made here, once per set of matrices, before any capture."""
    prec = precision.canon(prec)
    ce = max(1, st.check_every)
    if isinstance(Kinv, torch.Tensor):
        Kinv = Kinv.contiguous()
    sparse = isinstance(A, SparseA) or K is None
    # with the sparse kernel, the exact K's diagonal part in K's place
    KD = (q2ref + rho_x + st.sigma)[None, :].contiguous() if sparse \
        else K.contiguous()
    if not isinstance(A, SparseA):
        A = A.contiguous()
    # the dense kernel's mode and what it reads of A, K^-1 and K, made
    # here once a solve: the graph reads the operand from its buffers
    mode = operand = None
    if _kernel_on(st) and q.device.type == "cuda":
        if not sparse:
            mode, operand = cuda_kernels.shared_plan(q.shape[0], A, Kinv,
                                                     KD, precision=prec)
        elif isinstance(Kinv, KernelWoodbury):
            # the structured operand carries its lowered copies itself
            if precision.is_low(prec):
                Kinv = lowered_layout(Kinv, prec)
        else:
            operand = cuda_kernels.sparse_operand(Kinv, prec)
    ops = (q, q2s, q2ref, A, cl, cu, lb, ub, Kinv, KD,
           rho_a[None, :].contiguous(), rho_x[None, :].contiguous(), glo,
           ghi, q.abs().amax(dim=1), operand)
    loop = [*state, _mv(A, state.x), _vote(state, st).to(torch.int32)]
    min_k = 128 if adaptive else 0
    out = device_loop.run(
        functools.partial(_block, st=st, sparse=sparse, mode=mode,
                          prec=prec),
        ops, loop,
        SPARSE_BLOCKS_PER_REPLAY if sparse else BLOCKS_PER_REPLAY,
        -(-st.max_iter // ce),
        key=("shared", st, sparse, mode, adaptive, prec),
        phase=lambda b: (gamma_due(b, st), plateau_due(b, st, min_k)))
    return _IterState(*out[:13])


def _median(v):
    """``jnp.median`` of a 1-D tensor: the mean of the two middle values
    when the length is even (``torch.median`` takes the lower one)."""
    srt = torch.sort(v).values
    k = srt.shape[0]
    if k % 2:
        return srt[k // 2]
    return 0.5 * (srt[k // 2 - 1] + srt[k // 2])


def _prep_shared(c, q2, A, cl, cu, lb, ub, settings, device,
                 want_masks=True):
    """Device placement, dtype casting, bound cleaning and the shared
    penalty-class masks (skipped by the frozen path, which never reads
    them).  A :class:`SparseA` stays on its own device, which must be the
    solve's."""
    sparse = isinstance(A, SparseA)
    dev = resolve_device(device, A.vals if sparse else A, c, q2, cl, cu,
                         lb, ub)
    dt = settings.tdtype()

    def t(v):
        return _tensor(v, dt, dev)

    c, q2 = t(c), t(q2)
    if sparse:
        # "cuda" names the current card, where A's tensors say "cuda:0"
        if A.device != torch.empty(0, device=dev).device:
            raise ValueError(f"the SparseA lives on {A.device}; the solve "
                             f"runs on {dev}")
        A = A.astype(dt)
    else:
        A = t(A)
    if A.ndim != 2:
        raise ValueError(f"the shared-A engine takes one (m, n) A; got "
                         f"shape {tuple(A.shape)}")
    cl, cu = _clean_bounds(t(cl), t(cu))
    lb, ub = _clean_bounds(t(lb), t(ub))
    if not want_masks:
        return c, q2, A, cl, cu, lb, ub, None
    # a row is boosted only when it is an equality in EVERY scenario
    # (families share structure; a non-uniform row just loses the boost)
    masks = _Masks(
        eq=((cu - cl).abs() < 1e-10).all(dim=0),
        loose=((cl <= -BIG / 2) & (cu >= BIG / 2)).all(dim=0),
        eqx=((ub - lb).abs() < 1e-10).all(dim=0))
    return c, q2, A, cl, cu, lb, ub, masks


def _scale_shared(c, q2, A, cl, cu, lb, ub, D, E, cost, warm):
    As = A.scale(E, D) if isinstance(A, SparseA) else (
        A * E[:, None] * D[None, :])
    q2s = q2 * (D * D)[None, :] * cost
    qs = c * D[None, :] * cost
    cls, cus = cl * E[None, :], cu * E[None, :]
    lbs, ubs = lb / D[None, :], ub / D[None, :]
    if warm is not None:
        x0, z0, y0, yx0 = (_tensor(v, A.dtype, A.device) for v in warm)
        warm = (x0 / D[None, :], z0 * E[None, :], y0 / E[None, :] * cost,
                yx0 * D[None, :] * cost)
    return qs, q2s, As, cls, cus, lbs, ubs, warm


def _start(warm, cls, cus, lbs, ubs, gamma):
    """Initial iterate: the scaled warm start, else zeros (z clipped)."""
    S, m = cls.shape
    n = lbs.shape[1]
    dt, dev = cls.dtype, cls.device
    if warm is None:
        x0 = torch.zeros((S, n), dtype=dt, device=dev)
        z0 = torch.clamp(torch.zeros((S, m), dtype=dt, device=dev), cls, cus)
        y0 = torch.zeros((S, m), dtype=dt, device=dev)
        yx0 = torch.zeros((S, n), dtype=dt, device=dev)
    else:
        x0, z0, y0, yx0 = warm
    inf = torch.full((S,), torch.inf, dtype=dt, device=dev)
    one = torch.ones((S,), dtype=dt, device=dev)
    return _IterState(x0, z0, torch.clamp(x0, lbs, ubs), y0, yx0, gamma,
                      inf, inf, one, one, *_counters(dt, dev))


def _gamma_bounds(q2s):
    """Gamma runs free for (near-)LP batches (dq2 = 0: the shared inverse
    is exact at any gamma); significant q2 clamps it near 1 to keep the
    dq2 = q2 (1 - gamma) refinement contractive."""
    lp_like = q2s.abs().amax() < 1e-12
    one = torch.ones((), dtype=q2s.dtype, device=q2s.device)
    return (torch.where(lp_like, 1e-4 * one, 0.6 * one),
            torch.where(lp_like, 1e4 * one, 1.8 * one))


def _solution(state, D, E, cost, iters, st) -> BatchSolution:
    """``iters``: the sweeps run, a 0-dim device tensor (never read)."""
    x, z = state.x * D[None, :], state.z / E[None, :]
    y = state.y * E[None, :] / cost
    yx = state.yx / D[None, :] / cost
    S = x.shape[0]
    return BatchSolution(
        x=x, z=z, y=y, yx=yx, pri_res=state.pri, dua_res=state.dua,
        iters=iters.to(torch.int64).expand(S).clone(),
        done=_done_mask(state.pri, state.dua, state.prinorm, state.duanorm,
                        st),
        raw=(x, z, y, yx))


def _solve_shared_impl(c, q2, A, cl, cu, lb, ub, settings, warm, device,
                       want_factors=False):
    st = settings
    c, q2, A, cl, cu, lb, ub, masks = _prep_shared(
        c, q2, A, cl, cu, lb, ub, st, device)
    S, n = c.shape
    m = A.shape[0]
    dt, dev = c.dtype, c.device

    D, E = _ruiz_shared(A, q2.mean(dim=0), st.scaling_iters)
    # shared scalar objective scaling (median scenario magnitude), so the
    # scaled q2, hence K, stays shared
    cost = 1.0 / torch.clamp(_median((c * D[None, :]).abs().amax(dim=1)),
                             min=1e-8)
    qs, q2s, As, cls, cus, lbs, ubs, warm = _scale_shared(
        c, q2, A, cl, cu, lb, ub, D, E, cost, warm)
    q2ref = q2s.mean(dim=0)
    glo, ghi = _gamma_bounds(q2s)

    def rho_vec(base):
        r = torch.where(masks.eq, base * st.rho_eq_scale, base)
        return torch.where(masks.loose, st.rho_min, r)

    def rho_x_vec(base):
        return torch.where(masks.eqx, base * st.rho_eq_scale,
                           base.expand(n))

    state = _start(warm, cls, cus, lbs, ubs,
                   torch.ones((S,), dtype=dt, device=dev))
    base = torch.full((), st.rho, dtype=dt, device=dev)
    total = torch.zeros((), dtype=torch.int64, device=dev)
    mult = torch.ones((m,), dtype=dt, device=dev)
    multx = torch.ones((n,), dtype=dt, device=dev)
    rho_a = torch.zeros((m,), dtype=dt, device=dev)
    rho_x = torch.zeros((n,), dtype=dt, device=dev)
    Kinv = K = Kd = None
    for _ in range(st.restarts):
        rho_a, rho_x = rho_vec(base), rho_x_vec(base)
        if st.rho_row_adapt:
            rho_a = torch.clamp(rho_a * mult, max=st.rho_row_max)
            rho_x = torch.clamp(rho_x * multx, max=st.rho_row_max)
        Kinv, K, Kd = _factor_shared(q2ref, As, rho_a, rho_x, st.sigma)
        state = _core(qs, q2s, q2ref, As, cls, cus, lbs, ubs,
                      state._replace(**dict(zip(("k", "best", "stall"),
                                                _counters(dt, dev)))),
                      Kd, K, rho_a, rho_x, glo, ghi, st, adaptive=True)
        total = total + state.k
        done = _done_mask(state.pri, state.dua, state.prinorm,
                          state.duanorm, st)
        eps_pri = st.eps_abs + st.eps_rel * torch.clamp(state.prinorm,
                                                        min=1.0)
        pri_rel = state.pri / torch.clamp(state.prinorm, min=1e-10)
        dua_rel = state.dua / torch.clamp(state.duanorm, min=1e-10)
        ratio = torch.sqrt(torch.clamp(pri_rel, min=1e-12)
                           / torch.clamp(dua_rel, min=1e-12))
        # shared base: geometric-mean ratio of the UNCONVERGED scenarios;
        # diverged ones (inf residuals, NaN ratio) are excluded so one
        # exploding scenario cannot poison the base for the batch
        ok = torch.isfinite(ratio)
        logr = torch.where(done | ~ok, 0.0,
                           torch.log(torch.clamp(ratio, 0.1, 10.0)))
        denom = torch.clamp((~done & ok).sum(), min=1)
        gmean = torch.exp(logr.sum() / denom)
        base = torch.where(done.all(), base,
                           torch.clamp(base * gmean, st.rho_min, st.rho_max))
        if st.rho_row_adapt:
            stuck = (state.pri > 100.0 * eps_pri)[:, None]
            gate = torch.maximum(0.3 * state.pri, 10.0 * eps_pri)[:, None]
            Ax = _mv(As, state.x)
            viol = torch.maximum(cls - Ax, Ax - cus)
            mult = torch.where((stuck & (viol > gate)).any(dim=0),
                               mult * st.rho_row_boost, mult)
            violx = torch.maximum(lbs - state.x, state.x - ubs)
            multx = torch.where((stuck & (violx > gate)).any(dim=0),
                                multx * st.rho_row_boost, multx)
    sol = _solution(state, D, E, cost, total, st)
    if want_factors:
        return sol, SharedFactors(D=D, E=E, cost=cost, rho_a=rho_a,
                                  rho_x=rho_x, gamma=state.gamma, Kinv=Kinv,
                                  K=K if st.factors_keep_K else None,
                                  q2ref=q2ref, Kinv_op=Kd)
    return sol


def solve_shared(c, q2, A, cl, cu, lb, ub,
                 settings: ADMMSettings = ADMMSettings(), warm=None,
                 device=None) -> BatchSolution:
    """Solve a shared-A batch: A is (m, n); everything else (S, ...).
    ``warm``: optional unscaled (x, z, y, yx) from a previous call."""
    return _solve_shared_impl(c, q2, A, cl, cu, lb, ub, settings, warm,
                              device)


def solve_shared_factored(c, q2, A, cl, cu, lb, ub,
                          settings: ADMMSettings = ADMMSettings(), warm=None,
                          device=None):
    """Adaptive shared-A solve that also returns :class:`SharedFactors`."""
    return _solve_shared_impl(c, q2, A, cl, cu, lb, ub, settings, warm,
                              device, want_factors=True)


def solve_shared_frozen(c, q2, A, cl, cu, lb, ub, factors: SharedFactors,
                        settings: ADMMSettings = ADMMSettings(), warm=None,
                        device=None) -> BatchSolution:
    """Sweep-only shared solve reusing a refresh's :class:`SharedFactors`:
    no Ruiz recomputation, factorization or restarts.  Valid while A and
    the bounds' structure are unchanged; per-scenario q2 drift is absorbed
    by the refinement against gamma K + diag(dq2), matrix-free through A
    when the factors carry no K.  ``settings.sweep_precision`` runs the
    mixed-precision sweep (:func:`.admm._frozen_sweep_phases`)."""
    device = resolve_device(device, factors.q2ref, c)
    c, q2, A, cl, cu, lb, ub, _ = _prep_shared(
        c, q2, A, cl, cu, lb, ub, settings, device, want_masks=False)
    D, E, cost = factors.D, factors.E, factors.cost
    qs, q2s, As, cls, cus, lbs, ubs, warm = _scale_shared(
        c, q2, A, cl, cu, lb, ub, D, E, cost, warm)
    glo, ghi = _gamma_bounds(q2s)

    def run_core(st0, st, prec):
        return _core(qs, q2s, factors.q2ref, As, cls, cus, lbs, ubs, st0,
                     factors.Kinv_op, factors.K, factors.rho_a,
                     factors.rho_x, glo, ghi, st, prec=prec)

    state = _frozen_sweep_phases(
        run_core, _start(warm, cls, cus, lbs, ubs, factors.gamma), settings)
    return _solution(state, D, E, cost, state.k, settings)
