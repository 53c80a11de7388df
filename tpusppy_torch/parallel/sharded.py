"""The PH wheel megastep on one device: N frozen PH iterations a window.

Port of the single-device parts of ``tpusppy/parallel/sharded.py``: the
problem and state carriers (:class:`PHArrays`, :class:`PHState`), the PH
update in device form (:func:`_node_xbar`, :func:`_ph_objective`,
:func:`_ph_finish`), the packed window measurement
(:func:`megastep_unpack`), the in-wheel bound pass
(:func:`_bound_pass_terms`, and for a family with integer nonants the
batched integer pass of :mod:`..solvers.integer`) and the window itself
(:func:`make_wheel_megastep`), and the window of a shape-bucketed family
(:func:`make_bucketed_wheel_megastep`, :func:`_bucketed_finish`,
:func:`bucketed_megastep_unpack`): every bucket's frozen solve through its
own kernel loop, then one PH update across the buckets.

The reference runs a window as one jitted ``lax.scan``.  Here a window is
a host loop of at most N iterations, each: the augmented objective, the
frozen solve through its engine's hand kernel (the device sweep loop of
:mod:`..solvers.device_loop`), then the acceptance test, the PH update
(node xbar, W, conv) and the stats row, all on the device.  The
objective and the update are steps of a :class:`~..solvers.device_loop.
Program`, captured once per owner into CUDA graphs over buffers that
hold the window's carried state.  The window's stop word rides the frozen
solves' stop flags (:class:`~..solvers.device_loop.Gate`, under
:func:`~..solvers.device_loop.gated`): after the
convergence test fires or an iterate is rejected, the next solve sweeps
nothing, and the flag read it makes anyway ends the host loop.  The host
reads nothing else until the window's one packed fetch.

Not ported yet, and raising ``NotImplementedError``: the mesh and
``shard_map`` (ROADMAP Queue 1 item 7, on ``torch.distributed``) and the
bucketed window's in-wheel bound pass, its integer branch too
(``bounds``/``int_rounding`` of :func:`make_bucketed_wheel_megastep`,
Queue 1 item 7).  The reference's AOT executable cache has no twin.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..solvers import admm, cuda_kernels, device_loop, shared_admm
from ..solvers import integer as integer_solvers
from ..solvers.sparse import SparseA


class PHArrays(NamedTuple):
    """Device-resident problem data and tree indexing of a PH batch.
    ``A`` is (S, m, n), or the shared (m, n) matrix (dense or a
    :class:`~..solvers.sparse.SparseA`); ``onehot`` is the (S, K, N) node
    membership and ``nid_sk`` the (S, K) node id of each nonant slot
    (int64)."""

    c: torch.Tensor        # (S, n)
    q2: torch.Tensor       # (S, n)
    A: object              # (S, m, n), (m, n) or SparseA
    cl: torch.Tensor       # (S, m)
    cu: torch.Tensor       # (S, m)
    lb: torch.Tensor       # (S, n)
    ub: torch.Tensor       # (S, n)
    const: torch.Tensor    # (S,)
    probs: torch.Tensor    # (S,)
    onehot: torch.Tensor   # (S, K, N)
    nid_sk: torch.Tensor   # (S, K)


class PHState(NamedTuple):
    """The PH carry of a window."""

    W: torch.Tensor        # (S, K)
    xbars: torch.Tensor    # (S, K)
    rho: torch.Tensor      # (S, K)
    x: torch.Tensor        # (S, n) last solution
    z: torch.Tensor        # (S, m) ADMM aux
    y: torch.Tensor        # (S, m) ADMM dual
    yx: torch.Tensor       # (S, n) bound dual


class PHStepOut(NamedTuple):
    conv: torch.Tensor     # 0-dim: prob-weighted L1 deviation from xbar
    eobj: torch.Tensor     # 0-dim: expected objective at the new x
    pri_res: torch.Tensor  # (S,)
    dua_res: torch.Tensor  # (S,)
    iters: torch.Tensor    # 0-dim: the solve's sweeps (batch max)


def _node_xbar(onehot, probs, xk):
    """(N, K) per-node probability-weighted mean of the nonants ``xk``
    (the reference also returns E[x^2], which no window step reads)."""
    p = probs[:, None]
    num = torch.einsum("skn,sk->nk", onehot, p * xk)
    den = torch.einsum("skn,sk->nk", onehot, p.expand(xk.shape))
    return num / torch.clamp(den, min=1e-300)


def _gather_per_scenario(xbar_nk, nid_sk):
    """(S, K): each scenario's node value of every nonant slot."""
    return xbar_nk.gather(0, nid_sk)


def _ph_objective(arr, state, prox_on, idx):
    """The PH subproblem objective (q, q2) from the carried (W, xbars,
    rho), and the (W, rho) the update reads."""
    W, rho = state.W, state.rho
    q = arr.c.index_add(1, idx, W - prox_on * rho * state.xbars)
    q2 = arr.q2.index_add(1, idx, prox_on * rho)
    return q, q2, W, rho


def _ph_finish(arr, state, sol, W, rho, idx):
    """The PH update after a solve: node xbar, W, conv and eobj."""
    xk = sol.x.index_select(1, idx)
    new_xbars = _gather_per_scenario(
        _node_xbar(arr.onehot, arr.probs, xk), arr.nid_sk)
    new_W = W + rho * (xk - new_xbars)
    conv = arr.probs @ (xk - new_xbars).abs().mean(dim=1)
    lin = torch.einsum("sn,sn->s", arr.c, sol.x)
    quad = 0.5 * torch.einsum("sn,sn->s", arr.q2, sol.x * sol.x)
    eobj = arr.probs @ (lin + quad + arr.const)
    new_state = PHState(W=new_W, xbars=new_xbars, rho=rho, x=sol.x,
                        z=sol.z, y=sol.y, yx=sol.yx)
    return new_state, PHStepOut(conv, eobj, sol.pri_res, sol.dua_res,
                                sol.iters.max())


#: Scalars the in-wheel bound pass appends to the packed measurement:
#: [computed flag, Lagrangian outer bound, xhat-at-xbar expected
#: objective, feasible probability mass of that evaluation, its sweeps].
BOUND_PACK_LEN = 5


def bound_pack_len(bounds: bool = False, int_sweep: bool = False) -> int:
    """Length of the in-wheel bound tail (0 without the pass), with the
    integer sweep's :data:`~..solvers.integer.INT_BOUND_EXTRA` scalars
    where ``int_sweep``."""
    if not bounds:
        return 0
    return BOUND_PACK_LEN + (integer_solvers.INT_BOUND_EXTRA if int_sweep
                             else 0)


def megastep_measure_len(n_iters: int, S: int, n: int, K: int,
                         pack: str = "full", bounds: bool = False,
                         int_sweep: bool = False) -> int:
    """Length of the packed window measurement: per-iteration stats, the
    executed count and the refresh flag, the final residuals and done
    flags, with ``pack="full"`` the final x, W and xbars (``"lean"``
    leaves them on the device), and with ``bounds`` the bound tail (the
    integer sweep's longer one with ``int_sweep``)."""
    base = 6 * n_iters + 2 + 3 * S
    if pack != "lean":
        base += S * n + 2 * S * K
    return base + bound_pack_len(bounds, int_sweep)


def unpack_bound_tail(out: dict, vec, int_sweep: bool = False) -> dict:
    """Install the in-wheel bound scalars of a ``bounds=True``
    measurement into ``out``; ``bound_computed`` False means the window's
    pass was off (a cadence skip), the rest are zeros then.  ``int_sweep``
    also reads the integer extras: ``int_feas_cands``, ``int_best_idx``,
    ``int_rcfix_slots`` and ``bound_outer_base`` (the untightened outer)."""
    tail = np.asarray(vec)[-bound_pack_len(True, int_sweep):]
    out["bound_computed"] = bool(tail[0])
    out["bound_outer"] = float(tail[1])
    out["bound_inner_obj"] = float(tail[2])
    out["bound_inner_feas"] = float(tail[3])
    out["bound_sweeps"] = float(tail[4])
    if int_sweep:
        out["int_feas_cands"] = int(tail[5])
        out["int_best_idx"] = int(tail[6])
        out["int_rcfix_slots"] = int(tail[7])
        out["bound_outer_base"] = float(tail[8])
    return out


def megastep_unpack(vec, n_iters: int, S: int, n: int, K: int,
                    pack: str = "full", bounds: bool = False,
                    int_sweep: bool = False) -> dict:
    """Split a fetched window measurement (the reference's layout).

    Per-iteration arrays of length ``n_iters`` (zeros past the last
    iteration run): ``conv``, ``eobj``, ``pri_max``, ``dua_max``,
    ``iters``, ``all_done``; ``executed``; ``refresh_hit`` (an iterate
    failed the acceptance test: its update was discarded and its stats
    row sits at index ``executed``); the final accepted iterate's ``pri``,
    ``dua``, ``done`` (S,) and, with ``pack="full"``, ``x`` (S, n), ``W``
    and ``xbars`` (S, K); with ``bounds`` the bound tail
    (:func:`unpack_bound_tail`)."""
    vec = np.asarray(vec)
    N = n_iters
    per = vec[:6 * N].reshape(6, N)
    off = 6 * N
    out = {
        "conv": per[0], "eobj": per[1], "pri_max": per[2],
        "dua_max": per[3], "iters": per[4], "all_done": per[5] != 0.0,
        "executed": int(vec[off]), "refresh_hit": bool(vec[off + 1]),
    }
    off += 2
    out["pri"] = vec[off:off + S]
    out["dua"] = vec[off + S:off + 2 * S]
    out["done"] = vec[off + 2 * S:off + 3 * S] != 0.0
    off += 3 * S
    if bounds:
        out = unpack_bound_tail(out, vec, int_sweep)
    if pack == "lean":
        return out
    out["x"] = vec[off:off + S * n].reshape(S, n)
    off += S * n
    out["W"] = vec[off:off + S * K].reshape(S, K)
    off += S * K
    out["xbars"] = vec[off:off + S * K].reshape(S, K)
    return out


def _frozen_fn(A):
    """The frozen solve of ``A``'s engine: the shared-A engine for an
    (m, n) matrix or a SparseA, else the dense per-scenario one."""
    if isinstance(A, SparseA) or A.ndim == 2:
        return shared_admm.solve_shared_frozen
    return admm.solve_batch_frozen


def _bound_pass_terms(arr, st, idx, frozen_fn, factors, settings,
                      feas_tol, int_mask, xhat_threshold):
    """The in-wheel bound pass on a window's final state, on the device.

    OUTER: the Lagrangian bound (W on, prox off) through the weak-duality
    assembly :func:`..solvers.admm.dual_objective_with_margin` with the
    state's row duals (any duals certify).  INNER: the xhat-at-xbar
    candidate (the consensus ``xbars``, integer nonant slots rounded at
    ``xhat_threshold``, clipped to the nonant box), clamped onto the
    nonant columns and evaluated by one frozen solve on the window's
    factors under the PH-augmented objective (on the clamped box it
    differs from the plain one by a constant, so the minimizer is the
    same); the PLAIN expected objective is reported, with the
    probability mass of scenarios whose primal residual is below
    ``feas_tol``.  Returns ``(outer, inner_obj, feas_mass, sweeps)``."""
    dt = arr.c.dtype
    qL = arr.c.index_add(1, idx, st.W)
    packed = admm.dual_objective_with_margin(
        qL, arr.q2, arr.A, arr.cl, arr.cu, arr.lb, arr.ub, st.y, st.x)
    outer = arr.probs @ (packed[0] - packed[1] + arr.const)
    cand = st.xbars
    if int_mask is not None and int_mask.any():
        mask = torch.as_tensor(int_mask, device=cand.device)[None, :]
        cand = torch.where(mask, torch.floor(cand + (1.0 - xhat_threshold)),
                           cand)
    # consensus means carry ADMM tolerance noise: a clamped column eps
    # outside its box would make the whole evaluation read infeasible
    cand = torch.clamp(cand, arr.lb.index_select(1, idx),
                       arr.ub.index_select(1, idx))
    lb2 = arr.lb.index_copy(1, idx, cand)
    ub2 = arr.ub.index_copy(1, idx, cand)
    q, q2, _, _ = _ph_objective(arr, st, 1.0, idx)
    x0 = st.x.index_copy(1, idx, cand)
    sol = frozen_fn(q, q2, arr.A, arr.cl, arr.cu, lb2, ub2, factors,
                    settings=settings, warm=(x0, st.z, st.y, st.yx))
    lin = torch.einsum("sn,sn->s", arr.c, sol.x)
    quad = 0.5 * torch.einsum("sn,sn->s", arr.q2, sol.x * sol.x)
    inner = arr.probs @ (lin + quad + arr.const)
    feas = arr.probs @ (sol.pri_res < feas_tol).to(dt)
    return outer, inner, feas, sol.iters.max().to(dt)


# ---- the window's steps (device_loop.Program) --------------------------------
def _buffers_arrays(b):
    """The problem data a step reads, from the program's buffers."""
    return PHArrays(c=b["c"], q2=b["q2"], A=None, cl=None, cu=None,
                    lb=None, ub=None, const=b["const"], probs=b["probs"],
                    onehot=b["onehot"], nid_sk=b["nid_sk"])


def _buffers_state(b):
    return PHState(*(b[k] for k in PHState._fields))


class _Solved(NamedTuple):
    """A frozen solve's result as the finish step reads it."""

    x: torch.Tensor
    z: torch.Tensor
    y: torch.Tensor
    yx: torch.Tensor
    pri_res: torch.Tensor
    dua_res: torch.Tensor
    iters: torch.Tensor


def _objective_step(b):
    """The augmented objective of the carried state into ``qa``/``q2a``."""
    q, q2, _, _ = _ph_objective(_buffers_arrays(b), _buffers_state(b),
                                b["prox"], b["idx"])
    b["qa"].copy_(q)
    b["q2a"].copy_(q2)


def _finish_step(b):
    """The acceptance test, the PH update and the stats row of one
    iteration, from the solve's result in the ``s*`` buffers.  A live
    iteration (the stop word clear) writes its stats row at index ``it``;
    its update is kept only when the iterate is accepted: every scenario
    eps-converged, or every residual within ``tol`` (a non-finite one
    fails).  The window stops after the iteration whose conv falls below
    ``thresh``, or at a rejected iterate (``refresh`` set)."""
    live = b["word"] == 0
    pri, dua, done = b["spri"], b["sdua"], b["sdone"]
    tol = b["tol"]
    ok = done.all() | ((pri <= tol) & (dua <= tol)).all()
    st = _buffers_state(b)
    sol = _Solved(b["sx"], b["sz"], b["sy"], b["syx"], pri, dua,
                  b["siters"])
    new, out = _ph_finish(_buffers_arrays(b), st, sol, st.W, st.rho,
                          b["idx"])
    dt = pri.dtype
    row = torch.stack([out.conv, out.eobj, pri.max(), dua.max(),
                       out.iters.to(dt), done.all().to(dt)])
    take = live & ok
    device_loop.commit(
        ~take, (st.W, st.xbars, st.x, st.z, st.y, st.yx, b["pri"],
                b["dua"], b["done"]),
        (new.W, new.xbars, new.x, new.z, new.y, new.yx, pri, dua, done))
    stats = b["stats"]
    torch.where((live & (b["steps"] == b["it"]))[:, None], row, stats,
                out=stats)
    b["executed"].add_(take.to(torch.int64))
    b["stopped"].logical_or_((take & (out.conv < b["thresh"]))
                             | (live & ~ok))
    b["refresh"].logical_or_(live & ~ok)
    b["it"].add_(live.to(torch.int64))
    b["word"].copy_(b["stopped"].to(torch.int32) * device_loop.WINDOW_BIT)


def _templates(arr, state, n_iters, idx):
    """The window program's buffers: problem data and scalars (loaded
    every window), the carried state, and scratch."""
    dt, dev = arr.c.dtype, arr.c.device
    S, n = arr.c.shape
    m = arr.cl.shape[1]

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    i64, flag = torch.int64, torch.bool
    return dict(
        c=arr.c, q2=arr.q2, const=arr.const, probs=arr.probs,
        onehot=arr.onehot, nid_sk=arr.nid_sk, idx=idx, prox=zeros(),
        thresh=zeros(), tol=zeros(),
        **state._asdict(),
        pri=zeros(S), dua=zeros(S), done=zeros(S, dtype=flag),
        it=zeros(dtype=i64), executed=zeros(dtype=i64),
        stopped=zeros(dtype=flag), refresh=zeros(dtype=flag),
        word=zeros(dtype=torch.int32), stats=zeros(n_iters, 6),
        steps=torch.arange(n_iters, device=dev),
        qa=zeros(S, n), q2a=zeros(S, n), sx=zeros(S, n), sz=zeros(S, m),
        sy=zeros(S, m), syx=zeros(S, n), spri=zeros(S), sdua=zeros(S),
        siters=zeros(S, dtype=i64), sdone=zeros(S, dtype=flag))


def make_wheel_megastep(nonant_idx, settings, mesh=None, n_iters: int = 8,
                        pack: str = "full", bounds: bool = False,
                        int_nonants=None, xhat_threshold: float = 0.5,
                        int_rounding=None, int_cols=None,
                        rcfix_slack: float = 1e-5, int_rcfix: bool = True):
    """The window function: up to ``n_iters`` frozen PH iterations on the
    device and one packed measurement (:func:`megastep_unpack`).

    Each iteration assembles the PH objective from the carried (W, xbars,
    rho), runs the frozen solve on ``factors`` (the dense, shared-A or
    sparse engine, by the type of ``arr.A``), applies the acceptance test
    and the PH update and writes its stats row.  The window stops after
    the iteration whose conv falls below ``convthresh``, after ``n_live``
    iterations, or at an iterate that fails the acceptance test (neither
    all eps-converged nor every residual within ``accept_tol``): that
    iterate's update is discarded and ``refresh_hit`` set, and the host
    then refreshes, as the legacy loop discards a rejected frozen solve.

    ``pack="lean"`` leaves x, W and xbars out of the fetch (they stay in
    the returned state on the device).  ``bounds=True`` appends the
    in-wheel bound pass's tail (:func:`_bound_pass_terms`), computed
    where the call's ``bound_live`` is set and zeros otherwise;
    ``int_nonants`` is the (K,) integer mask of nonant slots, rounded at
    ``xhat_threshold`` in the candidate.

    ``int_rounding`` (a tuple of rounding thresholds) arms the batched
    integer sweep for a family with integer nonants: the bound pass
    becomes :func:`..solvers.integer.integer_bound_pass` (the best of the
    ladder and the SLAM slams, reduced-cost fixing from the state's duals
    and the tightened outer bound), and the tail grows by
    :data:`~..solvers.integer.INT_BOUND_EXTRA` scalars.  ``int_cols``: the
    (n,) mask of ALL integer columns, the fixing's scope (default the
    integer nonant slots); ``int_rcfix=False`` turns the fixing off (a
    family with second-stage integers).  A family without integer nonants
    ignores the integer options and runs the plain pass.

    Returns ``mega(state, arr, prox_on, factors, convthresh, n_live,
    accept_tol, bound_live=False, feas_tol=1e-3, bound_launches=None) ->
    (state, packed)``; the returned state is new tensors.
    ``bound_launches``: for the integer pass, a list of C + 1 dicts that
    receive the launches of each candidate's evaluation and of the
    re-certification (:func:`..solvers.cuda_kernels.counts` of the
    calling thread)."""
    if mesh is not None:
        raise NotImplementedError(
            "make_wheel_megastep(mesh=...): the megastep over a mesh is not "
            "ported yet (ROADMAP Queue 1 item 7, torch.distributed)")
    if n_iters < 1:
        raise ValueError(f"n_iters ({n_iters}) must be >= 1")
    if pack not in ("full", "lean"):
        raise ValueError(f"pack must be 'full' or 'lean': {pack!r}")
    idx_np = np.asarray(nonant_idx, dtype=np.int64)
    int_mask = (None if int_nonants is None
                else np.asarray(int_nonants, dtype=bool))
    # the integer sweep only where the family has integer nonants and a
    # ladder was asked for: otherwise the plain pass, whatever the options
    int_sweep = bool(bounds and int_mask is not None and int_mask.any()
                     and int_rounding)
    int_thresholds = tuple(float(t) for t in (int_rounding or ()))
    tail_len = bound_pack_len(True, int_sweep)
    idx_on = {}     # device -> the nonant indices there, uploaded once

    def mega(state: PHState, arr: PHArrays, prox_on, factors, convthresh,
             n_live, accept_tol, bound_live=False, feas_tol=1e-3,
             bound_launches=None):
        dt, dev = arr.c.dtype, arr.c.device
        idx = idx_on.get(dev)
        if idx is None:
            idx = idx_on[dev] = torch.as_tensor(idx_np, device=dev)
        frozen = _frozen_fn(arr.A)
        prog = device_loop.program(("ph_window", n_iters),
                                   _templates(arr, state, n_iters, idx),
                                   gate="word")
        b = prog.bufs

        def scalar(v):
            return torch.full((), float(v), dtype=dt, device=dev)

        prog.load(dict(
            c=arr.c, q2=arr.q2, const=arr.const, probs=arr.probs,
            onehot=arr.onehot, nid_sk=arr.nid_sk, idx=idx,
            prox=scalar(prox_on), thresh=scalar(convthresh),
            tol=scalar(accept_tol), **state._asdict()))
        for k in ("pri", "dua"):
            b[k].fill_(float("inf"))
        for k in ("done", "it", "executed", "stopped", "refresh", "word",
                  "stats"):
            b[k].zero_()
        gate = device_loop.Gate(b["word"])
        for _ in range(min(int(n_live), n_iters)):
            prog.run("objective", _objective_step)
            with device_loop.gated(gate):
                sol = frozen(b["qa"], b["q2a"], arr.A, arr.cl, arr.cu,
                             arr.lb, arr.ub, factors, settings=settings,
                             warm=(b["x"], b["z"], b["y"], b["yx"]))
            if gate.seen:
                # the window stopped in the iteration before: this solve
                # swept nothing
                break
            prog.load(dict(sx=sol.x, sz=sol.z, sy=sol.y, syx=sol.yx,
                           spri=sol.pri_res, sdua=sol.dua_res,
                           siters=sol.iters, sdone=sol.done))
            prog.run("finish", _finish_step)
        st = PHState(*(b[k].clone() for k in PHState._fields))
        parts = [b["stats"].T.reshape(-1), b["executed"].to(dt)[None],
                 b["refresh"].to(dt)[None], b["pri"], b["dua"],
                 b["done"].to(dt)]
        if pack == "full":
            parts += [st.x.reshape(-1), st.W.reshape(-1),
                      st.xbars.reshape(-1)]
        if bounds:
            if bound_live and int_sweep:
                # the PH-augmented objective (prox on): the window's factors
                q, q2, _, _ = _ph_objective(arr, st, 1.0, idx)
                if int_cols is None:
                    cols = torch.zeros(arr.c.shape[1], dtype=torch.bool,
                                       device=dev)
                    cols[idx] = torch.as_tensor(int_mask, device=dev)
                else:
                    cols = torch.as_tensor(np.asarray(int_cols, dtype=bool),
                                           device=dev)
                parts.append(integer_solvers.integer_bound_pass(
                    arr, st, idx, q, q2, frozen, factors, settings,
                    feas_tol, int_mask, int_thresholds, cols, rcfix_slack,
                    rcfix_enabled=bool(int_rcfix),
                    launches=bound_launches))
            elif bound_live:
                terms = _bound_pass_terms(arr, st, idx, frozen, factors,
                                          settings, feas_tol, int_mask,
                                          xhat_threshold)
                parts.append(torch.stack([scalar(1.0), *terms]))
            else:
                parts.append(torch.zeros(tail_len, dtype=dt, device=dev))
        return st, torch.cat(parts)

    return mega


def init_state(arr: PHArrays, default_rho: float, settings) -> PHState:
    """The zero PH state with rho at ``default_rho``."""
    dt, dev = settings.tdtype(), arr.c.device
    S, n = arr.c.shape
    m = arr.cl.shape[1]
    K = arr.nid_sk.shape[1]

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    return PHState(W=zeros(S, K), xbars=zeros(S, K),
                   rho=torch.full((S, K), float(default_rho), dtype=dt,
                                  device=dev),
                   x=zeros(S, n), z=zeros(S, m), y=zeros(S, m),
                   yx=zeros(S, n))


# ---- the bucketed window (a ragged family) ----------------------------------
def bucketed_megastep_measure_len(n_iters: int, shapes, K: int,
                                  bounds: bool = False) -> int:
    """Length of the bucketed packed measurement; ``shapes`` is
    ``[(S_b, n_b), ...]`` in bucket order."""
    S = sum(s for s, _ in shapes)
    return (6 * n_iters + 2 + 3 * S + sum(s * n for s, n in shapes)
            + 2 * S * K + bound_pack_len(bounds))


def bucketed_megastep_unpack(vec, n_iters: int, shapes, K: int,
                             bounds: bool = False) -> dict:
    """Split a fetched :func:`make_bucketed_wheel_megastep` measurement.

    The global per-iteration stats, ``executed`` and ``refresh_hit`` as in
    :func:`megastep_unpack`; the per-scenario blocks come back per bucket
    (``shapes`` order): ``pri``, ``dua`` and ``done`` lists of (S_b,)
    arrays, ``x`` a list of (S_b, n_b), ``W`` and ``xbars`` lists of
    (S_b, K), for the host to scatter through each bucket's scenario
    indices; with ``bounds`` the bound tail."""
    vec = np.asarray(vec)
    N = n_iters
    per = vec[:6 * N].reshape(6, N)
    off = 6 * N
    out = {
        "conv": per[0], "eobj": per[1], "pri_max": per[2],
        "dua_max": per[3], "iters": per[4], "all_done": per[5] != 0.0,
        "executed": int(vec[off]), "refresh_hit": bool(vec[off + 1]),
    }
    off += 2
    if bounds:
        out = unpack_bound_tail(out, vec)
    pri, dua, done = [], [], []
    for S_b, _ in shapes:
        pri.append(vec[off:off + S_b])
        dua.append(vec[off + S_b:off + 2 * S_b])
        done.append(vec[off + 2 * S_b:off + 3 * S_b] != 0.0)
        off += 3 * S_b
    xs = []
    for S_b, n_b in shapes:
        xs.append(vec[off:off + S_b * n_b].reshape(S_b, n_b))
        off += S_b * n_b
    Ws, xbs = [], []
    for S_b, _ in shapes:
        Ws.append(vec[off:off + S_b * K].reshape(S_b, K))
        off += S_b * K
    for S_b, _ in shapes:
        xbs.append(vec[off:off + S_b * K].reshape(S_b, K))
        off += S_b * K
    out.update(pri=pri, dua=dua, done=done, x=xs, W=Ws, xbars=xbs)
    return out


def _bucketed_finish(arrs, states, sols, Ws, rhos, idx, dt):
    """The PH update across buckets: each bucket adds its node-membership
    partial sums (its ``onehot`` and ``probs`` are rows of the GLOBAL
    tree's), the node averages form once, and each bucket gathers its
    scenarios' rows back.  Returns ``(new_states, conv, eobj)``."""
    num = den = None
    xks = []
    for arr, sol in zip(arrs, sols):
        xk = sol.x.index_select(1, idx)
        xks.append(xk)
        p = arr.probs[:, None]
        nm = torch.einsum("skn,sk->nk", arr.onehot, p * xk)
        dn = torch.einsum("skn,sk->nk", arr.onehot, p.expand(xk.shape))
        num = nm if num is None else num + nm
        den = dn if den is None else den + dn
    xbar_nk = num / torch.clamp(den, min=1e-300)
    new_states = []
    conv = torch.zeros((), dtype=dt, device=xbar_nk.device)
    eobj = torch.zeros((), dtype=dt, device=xbar_nk.device)
    for arr, sol, W, rho, xk in zip(arrs, sols, Ws, rhos, xks):
        new_xbars = _gather_per_scenario(xbar_nk, arr.nid_sk)
        new_W = W + rho * (xk - new_xbars)
        conv = conv + arr.probs @ (xk - new_xbars).abs().mean(dim=1)
        lin = torch.einsum("sn,sn->s", arr.c, sol.x)
        quad = 0.5 * torch.einsum("sn,sn->s", arr.q2, sol.x * sol.x)
        eobj = eobj + arr.probs @ (lin + quad + arr.const)
        new_states.append(PHState(W=new_W, xbars=new_xbars, rho=rho,
                                  x=sol.x, z=sol.z, y=sol.y, yx=sol.yx))
    return tuple(new_states), conv, eobj


def _bk(name, bi):
    """The program buffer name of bucket ``bi``'s ``name``."""
    return f"{name}@{bi}"


def _bucket_bufs(b, bi):
    """Bucket ``bi``'s buffers of a bucketed window program under their
    plain names, with the program's shared ``idx`` and ``prox``."""
    out = {k: b[_bk(k, bi)] for k in _BUCKET_KEYS}
    out["idx"], out["prox"] = b["idx"], b["prox"]
    return out


#: The names of a bucket's own buffers in a bucketed window program.
_BUCKET_KEYS = ("c", "q2", "const", "probs", "onehot", "nid_sk", "pri",
                "dua", "done", "qa", "q2a", "sx", "sz", "sy", "syx", "spri",
                "sdua", "siters", "sdone") + PHState._fields


def _bucketed_objective_step(nb, b):
    """Every bucket's augmented objective into its ``qa``/``q2a``."""
    for bi in range(nb):
        _objective_step(_bucket_bufs(b, bi))


def _bucketed_finish_step(nb, b):
    """The bucketed twin of :func:`_finish_step`: the acceptance test over
    ALL buckets (the family's iterate is accepted or rejected as one),
    the PH update across buckets (:func:`_bucketed_finish`), one stats
    row (the buckets' worst residuals and largest sweep count), each
    bucket's state committed where the iterate is taken."""
    live = b["word"] == 0
    tol = b["tol"]
    bufs = [_bucket_bufs(b, bi) for bi in range(nb)]
    all_done = lad = None
    sols, states = [], []
    for bb in bufs:
        pri, dua, done = bb["spri"], bb["sdua"], bb["sdone"]
        d = done.all()
        g = ((pri <= tol) & (dua <= tol)).all()
        all_done = d if all_done is None else all_done & d
        lad = g if lad is None else lad & g
        sols.append(_Solved(bb["sx"], bb["sz"], bb["sy"], bb["syx"], pri,
                            dua, bb["siters"]))
        states.append(_buffers_state(bb))
    ok = all_done | lad
    arrs = [_buffers_arrays(bb) for bb in bufs]
    dt = b["tol"].dtype
    new, conv, eobj = _bucketed_finish(
        arrs, states, sols, [st.W for st in states],
        [st.rho for st in states], b["idx"], dt)
    row = torch.stack([
        conv, eobj, torch.stack([s.pri_res.max() for s in sols]).max(),
        torch.stack([s.dua_res.max() for s in sols]).max(),
        torch.stack([s.iters.max() for s in sols]).max().to(dt),
        all_done.to(dt)])
    take = live & ok
    for bb, st, nw, sol in zip(bufs, states, new, sols):
        device_loop.commit(
            ~take, (st.W, st.xbars, st.x, st.z, st.y, st.yx, bb["pri"],
                    bb["dua"], bb["done"]),
            (nw.W, nw.xbars, nw.x, nw.z, nw.y, nw.yx, sol.pri_res,
             sol.dua_res, bb["sdone"]))
    stats = b["stats"]
    torch.where((live & (b["steps"] == b["it"]))[:, None], row, stats,
                out=stats)
    b["executed"].add_(take.to(torch.int64))
    b["stopped"].logical_or_((take & (conv < b["thresh"])) | (live & ~ok))
    b["refresh"].logical_or_(live & ~ok)
    b["it"].add_(live.to(torch.int64))
    b["word"].copy_(b["stopped"].to(torch.int32) * device_loop.WINDOW_BIT)


def _bucketed_templates(arrs, states, n_iters, idx):
    """The bucketed window program's buffers: each bucket's (suffixed with
    its index) as :func:`_templates` makes them, and the shared scalars,
    counters and stats once."""
    out = {}
    for bi, (arr, st) in enumerate(zip(arrs, states)):
        one = _templates(arr, st, n_iters, idx)
        for k, v in one.items():
            if k in _BUCKET_KEYS:
                out[_bk(k, bi)] = v
            else:
                out.setdefault(k, v)
    return out


def make_bucketed_wheel_megastep(nonant_idx, settings, n_iters: int = 8,
                                 bounds: bool = False, int_nonants=None,
                                 xhat_threshold: float = 0.5,
                                 int_rounding=None):
    """The window function of a shape-bucketed (ragged) family: up to
    ``n_iters`` frozen PH iterations over every bucket and one packed
    measurement (:func:`bucketed_megastep_unpack`).

    Each iteration assembles every bucket's PH objective, runs each
    bucket's frozen solve on its own factors through its engine's kernel
    loop (its own captured graphs: the loops are keyed by shape), then
    one PH update couples the buckets (:func:`_bucketed_finish`: node sums
    over all buckets through the global tree's rows, each bucket gathering
    its own back).  The acceptance test and the stop are the family's,
    and the window's stop word rides every bucket's solves.
    ``nonant_idx`` is the global nonant column index array, valid in
    every bucket's column space because a bundle's EF puts the root
    nonants first.

    ``bounds=True`` (the bucketed in-wheel bound pass) raises: not ported
    yet (ROADMAP Queue 1 item 7); so does ``int_rounding``, its integer
    branch (the same item).  Returns ``mega(states, arrs, prox_on,
    factors, convthresh, n_live, accept_tol, bucket_launches=None) ->
    (states, packed)`` over
    tuples of per-bucket :class:`PHState`, :class:`PHArrays` and factors;
    ``bucket_launches``, a list of one dict a bucket, receives each
    bucket's kernel launches (:func:`..solvers.cuda_kernels.counts` of
    the calling thread) made in its frozen solves."""
    if bounds:
        raise NotImplementedError(
            "make_bucketed_wheel_megastep(bounds=True): the bucketed "
            "in-wheel bound pass is not ported yet (ROADMAP Queue 1 item 7)")
    if int_rounding:
        raise NotImplementedError(
            "make_bucketed_wheel_megastep(int_rounding=...): the bucketed "
            "bound pass's integer branch is not ported yet (ROADMAP Queue 1 "
            "item 7)")
    if n_iters < 1:
        raise ValueError(f"n_iters ({n_iters}) must be >= 1")
    idx_np = np.asarray(nonant_idx, dtype=np.int64)
    idx_on = {}

    def mega(states, arrs, prox_on, factors, convthresh, n_live,
             accept_tol, bucket_launches=None):
        nb = len(arrs)
        dt, dev = arrs[0].c.dtype, arrs[0].c.device
        idx = idx_on.get(dev)
        if idx is None:
            idx = idx_on[dev] = torch.as_tensor(idx_np, device=dev)
        frozen = [_frozen_fn(arr.A) for arr in arrs]
        prog = device_loop.program(
            ("ph_window_bucketed", n_iters, nb),
            _bucketed_templates(arrs, states, n_iters, idx), gate="word")
        b = prog.bufs

        def scalar(v):
            return torch.full((), float(v), dtype=dt, device=dev)

        load = dict(idx=idx, prox=scalar(prox_on), thresh=scalar(convthresh),
                    tol=scalar(accept_tol))
        for bi, (arr, st) in enumerate(zip(arrs, states)):
            vals = dict(c=arr.c, q2=arr.q2, const=arr.const,
                        probs=arr.probs, onehot=arr.onehot,
                        nid_sk=arr.nid_sk, **st._asdict())
            load.update({_bk(k, bi): v for k, v in vals.items()})
        prog.load(load)
        for bi in range(nb):
            for k in ("pri", "dua"):
                b[_bk(k, bi)].fill_(float("inf"))
            b[_bk("done", bi)].zero_()
        for k in ("it", "executed", "stopped", "refresh", "word", "stats"):
            b[k].zero_()
        gate = device_loop.Gate(b["word"])
        objective = functools.partial(_bucketed_objective_step, nb)
        finish = functools.partial(_bucketed_finish_step, nb)
        for _ in range(min(int(n_live), n_iters)):
            prog.run("objective", objective)
            sols = []
            for bi, arr in enumerate(arrs):
                if bucket_launches is not None:
                    before = cuda_kernels.counts(local=True)
                with device_loop.gated(gate):
                    sol = frozen[bi](
                        b[_bk("qa", bi)], b[_bk("q2a", bi)], arr.A, arr.cl,
                        arr.cu, arr.lb, arr.ub, factors[bi],
                        settings=settings,
                        warm=tuple(b[_bk(k, bi)]
                                   for k in ("x", "z", "y", "yx")))
                if bucket_launches is not None:
                    seen = bucket_launches[bi]
                    for k, v in cuda_kernels.counts(local=True).items():
                        if v != before[k]:
                            seen[k] = seen.get(k, 0) + v - before[k]
                if gate.seen:
                    break
                sols.append(sol)
            if gate.seen:
                # the window stopped in the iteration before: this
                # iteration's solves swept nothing
                break
            sol_bufs = {}
            for bi, sol in enumerate(sols):
                sol_bufs.update({
                    _bk(k, bi): v for k, v in (
                        ("sx", sol.x), ("sz", sol.z), ("sy", sol.y),
                        ("syx", sol.yx), ("spri", sol.pri_res),
                        ("sdua", sol.dua_res), ("siters", sol.iters),
                        ("sdone", sol.done))})
            prog.load(sol_bufs)
            prog.run("finish", finish)
        out_states = tuple(
            PHState(*(b[_bk(k, bi)].clone() for k in PHState._fields))
            for bi in range(nb))
        parts = [b["stats"].T.reshape(-1), b["executed"].to(dt)[None],
                 b["refresh"].to(dt)[None]]
        for bi in range(nb):
            parts += [b[_bk("pri", bi)], b[_bk("dua", bi)],
                      b[_bk("done", bi)].to(dt)]
        parts += [st.x.reshape(-1) for st in out_states]
        parts += [st.W.reshape(-1) for st in out_states]
        parts += [st.xbars.reshape(-1) for st in out_states]
        return out_states, torch.cat(parts)

    return mega
