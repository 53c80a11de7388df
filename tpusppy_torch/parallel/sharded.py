"""The PH wheel megastep on one device: N frozen PH iterations a window.

Port of the single-device parts of ``tpusppy/parallel/sharded.py``: the
problem and state carriers (:class:`PHArrays`, :class:`PHState`), the PH
update in device form (:func:`_node_xbar`, :func:`_ph_objective`,
:func:`_ph_finish`), the packed window measurement
(:func:`megastep_unpack`), the in-wheel bound pass
(:func:`_bound_pass_terms`) and the window itself
(:func:`make_wheel_megastep`).

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
batched integer sweep (``int_rounding``, Queue 1 item 6).  The reference's
AOT executable cache has no twin.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..solvers import admm, device_loop, shared_admm
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


def bound_pack_len(bounds: bool = False) -> int:
    """Length of the in-wheel bound tail (0 without the pass)."""
    return BOUND_PACK_LEN if bounds else 0


def megastep_measure_len(n_iters: int, S: int, n: int, K: int,
                         pack: str = "full", bounds: bool = False) -> int:
    """Length of the packed window measurement: per-iteration stats, the
    executed count and the refresh flag, the final residuals and done
    flags, with ``pack="full"`` the final x, W and xbars (``"lean"``
    leaves them on the device), and with ``bounds`` the bound tail."""
    base = 6 * n_iters + 2 + 3 * S
    if pack != "lean":
        base += S * n + 2 * S * K
    return base + bound_pack_len(bounds)


def unpack_bound_tail(out: dict, vec) -> dict:
    """Install the in-wheel bound scalars of a ``bounds=True``
    measurement into ``out``; ``bound_computed`` False means the window's
    pass was off (a cadence skip), the rest are zeros then."""
    tail = np.asarray(vec)[-BOUND_PACK_LEN:]
    out["bound_computed"] = bool(tail[0])
    out["bound_outer"] = float(tail[1])
    out["bound_inner_obj"] = float(tail[2])
    out["bound_inner_feas"] = float(tail[3])
    out["bound_sweeps"] = float(tail[4])
    return out


def megastep_unpack(vec, n_iters: int, S: int, n: int, K: int,
                    pack: str = "full", bounds: bool = False) -> dict:
    """Split a fetched window measurement (the reference's layout).

    Per-iteration arrays of length ``n_iters`` (zeros past the last
    iteration run): ``conv``, ``eobj``, ``pri_max``, ``dua_max``,
    ``iters``, ``all_done``; ``executed``; ``refresh_hit`` (an iterate
    failed the acceptance test: its update was discarded and its stats
    row sits at index ``executed``); the final accepted iterate's ``pri``,
    ``dua``, ``done`` (S,) and, with ``pack="full"``, ``x`` (S, n), ``W``
    and ``xbars`` (S, K); with ``bounds`` the bound tail."""
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
        out = unpack_bound_tail(out, vec)
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
                        int_rounding=None):
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

    Returns ``mega(state, arr, prox_on, factors, convthresh, n_live,
    accept_tol, bound_live=False, feas_tol=1e-3) -> (state, packed)``; the
    returned state is new tensors."""
    if mesh is not None:
        raise NotImplementedError(
            "make_wheel_megastep(mesh=...): the megastep over a mesh is not "
            "ported yet (ROADMAP Queue 1 item 7, torch.distributed)")
    if int_rounding:
        raise NotImplementedError(
            "make_wheel_megastep(int_rounding=...): the batched integer "
            "sweep is not ported yet (ROADMAP Queue 1 item 6)")
    if n_iters < 1:
        raise ValueError(f"n_iters ({n_iters}) must be >= 1")
    if pack not in ("full", "lean"):
        raise ValueError(f"pack must be 'full' or 'lean': {pack!r}")
    idx_np = np.asarray(nonant_idx, dtype=np.int64)
    int_mask = (None if int_nonants is None
                else np.asarray(int_nonants, dtype=bool))
    idx_on = {}     # device -> the nonant indices there, uploaded once

    def mega(state: PHState, arr: PHArrays, prox_on, factors, convthresh,
             n_live, accept_tol, bound_live=False, feas_tol=1e-3):
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
            if bound_live:
                terms = _bound_pass_terms(arr, st, idx, frozen, factors,
                                          settings, feas_tol, int_mask,
                                          xhat_threshold)
                parts.append(torch.stack([scalar(1.0), *terms]))
            else:
                parts.append(torch.zeros(BOUND_PACK_LEN, dtype=dt,
                                         device=dev))
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
