"""The sweep loop on the device (tpusppy_torch.solvers.device_loop): the
solve cores' blocks run L at a time between stop-flag reads, gated by a
sticky device flag, on each engine: the dense per-scenario engine (farmer,
random LPs), the dense shared-A engine (uc_lite) and the SparseA structured
engine (uc at 10 generators, 4 hours).

Tolerances: across L the solution and ``iters`` are bitwise equal (blocks
past the stop change nothing); against the reference (``tpusppy``, float64
on the CPU, the same numpy inputs) 1e-9 relative to the largest entry, as
the engines' own parity tests.  The flag reads are pinned at
``ceil(blocks / L)`` a core call (one at least), the replays at one more
where the sweep cap leaves room (the replay queued ahead of each read, on
the CPU as on the card).  The CUDA-graph cases are marked ``cuda`` and
skip without a card.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusppy.ir import ScenarioBatch as JBatch
from tpusppy.models import farmer as jfarmer
from tpusppy.solvers import admm as jadmm
from tpusppy.solvers import shared_admm as jshared
from tpusppy.solvers.sparse import SparseA as JSparseA
from tpusppy_torch.models import uc as tuc
from tpusppy_torch.models import uc_lite as tuc_lite
from tpusppy_torch.obs import metrics
from tpusppy_torch.solvers import admm as tadmm
from tpusppy_torch.solvers import cuda_kernels, device_loop
from tpusppy_torch.solvers import shared_admm as tshared
from tpusppy_torch.solvers import sparse as tsparse
from tpusppy_torch.spbase import build_batch

torch.set_num_threads(1)

LS = (1, 3, 8)
# 101 blocks of 4 sweeps: a multiple of none of LS but 1
MAX_ITER = 404
UC_KW = {"num_gens": 10, "horizon": 4, "relax_integers": True}
UC_LITE_KW = {"num_gens": 3, "horizon": 5, "relax_integers": True}


def _close(got, ref, tol, what=""):
    got = np.asarray(got, dtype=float)
    ref = np.asarray(ref, dtype=float)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.max(np.abs(ref))) if ref.size else 1.0)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} * {scale:.3g}"


def _fields(sol):
    return (sol.x, sol.z, sol.y, sol.yx, sol.pri_res, sol.dua_res,
            sol.iters, sol.done, *sol.raw)


def _bitwise(a, b):
    for i, (u, v) in enumerate(zip(_fields(a), _fields(b))):
        assert torch.equal(u, v), f"field {i} differs across L"


def _near_reference(tsol, jsol, tol=1e-9):
    assert int(tsol.iters[0]) == int(np.asarray(jsol.iters)[0])
    for name in ("x", "z", "y", "yx", "pri_res", "dua_res"):
        _close(getattr(tsol, name), getattr(jsol, name), tol, name)
    assert np.array_equal(np.asarray(tsol.done), np.asarray(jsol.done))


def _random_lps(seed=0, S=6, n=8, m=6):
    """Random LPs with a known feasible point (tests/test_admm.py)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(S):
        A = rng.normal(size=(m, n))
        x_feas = rng.uniform(0.2, 0.8, size=n)
        slack = rng.uniform(0.5, 1.5, size=m)
        Ax = A @ x_feas
        cu = Ax + slack
        cl = np.where(rng.uniform(size=m) < 0.3, Ax - slack, -np.inf)
        out.append((rng.normal(size=n), A, cl, cu, np.zeros(n),
                    np.full(n, 2.0)))
    c, A, cl, cu, lb, ub = (np.stack([p[i] for p in out]) for i in range(6))
    return c, np.zeros_like(c), A, cl, cu, lb, ub


def _farmer():
    names = jfarmer.scenario_names_creator(3)
    b = JBatch.from_problems(
        [jfarmer.scenario_creator(nm, num_scens=3) for nm in names])
    return b.c, b.q2, b.A, b.cl, b.cu, b.lb, b.ub


def _uc_lite(S=4):
    b, _ = build_batch(tuc_lite.scenario_names_creator(S),
                       tuc_lite.scenario_creator,
                       dict(UC_LITE_KW, num_scens=S))
    return b.c, b.q2, b.A_shared, b.cl, b.cu, b.lb, b.ub


def _uc(S=3):
    b, _ = build_batch(tuc.scenario_names_creator(S), tuc.scenario_creator,
                       dict(UC_KW, num_scens=S))
    return b.c, b.q2, b.A_shared, b.cl, b.cu, b.lb, b.ub


def _uc_sparse(A):
    j = JSparseA.from_dense(A, jnp.float64, structure=True, ell=True)
    t = tsparse.SparseA.from_dense(A, torch.float64, "cpu", structure=True)
    assert t.structure is not None
    return j, t


def _with_A(arrs, A):
    c, q2, _, cl, cu, lb, ub = arrs
    return c, q2, A, cl, cu, lb, ub


class _Pin:
    """Records, per core call, the blocks run (from the returned sweep
    count), the flag reads and the replays."""

    def __init__(self, monkeypatch, k_index, ce=4):
        self.calls = []
        real = device_loop.run

        def run(block, ops, state, bpr, max_blocks, key, phase):
            c0 = metrics.value("admm.loop_checks")
            r0 = metrics.value("device_loop.replays")
            out = real(block, ops, state, bpr, max_blocks, key, phase)
            self.calls.append((
                int(out[k_index]) // ce, bpr, max_blocks,
                metrics.value("admm.loop_checks") - c0,
                metrics.value("device_loop.replays") - r0))
            return out

        monkeypatch.setattr(device_loop, "run", run)

    def check(self):
        assert self.calls
        for blocks, L, max_blocks, checks, replays in self.calls:
            R = math.ceil(max_blocks / L)
            assert checks == max(1, math.ceil(blocks / L)), self.calls
            assert replays == min(checks + 1, R)
            # blocks past the stop: at most L - 1 in the replay that set
            # the flag, and L more in the one queued ahead; none past the
            # cap (the last replay holds the blocks left under it)
            assert min(replays * L, max_blocks) - blocks <= 2 * L - 1
        self.calls.clear()


@pytest.mark.parametrize("case", ["random_lp", "farmer"])
def test_dense_engine_loop_is_bitwise_across_L(case, monkeypatch):
    arrs = _random_lps() if case == "random_lp" else _farmer()
    # no polish: the loop's iterate itself is held (the polished duals of
    # a degenerate LP amplify last digits, test_torch_admm's 1e-7 case)
    kw = dict(max_iter=MAX_ITER, restarts=3, polish=False)
    jsol = jadmm.solve_batch(*arrs, settings=jadmm.ADMMSettings(
        use_pallas=False, **kw))
    pin = _Pin(monkeypatch, tadmm._IterState._fields.index("k"))
    sols = {}
    for L in LS:
        monkeypatch.setattr(tadmm, "BLOCKS_PER_REPLAY", L)
        sols[L] = tadmm.solve_batch(*arrs, settings=tadmm.ADMMSettings(**kw),
                                    device="cpu")
        pin.check()
        _bitwise(sols[L], sols[1])
    _near_reference(sols[1], jsol)


def test_dense_frozen_solve_stops_on_the_vote(monkeypatch):
    """A frozen solve whose eps vote stops it inside a replay: the blocks
    after it are gated, bitwise, and the reads are ceil(blocks / L)."""
    arrs = _random_lps(seed=3)
    kw = dict(max_iter=MAX_ITER, restarts=3, eps_abs=1e-6, eps_rel=1e-6,
              polish=False)
    jst = jadmm.ADMMSettings(use_pallas=False, **kw)
    jsol, jfac = jadmm.solve_batch_factored(*arrs, settings=jst)
    tsol, tfac = tadmm.solve_batch_factored(
        *arrs, settings=tadmm.ADMMSettings(**kw), device="cpu")
    q = arrs[0] + 0.05 * np.random.RandomState(1).randn(*arrs[0].shape)
    frozen = (q,) + arrs[1:]
    jf = jadmm.solve_batch_frozen(*frozen, jfac, settings=jst, warm=jsol.raw)
    pin = _Pin(monkeypatch, tadmm._IterState._fields.index("k"))
    sols = {}
    for L in LS:
        monkeypatch.setattr(tadmm, "BLOCKS_PER_REPLAY", L)
        sols[L] = tadmm.solve_batch_frozen(
            *frozen, tfac, settings=tadmm.ADMMSettings(**kw), warm=tsol.raw)
        pin.check()
        _bitwise(sols[L], sols[1])
    iters = int(sols[1].iters[0])
    assert 0 < iters < MAX_ITER and bool(sols[1].done.all())
    _near_reference(sols[1], jf)


def test_shared_engine_loop_is_bitwise_across_L(monkeypatch):
    arrs = _uc_lite()
    kw = dict(max_iter=MAX_ITER, restarts=4)
    jsol = jshared.solve_shared(*arrs, settings=jadmm.ADMMSettings(**kw))
    pin = _Pin(monkeypatch, tshared._IterState._fields.index("k"))
    sols = {}
    for L in LS:
        monkeypatch.setattr(tshared, "BLOCKS_PER_REPLAY", L)
        cuda_kernels.reset_counts()
        sols[L] = tshared.solve_shared(*arrs, settings=tadmm.ADMMSettings(
            **kw), device="cpu")
        assert cuda_kernels.plain_calls["fused_sweeps_shared"] > 0
        pin.check()
        _bitwise(sols[L], sols[1])
    _near_reference(sols[1], jsol)


def test_speculative_replays_change_nothing(monkeypatch):
    """The one-ahead replay: the replay queued before each flag read is
    gated when the flag says stop, so a frozen shared solve that stops on
    its eps vote inside a replay gives, at every L, bitwise the solve with
    its sweep cap set to the sweeps it ran (no block past the stop)."""
    rng = np.random.default_rng(0)
    S, m, n = 4, 8, 6
    A = rng.normal(size=(m, n))
    bnd = rng.normal(size=(S, n)) @ A.T
    arrs = (rng.normal(size=(S, n)), np.zeros((S, n)), A, bnd - 1.0,
            bnd + 1.0, np.full((S, n), -10.0), np.full((S, n), 10.0))
    kw = dict(max_iter=MAX_ITER, restarts=4, eps_abs=1e-6, eps_rel=1e-6)
    sol, fac = tshared.solve_shared_factored(
        *arrs, settings=tadmm.ADMMSettings(**kw), device="cpu")
    q = arrs[0] * 1.01
    pin = _Pin(monkeypatch, tshared._IterState._fields.index("k"))
    sols = {}
    for L in LS:
        monkeypatch.setattr(tshared, "BLOCKS_PER_REPLAY", L)
        sols[L] = tshared.solve_shared_frozen(
            q, *arrs[1:], fac, settings=tadmm.ADMMSettings(**kw),
            warm=sol.raw)
        pin.check()
        _bitwise(sols[L], sols[1])
    iters = int(sols[1].iters[0])
    assert 0 < iters < MAX_ITER and bool(sols[1].done.all())
    assert (iters // 4) % 8, "the stop should fall inside a replay of 8"
    monkeypatch.setattr(tshared, "BLOCKS_PER_REPLAY", 1)
    capped = tshared.solve_shared_frozen(
        q, *arrs[1:], fac, settings=tadmm.ADMMSettings(
            **dict(kw, max_iter=iters)), warm=sol.raw)
    for name in ("x", "z", "y", "yx", "pri_res", "dua_res", "iters"):
        assert torch.equal(getattr(capped, name), getattr(sols[8], name))


@pytest.mark.parametrize("L,stop_at,max_blocks", [
    (1, 5, 12), (3, 5, 12), (4, 7, 12), (8, 5, 12), (3, 11, 12),
    (5, 0, 12), (5, 11, 12), (8, 2, 12)])
def test_drive_reads_one_flag_a_replay_with_the_next_queued(L, stop_at,
                                                            max_blocks):
    """The protocol on a counting block: each block gets its own phase
    (the host's index of it), adds one to a counter until its vote sets
    the flag after block ``stop_at``, and changes nothing once it is set.
    The reads are ceil(blocks / L), the replays one more where the cap
    leaves room, the last replay only the blocks left under the cap, and
    the state is what stopping at once gives."""
    seen = []

    def block(ops, cur, phase):
        seen.append(phase)
        count, flag = cur
        count.add_(torch.where(flag != 0, 0, 1))
        device_loop.raise_flag(flag, count > stop_at)

    state = [torch.zeros((), dtype=torch.int64),
             torch.tensor(1 if stop_at == 0 else 0, dtype=torch.int32)]
    blocks = min(stop_at + 1, max_blocks) if stop_at else 0
    with metrics.window() as win:
        out = device_loop.run(block, (), state, L, max_blocks, key=None,
                              phase=lambda b: ("due" if b % 4 == 3 else "",
                                               b))
    assert int(out[0]) == blocks and int(out[1]) == 1
    assert int(state[0]) == 0          # the initial state is not written
    reads = max(1, math.ceil(blocks / L))
    replays = min(reads + 1, math.ceil(max_blocks / L))
    assert win.delta("admm.loop_checks") == reads
    assert win.delta("device_loop.replays") == replays
    run = min(replays * L, max_blocks)
    assert win.delta("device_loop.blocks") == run
    assert seen == [("due" if b % 4 == 3 else "", b) for b in range(run)]


def test_sparse_engine_loop_is_bitwise_across_L(monkeypatch):
    """uc at 10 generators on its structured SparseA, with the plateau exit
    on (the repo's UC settings): adaptive and frozen solves."""
    arrs = _uc()
    jA, tA = _uc_sparse(arrs[2])
    kw = dict(max_iter=MAX_ITER, restarts=2, solve_refine=1,
              sweep_plateau_rtol=0.05, sweep_plateau_window=8)
    jst = jadmm.ADMMSettings(**kw)
    q2 = np.full_like(arrs[0], 0.5)
    jsol, jfac = jshared.solve_shared_factored(
        *_with_A(arrs, jA)[:1], q2, *_with_A(arrs, jA)[2:], settings=jst)
    q = arrs[0] * 1.01
    jf = jshared.solve_shared_frozen(q, q2, *_with_A(arrs, jA)[2:], jfac,
                                     settings=jst, warm=jsol.raw)
    pin = _Pin(monkeypatch, tshared._IterState._fields.index("k"))
    sols = {}
    for L in LS:
        monkeypatch.setattr(tshared, "SPARSE_BLOCKS_PER_REPLAY", L)
        cuda_kernels.reset_counts()
        tsol, tfac = tshared.solve_shared_factored(
            arrs[0], q2, *_with_A(arrs, tA)[2:],
            settings=tadmm.ADMMSettings(**kw), device="cpu")
        tf = tshared.solve_shared_frozen(
            q, q2, *_with_A(arrs, tA)[2:], tfac,
            settings=tadmm.ADMMSettings(**kw), warm=tsol.raw)
        assert cuda_kernels.plain_calls["fused_sweeps_sparse"] > 0
        assert cuda_kernels.plain_calls["fused_sweeps_shared"] == 0
        pin.check()
        sols[L] = (tsol, tf)
        _bitwise(tsol, sols[1][0])
        _bitwise(tf, sols[1][1])
    _near_reference(sols[1][0], jsol)
    _near_reference(sols[1][1], jf)


def test_plateau_exit_inside_a_replay(monkeypatch):
    """A frozen uc solve that leaves on the plateau vote (two stalled
    windows, before the cap, not converged), in the middle of a replay:
    the same sweep count at every L, and the reference's."""
    arrs = _uc()
    jA, tA = _uc_sparse(arrs[2])
    kw = dict(max_iter=2000, restarts=2, solve_refine=1, eps_abs=1e-9,
              eps_rel=1e-9, sweep_plateau_rtol=0.05, sweep_plateau_window=8)
    jst = jadmm.ADMMSettings(**kw)
    jsol, jfac = jshared.solve_shared_factored(*_with_A(arrs, jA),
                                               settings=jst)
    tsol, tfac = tshared.solve_shared_factored(
        *_with_A(arrs, tA), settings=tadmm.ADMMSettings(**kw), device="cpu")
    q = arrs[0] * 0.97
    frozen_j = (q,) + _with_A(arrs, jA)[1:]
    frozen_t = (q,) + _with_A(arrs, tA)[1:]
    jf = jshared.solve_shared_frozen(*frozen_j, jfac, settings=jst,
                                     warm=jsol.raw)
    sols = {}
    for L in LS:
        monkeypatch.setattr(tshared, "SPARSE_BLOCKS_PER_REPLAY", L)
        sols[L] = tshared.solve_shared_frozen(
            *frozen_t, tfac, settings=tadmm.ADMMSettings(**kw),
            warm=tsol.raw)
        _bitwise(sols[L], sols[1])
    iters = int(sols[1].iters[0])
    assert iters < kw["max_iter"] and not bool(sols[1].done.all())
    assert (iters // 4) % 3, "the exit should fall inside a replay of 3"
    _near_reference(sols[1], jf)


def test_divergence_guard_in_the_loop(monkeypatch):
    """Twin of test_torch_shared's divergence case across L: LP-refresh
    factors reused with a large prox q2 make the refinement diverge; the
    guard freezes the same scenarios (INF residuals, never NaN) at every L
    and as the reference does."""
    rng = np.random.default_rng(0)
    S, m, n = 4, 8, 6
    A = rng.normal(size=(m, n))
    c = rng.normal(size=(S, n))
    b = rng.normal(size=(S, m))
    arrs = (c, np.zeros((S, n)), A, b - 1.0, b + 1.0,
            np.full((S, n), -100.0), np.full((S, n), 100.0))
    kw = dict(max_iter=302, restarts=3, polish=False)
    jsol, jfac = jshared.solve_shared_factored(
        *arrs, settings=jadmm.ADMMSettings(**kw))
    tsol, tfac = tshared.solve_shared_factored(
        *arrs, settings=tadmm.ADMMSettings(**kw), device="cpu")
    big = (c, np.full((S, n), 50.0)) + arrs[2:]
    jf = jshared.solve_shared_frozen(*big, jfac, settings=jadmm.ADMMSettings(
        **kw), warm=jsol.raw)
    sols = {}
    for L in LS:
        monkeypatch.setattr(tshared, "BLOCKS_PER_REPLAY", L)
        sols[L] = tshared.solve_shared_frozen(
            *big, tfac, settings=tadmm.ADMMSettings(**kw), warm=tsol.raw)
        _bitwise(sols[L], sols[1])
    pri = sols[1].pri_res.numpy()
    assert np.isinf(pri).any() and not np.isnan(pri).any()
    np.testing.assert_array_equal(np.isinf(pri),
                                  np.isinf(np.asarray(jf.pri_res)))


def _after_124_sweeps(rho=100.0):
    """uc_lite (an LP), Ruiz-scaled, after 124 sweeps at a penalty far too
    high (its primal residual at rounding, its dual one not): the next
    block falls on the gamma cadence, where gamma then moves."""
    st = tadmm.ADMMSettings()
    c, q2, A, cl, cu, lb, ub, _ = tshared._prep_shared(*_uc_lite(), st,
                                                        "cpu")
    D, E = tshared._ruiz_shared(A, q2.mean(dim=0), st.scaling_iters)
    cost = 1.0 / torch.clamp(tshared._median(
        (c * D[None, :]).abs().amax(dim=1)), min=1e-8)
    q, q2s, As, cls, cus, lbs, ubs, _ = tshared._scale_shared(
        c, q2, A, cl, cu, lb, ub, D, E, cost, None)
    S, n = q.shape
    rho_a = torch.full((As.shape[0],), rho, dtype=torch.float64)
    rho_x = torch.full((n,), rho, dtype=torch.float64)
    q2ref = q2s.mean(dim=0)
    Kinv, K, _ = tshared._factor_shared(q2ref, As, rho_a, rho_x, st.sigma)
    args = (q, q2s, q2ref, As, cls, cus, lbs, ubs)
    one = torch.ones((), dtype=torch.float64)
    s = tshared._core(*args, tshared._start(None, cls, cus, lbs, ubs,
                                            torch.ones(S, dtype=q.dtype)),
                      Kinv, K, rho_a, rho_x, one, one,
                      tadmm.ADMMSettings(max_iter=124))
    assert int(s.k) == 124
    return args, s, (Kinv, K, rho_a, rho_x)


def test_gamma_move_resets_the_plateau(monkeypatch):
    """At a block where both the gamma cadence (k + 4 a multiple of 128)
    and the plateau window fall, with one stalled window behind it and no
    improvement, the plateau vote would stop the loop; a gamma move gives
    it a fresh grace instead (best inf, stall 0), on the device.  The
    block runs once, in the phase the loop gives block 31 (the one ending
    at k = 128)."""
    args, s, fac = _after_124_sweeps()
    s = s._replace(stall=torch.tensor(1),
                   best=torch.tensor(1e-3, dtype=torch.float64))
    st = tadmm.ADMMSettings(max_iter=128, sweep_plateau_rtol=0.05,
                            sweep_plateau_window=8)

    def one_block(block, ops, state, L, max_blocks, key, phase):
        assert phase(31) == (True, True) and phase(30) == (False, False)
        work = [t.clone() for t in state]
        block(ops, work, phase(31))
        return work

    monkeypatch.setattr(device_loop, "run", one_block)

    def block(glo, ghi):
        return tshared._core(*args, s, *fac,
                             torch.tensor(glo, dtype=torch.float64),
                             torch.tensor(ghi, dtype=torch.float64), st)

    moved = block(1e-4, 1e4)
    assert int(moved.k) == 128
    assert not torch.equal(moved.gamma, s.gamma)
    assert int(moved.stall) == 0 and torch.isinf(moved.best)
    # gamma pinned at 1 by its bounds: no move, so the second stall counts
    pinned = block(1.0, 1.0)
    assert torch.equal(pinned.gamma, s.gamma)
    assert int(pinned.stall) == 2 and float(pinned.best) == 1e-3
    for a, b in zip(pinned[:5], moved[:5]):
        assert torch.equal(a, b)   # the same sweeps; only the rule differs


def test_cadences_are_the_references_sweep_counts():
    """The host's phases are the reference's device tests at the block's
    sweep count k = 4 b: gamma due where (k + 4) // 4 is a multiple of 32,
    the plateau where (k // 4 + 1) is a multiple of the window in blocks
    and k >= min_k."""
    st = tadmm.ADMMSettings(sweep_plateau_rtol=0.05, sweep_plateau_window=8)
    for b in range(300):
        k = 4 * b
        assert tshared.gamma_due(b, st) == ((k + 4) // 4 % 32 == 0)
        for min_k in (0, 128):
            assert tadmm.plateau_due(b, st, min_k) == (
                (k // 4 + 1) % 2 == 0 and k >= min_k)
    assert not tadmm.plateau_due(1, tadmm.ADMMSettings())


def test_gated_plain_versions_return_their_inputs():
    """Each plain version with the stop flag set returns its inputs (what
    the kernel's gate leaves the loop's commit to keep)."""
    g = torch.Generator().manual_seed(0)
    S, m, n = 3, 4, 5

    def r(*shape):
        return torch.randn(*shape, generator=g, dtype=torch.float64)

    A = r(S, m, n)
    K = torch.eye(n, dtype=torch.float64).expand(S, n, n) * 2.0
    state = (r(S, n), r(S, m), r(S, n), r(S, m), r(S, n), r(S, m))
    common = (r(S, n), A, K / 4, K, -r(S, m).abs(), r(S, m).abs(),
              -torch.ones(S, n, dtype=torch.float64),
              torch.ones(S, n, dtype=torch.float64),
              torch.ones(S, m, dtype=torch.float64),
              torch.ones(S, n, dtype=torch.float64))
    for flag, same in ((1, True), (0, False)):
        stop = torch.tensor(flag, dtype=torch.int32)
        out = cuda_kernels.fused_sweeps_plain(*common, *state, 4, 2, 1e-6,
                                              1.6, stop=stop)
        assert all(torch.equal(o, i) for o, i in zip(out, state)) == same
    A2 = A[0]
    vec = (r(S, n), A2, torch.eye(n, dtype=torch.float64) / 2,
           torch.eye(n, dtype=torch.float64) * 2, -r(S, m).abs(),
           r(S, m).abs(), -torch.ones(S, n, dtype=torch.float64),
           torch.ones(S, n, dtype=torch.float64),
           torch.ones(1, m, dtype=torch.float64),
           torch.ones(1, n, dtype=torch.float64),
           torch.zeros(S, n, dtype=torch.float64),
           torch.zeros(1, 1, dtype=torch.float64),
           torch.ones(S, 1, dtype=torch.float64))
    ell = tsparse.dense_ell(A2)
    stop = torch.tensor(1, dtype=torch.int32)
    out = cuda_kernels.fused_sweeps_shared_plain(*vec, *state, 4, 2, 2,
                                                 1e-6, 1.6, stop=stop)
    assert all(torch.equal(o, i) for o, i in zip(out, state))
    out = cuda_kernels.fused_sweeps_sparse_plain(
        vec[0], *ell, vec[2], torch.full((1, n), 2.0, dtype=torch.float64),
        *vec[4:], *state, 4, 1, 2, 1e-6, 1.6, stop=stop)
    assert all(torch.equal(o, i) for o, i in zip(out, state))


def test_graph_buffers_rebuild_the_operands():
    """What a captured graph reads of the sparse engine's operands: the
    values of a SparseA and of a KernelWoodbury (its BlockWoodbury's too)
    go into buffers, their index arrays and pattern are kept; two
    factorizations of one structure key the same graph, and the operands
    rebuilt around copies of their values apply as the originals do."""
    from tpusppy_torch.solvers.structured_kkt import kinv_apply, layout_apply

    arrs = _uc()
    _, A = _uc_sparse(arrs[2])
    facs = []
    for rho in (1.0, 3.0):
        q2 = np.full_like(arrs[0], rho)
        _, fac = tshared.solve_shared_factored(
            torch.as_tensor(arrs[0]), torch.as_tensor(q2), A,
            *(torch.as_tensor(v) for v in arrs[3:]),
            settings=tadmm.ADMMSettings(max_iter=8, restarts=1))
        facs.append(fac)
    As = [A.scale(f.E, f.D) for f in facs]
    ops = [(As[i], facs[i].Kinv_op, facs[i].rho_a) for i in range(2)]
    assert device_loop._skeleton(ops[0]) == device_loop._skeleton(ops[1])
    vals = device_loop._values(ops[0])
    assert all(t.is_floating_point() for t in vals)
    bufs = [t.clone() for t in vals]
    rebuilt = device_loop._rebuild(ops[0], iter(bufs))
    for got, want in zip(device_loop._values(rebuilt), bufs):
        assert got is want
    x = torch.randn(3, A.shape[1], dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    assert torch.equal(rebuilt[0].matvec(x), As[0].matvec(x))
    assert torch.equal(rebuilt[0].rmatvec(x @ As[0].todense().T),
                       As[0].rmatvec(x @ As[0].todense().T))
    assert torch.equal(layout_apply(rebuilt[1], x),
                       layout_apply(facs[0].Kinv_op, x))
    assert torch.equal(kinv_apply(rebuilt[1].bw, x),
                       kinv_apply(facs[0].Kinv_op.bw, x))
    # the pattern (index arrays, sizes) is the factors' own, not copied
    for a, b in zip(rebuilt[1].pattern, facs[0].Kinv_op.pattern):
        assert a is b if isinstance(a, torch.Tensor) else a == b
    # the second factorization's values, copied in, give its operator
    for buf, t in zip(bufs, device_loop._values(ops[1])):
        buf.copy_(t)
    assert torch.equal(layout_apply(rebuilt[1], x),
                       layout_apply(facs[1].Kinv_op, x))
    assert torch.equal(rebuilt[0].matvec(x), As[1].matvec(x))


# ---- on the card -----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA graph and kernels have "
                    "no CPU mode")


def _to(arrs, dtype=torch.float64):
    return tuple(torch.as_tensor(np.asarray(v), dtype=dtype, device="cuda")
                 for v in arrs)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["dense", "shared", "sparse"])
def test_cuda_graph_loop_matches_one_block_replays(engine, monkeypatch):
    """On the card: L=1 against the engine's L, identical sweep counts and
    f64 solutions to 1e-12, and kernel launches counted by replay: blocks
    run (gated ones included) plus the warm-up blocks of the captures."""
    _cuda()
    if engine == "dense":
        arrs, mod, attr = _to(_random_lps()), tadmm, "BLOCKS_PER_REPLAY"
        name = "fused_sweeps"
        solve = tadmm.solve_batch
    elif engine == "shared":
        arrs, mod, attr = _to(_uc_lite()), tshared, "BLOCKS_PER_REPLAY"
        name = "fused_sweeps_shared"
        solve = tshared.solve_shared
    else:
        a = _uc()
        sp = tsparse.SparseA.from_dense(a[2], torch.float64, "cuda",
                                        structure=True)
        arrs = _with_A(_to(a), sp)
        mod, attr = tshared, "SPARSE_BLOCKS_PER_REPLAY"
        name = "fused_sweeps_sparse"
        solve = tshared.solve_shared
    st = tadmm.ADMMSettings(max_iter=MAX_ITER, restarts=2)
    sols = {}
    for L in (1, getattr(mod, attr), 8):
        monkeypatch.setattr(mod, attr, L)
        device_loop._cache.clear()
        cuda_kernels.reset_counts()
        with metrics.window() as win:
            sols[L] = solve(*arrs, settings=st)
            torch.cuda.synchronize()
        blocks = win.delta("device_loop.blocks")
        assert cuda_kernels.launches[name] == blocks + win.delta(
            "device_loop.warmups")
        assert cuda_kernels.plain_calls[name] == 0
        assert int(sols[L].iters[0]) == int(sols[1].iters[0])
        for u, v in zip(_fields(sols[L]), _fields(sols[1])):
            _close(u.cpu(), v.cpu(), 1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["shared", "sparse"])
def test_cuda_graph_takes_new_factors_between_solves(engine):
    """Two frozen solves on one captured graph with different factors: the
    second matches a fresh capture bitwise (the graphs read their inputs
    from buffers refilled at each call, the structured operator's values
    and the dense kernel's packed operand among them), and captures
    nothing."""
    _cuda()
    if engine == "shared":
        arrs = _to(_uc_lite())
    else:
        a = _uc()
        arrs = _with_A(_to(a), tsparse.SparseA.from_dense(
            a[2], torch.float64, "cuda", structure=True))
    st = tadmm.ADMMSettings(max_iter=200, restarts=2)
    q2a = torch.full_like(arrs[0], 0.5)
    q2b = torch.full_like(arrs[0], 2.0)
    sol_a, fac_a = tshared.solve_shared_factored(arrs[0], q2a, *arrs[2:],
                                                 settings=st)
    sol_b, fac_b = tshared.solve_shared_factored(arrs[0], q2b, *arrs[2:],
                                                 settings=st)
    device_loop._cache.clear()
    tshared.solve_shared_frozen(arrs[0], q2a, *arrs[2:], fac_a, settings=st,
                                warm=sol_a.raw)
    c0 = metrics.value("device_loop.captures")
    swapped = tshared.solve_shared_frozen(arrs[0], q2b, *arrs[2:], fac_b,
                                          settings=st, warm=sol_b.raw)
    assert metrics.value("device_loop.captures") == c0
    device_loop._cache.clear()
    fresh = tshared.solve_shared_frozen(arrs[0], q2b, *arrs[2:], fac_b,
                                        settings=st, warm=sol_b.raw)
    _bitwise(swapped, fresh)
