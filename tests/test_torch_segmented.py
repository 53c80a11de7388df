"""The port's frozen-continuation protocol (tpusppy_torch.solvers.segmented):
the reference's host-protocol cases (tests/test_segmented.py,
tests/test_pipeline.py) against the port's ``continue_frozen``, with the
same scripted fake segments; the segmented entry points (one dispatch a
solve) and the continuation on real solves (the port's dense and shared-A
engines, float64 on the CPU) segmented at a sweep cap, pipelined against
serial: identical results, the reference's continuation on the same
inputs to 1e-9.
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpusppy.solvers import admm as jadmm
from tpusppy.solvers import segmented as jsegmented
from tpusppy_torch.obs import metrics
from tpusppy_torch.solvers import admm, segmented, shared_admm
from tpusppy_torch.solvers.admm import ADMMSettings

torch.set_num_threads(1)


class FakeSol:
    def __init__(self, pri, dua=0.0, iters=52, raw=None):
        self.pri_res = np.asarray([pri])
        self.dua_res = np.asarray([dua])
        self.iters = np.asarray([iters])
        self.raw = raw or ("x",)


def _run(script, pipeline=False, seg_f=52, budget=520, plateau=0.05,
         sol0=None, **kw):
    """``script``: what successive segments return.  Returns the solution
    and the number of segments dispatched."""
    calls = []

    def run_segment(warm):
        calls.append(warm)
        return script[min(len(calls) - 1, len(script) - 1)]

    sol = segmented.continue_frozen(
        run_segment, sol0 or FakeSol(1.0), seg_f, budget,
        plateau_rtol=plateau, pipeline=pipeline, **kw)
    return sol, len(calls)


# ---- tests/test_segmented.py ------------------------------------------------

def test_budget_exhaustion():
    sols = [FakeSol(1.0 / (k + 2)) for k in range(20)]  # keeps improving
    _, n = _run(sols, seg_f=52, budget=520, plateau=0.05)
    assert n == 10          # 520 / 52: no early exit while improving >=5%


def test_converged_early_exit():
    # the second segment's loop exits before its cap: all done
    sols = [FakeSol(0.5), FakeSol(1e-9, iters=4)]
    _, n = _run(sols)
    assert n == 2


def test_plateau_two_strike_grace():
    # parked at the floor from the start: the seeded best and two
    # non-improving segments give exactly two dispatches
    sols = [FakeSol(0.05)] * 20
    _, n = _run(sols, sol0=FakeSol(0.05))
    assert n == 2


def test_transient_uptick_does_not_abort():
    # an improving trend with one wobble: the single strike is forgiven
    sols = [FakeSol(0.5), FakeSol(0.51), FakeSol(0.3), FakeSol(0.1),
            FakeSol(0.1), FakeSol(0.1)]
    # budget for 10 segments, so 6 can only come from the plateau break
    _, n = _run(sols, budget=52 * 10)
    assert n == 6


def test_plateau_disabled_runs_full_budget():
    sols = [FakeSol(0.05)] * 10
    _, n = _run(sols, plateau=None, budget=52 * 7)
    assert n == 7


def test_speculative_waste_bounded_and_billed():
    """The budget is charged at dispatch: a speculating continuation never
    dispatches more segments than the serial worst case (budget // seg_f);
    on an early stop the waste is ``overlap`` (1) segment, billed."""
    never_done = [FakeSol(1.0 / (k + 2)) for k in range(20)]
    _, n = _run(never_done, pipeline=True)
    assert n == 10            # the serial worst case (520 // 52)
    early = [FakeSol(0.5), FakeSol(1e-9, iters=4), FakeSol(0.9)]
    with metrics.window() as win:
        sol, n = _run(early, pipeline=True, seg_flops=1000.0)
    assert n == 3 and sol is early[1]
    assert win.delta("speculation.discarded_segments") == 1
    assert win.delta("speculation.discarded_flops") == 1000.0
    assert win.delta("dispatch.segments") == 3
    assert win.delta("dispatch.flops") == 3000.0


# ---- tests/test_pipeline.py -------------------------------------------------

def test_pipelined_stop_parity_and_discard():
    """Stop at segment 2: serial dispatches 2 segments; pipelined
    dispatches 3 (one speculative, discarded) and returns the SAME
    solution object."""
    sols = [FakeSol(0.5), FakeSol(1e-9, iters=4), FakeSol(0.7)]
    s_serial, n_serial = _run(sols, pipeline=False)
    s_pipe, n_pipe = _run(sols, pipeline=True)
    assert n_serial == 2 and n_pipe == 3
    assert s_serial is sols[1] and s_pipe is sols[1]


def test_pipelined_budget_billed_at_dispatch():
    sols = [FakeSol(1.0 / (k + 2)) for k in range(20)]   # keeps improving
    s_serial, n_serial = _run(sols, pipeline=False)
    s_pipe, n_pipe = _run(sols, pipeline=True)
    assert n_serial == 10 and n_pipe == 10      # 520 / 52, both protocols
    assert s_serial is s_pipe


def test_pipelined_plateau_parity():
    """The two-strike plateau grace fires on the same segment; pipelined
    pays exactly one extra (discarded) dispatch."""
    sols = [FakeSol(0.5), FakeSol(0.51), FakeSol(0.3), FakeSol(0.1),
            FakeSol(0.1), FakeSol(0.1), FakeSol(0.1)]
    s_serial, n_serial = _run(sols, pipeline=False, budget=52 * 10)
    s_pipe, n_pipe = _run(sols, pipeline=True, budget=52 * 10)
    assert n_serial == 6
    assert n_pipe == 7
    assert s_serial is s_pipe


def test_pipelined_check_incoming_reads_verdict_first():
    """check_incoming and a done incoming solution: neither protocol
    dispatches; a live continuation then speculates normally."""
    done0 = FakeSol(1e-9, iters=4)
    sols = [FakeSol(0.5)]
    sol, n = _run(sols, pipeline=True, sol0=done0, check_incoming=True)
    assert sol is done0 and n == 0
    sol, n = _run(sols, pipeline=False, sol0=done0, check_incoming=True)
    assert sol is done0 and n == 0
    live = [FakeSol(1e-9, iters=4), FakeSol(0.9)]
    sol, n = _run(live, pipeline=True, sol0=FakeSol(1.0),
                  check_incoming=True)
    assert sol is live[0] and n == 2


def test_caller_all_done_never_speculates():
    sols = [FakeSol(0.5) for _ in range(10)]
    seen = []

    def run_segment(warm):
        seen.append(warm)
        return sols[len(seen) - 1]

    segmented.continue_frozen(
        run_segment, FakeSol(1.0), 52, 52 * 3,
        all_done=lambda s: len(seen) >= 2, plateau_rtol=None,
        pipeline=True)
    assert len(seen) == 2


# ---- the entry points on real solves ----------------------------------------

def _toy_dense(S=3, n=6, m=4, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(S, m, n))
    x0 = rng.normal(size=(S, n))
    b = np.einsum("smn,sn->sm", A, x0)
    c = rng.normal(size=(S, n))
    return (c, np.zeros((S, n)), A, b - 1.0, b + 1.0,
            np.full((S, n), -10.0), np.full((S, n), 10.0))


def _toy_shared(S=4, m=8, n=6, seed=1):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    b = rng.normal(size=(S, n)) @ A.T
    c = rng.normal(size=(S, n))
    return (c, np.zeros((S, n)), A, b - 1.0, b + 1.0,
            np.full((S, n), -10.0), np.full((S, n), 10.0))


def _cpu(args):
    return tuple(torch.as_tensor(a) for a in args)


def _engine(engine):
    """(args, (frozen, factored), the reference's (frozen, factored))."""
    if engine == "dense":
        return (_toy_dense(),
                (admm.solve_batch_frozen, admm.solve_batch_factored),
                (jadmm.solve_batch_frozen, jadmm.solve_batch_factored))
    from tpusppy.solvers import shared_admm as jshared
    return (_toy_shared(),
            (shared_admm.solve_shared_frozen,
             shared_admm.solve_shared_factored),
            (jshared.solve_shared_frozen, jshared.solve_shared_factored))


@pytest.mark.parametrize("engine", ["dense", "shared"])
def test_one_dispatch_without_a_cap(engine):
    """The segmented entry points run a frozen or adaptive solve as one
    dispatch of the engine, nothing segmented (the H100 dispatch budgets
    wait for the megastep)."""
    args, fns, _ = _engine(engine)
    args = _cpu(args)
    st = ADMMSettings(max_iter=64, restarts=2, polish=False)
    with metrics.window() as win:
        sol, factors, conv = segmented.solve_factored_segmented(
            fns[0], fns[1], args, st, shared=engine == "shared",
            want_converged=False)
        frozen, conv2 = segmented.solve_frozen_segmented(
            fns[0], args, factors, st, warm=sol.raw)
    assert conv is None and conv2 == bool(frozen.done.all())
    assert win.delta("dispatch.segments") == 0
    direct = fns[0](*args, factors, settings=st, warm=sol.raw)
    for a, b in zip((frozen.x, frozen.iters), (direct.x, direct.iters)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("engine", ["dense", "shared"])
def test_capped_continuation_pipelined_equals_serial(engine):
    """A frozen solve segmented at a cap of 8 sweeps (two check blocks),
    as the reference's segmented regime runs it: a first capped dispatch,
    then the continuation with ``check_incoming``.  The pipelined and
    serial continuations give identical results, and the reference's
    ``_continue_frozen`` on the same inputs the same to 1e-9."""
    args, fns, jfns = _engine(engine)
    st = ADMMSettings(max_iter=64, restarts=2, polish=False)
    jst = jadmm.ADMMSettings(max_iter=64, restarts=2, polish=False,
                             use_pallas=False)
    seg_f = 8
    st_f = dataclasses.replace(st, max_iter=seg_f)
    jst_f = dataclasses.replace(jst, max_iter=seg_f)
    sol, factors = fns[1](*_cpu(args), settings=st)
    jsol, jfac = jfns[1](*args, settings=jst)
    jargs2 = (args[0] + 0.05 * np.abs(args[0]),) + args[1:]
    args2 = _cpu(jargs2)
    first = fns[0](*args2, factors, settings=st_f, warm=sol.raw)
    out = {}
    for pipeline in (True, False):
        with metrics.window() as win:
            out[pipeline] = segmented._continue_frozen(
                fns[0], args2, factors, first, st_f, seg_f,
                st.max_iter - seg_f, pipeline=pipeline, check_incoming=True)
        assert win.delta("dispatch.segments") >= 1
    sol_p, sol_s = out[True], out[False]
    for a, b in zip((sol_p.x, sol_p.pri_res, sol_p.dua_res, sol_p.iters),
                    (sol_s.x, sol_s.pri_res, sol_s.dua_res, sol_s.iters)):
        assert torch.equal(a, b)
    jfirst = jfns[0](*jargs2, jfac, settings=jst_f, warm=jsol.raw)
    jsol_f = jsegmented._continue_frozen(
        jfns[0], jargs2, jfac, jfirst, jst_f, seg_f, jst.max_iter - seg_f,
        pipeline=True, check_incoming=True)
    assert bool(sol_p.done.all()) == bool(np.asarray(jsol_f.done).all())
    assert int(sol_p.iters[0]) == int(np.asarray(jsol_f.iters)[0])
    np.testing.assert_allclose(sol_p.x.numpy(), np.asarray(jsol_f.x),
                               rtol=0, atol=1e-9 * max(
                                   1.0, float(np.abs(jsol_f.x).max())))
