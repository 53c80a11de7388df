"""The port's shared-A engine (tpusppy_torch.solvers.shared_admm) against the
reference's, on uc_lite, the family whose scenarios share one constraint
matrix.

Both packages run in float64 on the CPU on the same inputs (uc_lite's own
seeded scenarios, or arrays made from a seed with numpy).  Tolerances:

- batch fields, the kernel's plain version and the 2-D dual objective:
  exact or 1e-10;
- shared solves (adaptive, factored, frozen) and a carried PH state: 1e-9
  relative to the largest entry (floored at 1), since only the summation
  order of the matvecs and the Cholesky inverse differ;
- PH trajectories (W, xbar, eobj per iteration): 1e-7, as the dense
  engine's (tests/test_torch_ph.py).
"""

import dataclasses

import numpy as np
import pytest
import torch

from tpusppy.extensions.extension import Extension as JExtension
from tpusppy.ir import ScenarioBatch as JBatch
from tpusppy.models import uc_lite as juc
from tpusppy.opt.ph import PH as JPH
from tpusppy.phbase import PHBase as JPHBase
from tpusppy.solvers import admm as jadmm
from tpusppy.solvers import shared_admm as jshared
from tpusppy.solvers.admm import ADMMSettings as JSettings
from tpusppy_torch import convert
from tpusppy_torch.ef import solve_ef
from tpusppy_torch.extensions.extension import Extension as TExtension
from tpusppy_torch.ir import ScenarioBatch
from tpusppy_torch.models import farmer as tfarmer
from tpusppy_torch.models import uc_lite as tuc
from tpusppy_torch.opt.ph import PH as TPH
from tpusppy_torch.phbase import PHBase as TPHBase
from tpusppy_torch.solvers import admm as tadmm
from tpusppy_torch.solvers import cuda_kernels
from tpusppy_torch.solvers import shared_admm as tshared
from tpusppy_torch.solvers.admm import ADMMSettings as TSettings
from tpusppy_torch.spbase import build_batch, make_admm_settings
from tpusppy_torch.spopt import SPOpt

torch.set_num_threads(1)

UC_KW = {"num_gens": 3, "horizon": 5, "relax_integers": True}
SETTINGS = dict(max_iter=400, restarts=4)
PH_OPTIONS = {"defaultPHrho": 10.0, "convthresh": 1e-6,
              "solver_options": {"megastep": 1}}


def _close(got, ref, tol, what=""):
    got = np.asarray(got, dtype=float)
    ref = np.asarray(ref, dtype=float)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.max(np.abs(ref))) if ref.size else 1.0)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} * {scale:.3g}"


def _batches(S=4, **kw):
    kw = dict(UC_KW, **kw)
    names = juc.scenario_names_creator(S)
    jb = JBatch.from_problems(
        [juc.scenario_creator(nm, num_scens=S, **kw) for nm in names])
    tb, _ = build_batch(names, tuc.scenario_creator, dict(kw, num_scens=S))
    return jb, tb


def _arrays(b, q=None, q2=None):
    return (b.c if q is None else q, b.q2 if q2 is None else q2,
            b.A_shared, b.cl, b.cu, b.lb, b.ub)


def _same_solution(tsol, jsol, tol=1e-9):
    for name in ("x", "z", "y", "yx", "pri_res", "dua_res"):
        _close(getattr(tsol, name), getattr(jsol, name), tol, name)
    assert np.array_equal(np.asarray(tsol.done), np.asarray(jsol.done))
    assert int(tsol.iters[0]) == int(np.asarray(jsol.iters)[0])


def test_shared_detection():
    jb, tb = _batches(4)
    assert tb.A_shared is not None
    assert tb.A_shared.shape == (tb.num_rows, tb.num_vars)
    np.testing.assert_array_equal(tb.A_shared, jb.A_shared)
    # .A is a zero-copy per-scenario view for host code
    assert tb.A.shape == (4, tb.num_rows, tb.num_vars)
    assert np.shares_memory(tb.A, tb.A_shared)
    assert np.array_equal(tb.A[2], tb.A_shared)
    # scenarios still differ where they should (balance rhs)
    assert not np.array_equal(tb.cl[0], tb.cl[1])
    for f in ("c", "q2", "cl", "cu", "lb", "ub", "const"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))


def test_shared_not_detected_when_A_differs():
    tb, _ = build_batch(tfarmer.scenario_names_creator(3),
                        tfarmer.scenario_creator, {"num_scens": 3})
    assert tb.A_shared is None      # yields enter A: per-scenario
    assert tb.A.flags.writeable and tb.A.shape == (3, tb.num_rows,
                                                   tb.num_vars)


def test_solve_shared_matches_reference():
    jb, tb = _batches(5)
    jsol = jshared.solve_shared(*_arrays(jb), settings=JSettings(**SETTINGS))
    tsol = tshared.solve_shared(*_arrays(tb), settings=TSettings(**SETTINGS),
                                device="cpu")
    _same_solution(tsol, jsol)


def _prox_q2(b, rho=10.0):
    q2 = b.q2.copy()
    q2[:, b.tree.nonant_indices] += rho
    return q2


def test_factored_and_frozen_match_reference():
    """A PH-like sequence: an adaptive factored solve on the prox QP, then
    frozen solves on moved linear terms, warm-started from the raw iterate.
    The factored solve's gamma moves off 1 for some scenarios, so the
    frozen solves run the dq2 refinement with the extra passes armed."""
    jb, tb = _batches(5)
    q2 = _prox_q2(tb)
    jsol, jfac = jshared.solve_shared_factored(
        *_arrays(jb, q2=q2), settings=JSettings(**SETTINGS))
    tsol, tfac = tshared.solve_shared_factored(
        *_arrays(tb, q2=q2), settings=TSettings(**SETTINGS), device="cpu")
    _same_solution(tsol, jsol)
    for name in jshared.SharedFactors._fields:
        _close(getattr(tfac, name), getattr(jfac, name), 1e-9, name)
    # the dense engine's sweep operand is its explicit inverse itself
    assert tfac.Kinv_op is tfac.Kinv
    assert not np.allclose(np.asarray(tfac.gamma), 1.0)
    rng = np.random.RandomState(0)
    idx = tb.tree.nonant_indices
    jw, tw = jsol.raw, tsol.raw
    for step in range(2):
        q = tb.c.copy()
        q[:, idx] += 5.0 * rng.randn(tb.num_scenarios, idx.size)
        jsol = jshared.solve_shared_frozen(
            *_arrays(jb, q=q, q2=q2), jfac, settings=JSettings(**SETTINGS),
            warm=jw)
        tsol = tshared.solve_shared_frozen(
            *_arrays(tb, q=q, q2=q2), tfac, settings=TSettings(**SETTINGS),
            warm=tw)
        _same_solution(tsol, jsol)
        jw, tw = jsol.raw, tsol.raw


def _lp_family(seed=0, S=4, m=8, n=6):
    """tests/test_shared_admm.py's random LP family."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    c = rng.normal(size=(S, n))
    q2 = np.zeros((S, n))
    b = rng.normal(size=(S, m))
    return (c, q2, A, b - 1.0, b + 1.0,
            np.full((S, n), -100.0), np.full((S, n), 100.0))


def test_frozen_dq2_divergence_is_guarded():
    """Twin of tests/test_shared_admm.py::
    test_frozen_dq2_divergence_is_guarded: LP-refresh factors reused with a
    large prox q2 make the shared-K refinement non-contractive.  The guard
    freezes the exploding scenarios at their last finite iterate with INF
    residuals (never NaN) and done False, on the same scenarios as the
    reference."""
    c, q2, A, cl, cu, lb, ub = _lp_family(seed=0)
    kw = dict(max_iter=300, restarts=3, polish=False)
    jsol, jfac = jshared.solve_shared_factored(
        c, q2, A, cl, cu, lb, ub, settings=JSettings(**kw))
    tsol, tfac = tshared.solve_shared_factored(
        c, q2, A, cl, cu, lb, ub, settings=TSettings(**kw), device="cpu")
    q2_big = np.full_like(q2, 50.0)
    jsol2 = jshared.solve_shared_frozen(
        c, q2_big, A, cl, cu, lb, ub, jfac, settings=JSettings(**kw),
        warm=jsol.raw)
    sol2 = tshared.solve_shared_frozen(
        c, q2_big, A, cl, cu, lb, ub, tfac, settings=TSettings(**kw),
        warm=tsol.raw)
    pri, dua = sol2.pri_res.numpy(), sol2.dua_res.numpy()
    assert np.isinf(pri).any() or np.isinf(dua).any()
    assert not np.isnan(pri).any() and not np.isnan(dua).any()
    for leaf in (sol2.x, sol2.z, sol2.y, sol2.yx, *sol2.raw):
        assert torch.isfinite(leaf).all()
    assert not sol2.done.numpy()[np.isinf(pri) | np.isinf(dua)].any()
    st4 = tadmm.stop_stats(sol2).numpy()
    assert not np.isnan(st4).any() and not bool(st4[3])
    # the same scenarios diverge in both packages
    np.testing.assert_array_equal(np.isinf(pri),
                                  np.isinf(np.asarray(jsol2.pri_res)))


def _recorder(base):
    class Recorder(base):
        """Records (W, xbars, Eobjective) after every PH iteration."""

        def __init__(self, opt):
            super().__init__(opt)
            opt.trace = []

        def enditer(self):
            self.opt.trace.append((self.opt.W.copy(), self.opt.xbars.copy(),
                                   self.opt.Eobjective()))

    return Recorder


def test_ph_matches_reference_uc_lite4():
    S = 4
    names = juc.scenario_names_creator(S)
    kw = dict(UC_KW, num_gens=3, horizon=6, num_scens=S)
    opts = dict(PH_OPTIONS, PHIterLimit=12)
    jph = JPH(dict(opts), names, juc.scenario_creator,
              scenario_creator_kwargs=kw, extensions=_recorder(JExtension))
    assert jph._megastep_request() == 0 and jph.batch.A_shared is not None
    jres = jph.ph_main()
    tph = TPH(dict(opts, device="cpu"), names, tuc.scenario_creator,
              scenario_creator_kwargs=kw, extensions=_recorder(TExtension))
    cuda_kernels.reset_counts()
    tres = tph.ph_main()
    # every sweep block went through the shared kernel's wrapper (its plain
    # version on the CPU), and none through the dense engine's
    assert cuda_kernels.plain_calls["fused_sweeps_shared"] > 0
    assert cuda_kernels.plain_calls["fused_sweeps"] == 0
    assert len(tph.trace) == len(jph.trace) == 12
    for k, ((tw, tx, te), (jw, jx, je)) in enumerate(zip(tph.trace,
                                                         jph.trace)):
        _close(tw, jw, 1e-7, f"W at iteration {k + 1}")
        _close(tx, jx, 1e-7, f"xbars at iteration {k + 1}")
        assert te == pytest.approx(je, rel=1e-7)
    for a, b in zip(tres, jres):
        assert a == pytest.approx(b, rel=1e-7)
    ef_obj, _ = solve_ef(tph.batch, solver="highs")
    assert tres[2] <= ef_obj + 1e-6 * abs(ef_obj)


def test_edualbound_certified_on_shared_batch():
    """Twin of tests/test_shared.py::test_shared_edualbound_certified, and
    the two packages' bounds agree."""
    from tpusppy_torch.solvers import scipy_backend

    S = 4
    names = juc.scenario_names_creator(S)
    kw = {"num_scens": S, "relax_integers": True}
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 1, "convthresh": -1.0}
    jopt = JPHBase(dict(opts), names, juc.scenario_creator,
                   scenario_creator_kwargs=kw)
    topt = TPHBase(dict(opts, device="cpu"), names, tuc.scenario_creator,
                   scenario_creator_kwargs=kw)
    jopt.solve_loop()
    topt.solve_loop()
    bound = topt.Edualbound()
    b = topt.batch
    exact = np.mean([
        scipy_backend.solve_lp(b.c[s], b.A[s], b.cl[s], b.cu[s], b.lb[s],
                               b.ub[s]).obj + b.const[s]
        for s in range(S)])
    assert bound <= exact + 1e-6 * abs(exact)
    assert bound >= exact - 0.02 * abs(exact)
    assert bound == pytest.approx(jopt.Edualbound(), rel=1e-9)


def test_device_consts_hold_the_shared_matrix_once():
    names = tuc.scenario_names_creator(6)
    opt = SPOpt({"device": "cpu"}, names, tuc.scenario_creator,
                scenario_creator_kwargs=dict(UC_KW, num_scens=6))
    A_d, cl_d, cu_d = opt._device_consts(torch.float64)
    m, n = opt.batch.num_rows, opt.batch.num_vars
    assert tuple(A_d.shape) == (m, n)
    assert tuple(cl_d.shape) == tuple(cu_d.shape) == (6, m)
    np.testing.assert_array_equal(A_d.numpy(), opt.batch.A_shared)


def test_dual_objective_takes_the_2d_shared_A():
    """The port's twin of tests/test_shared.py::
    test_shared_dual_objective_2d_dispatch: (m, n) and (S, m, n) A give the
    same bound, in both packages, to 1e-10."""
    import jax.numpy as jnp

    jb, tb = _batches(3, num_gens=3, horizon=6)
    sol = tshared.solve_shared(*_arrays(tb),
                               settings=TSettings(max_iter=400, restarts=8),
                               device="cpu")
    y, x = sol.y.numpy(), sol.x.numpy()
    A3 = np.array(tb.A)
    t = torch.as_tensor
    targs = [t(v) for v in (tb.c, tb.q2, A3, tb.cl, tb.cu, tb.lb, tb.ub,
                            y, x)]
    d3 = tadmm.dual_objective(*targs).numpy()
    targs[2] = t(tb.A_shared)
    d2 = tadmm.dual_objective(*targs).numpy()
    dm = tadmm.dual_objective_with_margin(*targs).numpy()
    jd = np.asarray(jadmm.dual_objective(
        *(jnp.asarray(v) for v in (tb.c, tb.q2, tb.A_shared, tb.cl, tb.cu,
                                   tb.lb, tb.ub, y, x))))
    np.testing.assert_allclose(d2, d3, rtol=1e-10)
    np.testing.assert_allclose(d2, jd, rtol=1e-10)
    np.testing.assert_allclose(dm[0], d2, rtol=1e-10)


def test_batch_from_arrays_keeps_A_shared():
    jb, _ = _batches(3)
    fields = {f.name: getattr(jb, f.name) for f in dataclasses.fields(jb)}
    fields["tree"] = dataclasses.asdict(jb.tree)
    tb = convert.batch_from_arrays(**fields)
    assert tb.A_shared is not None and tb.A_shared.ndim == 2
    np.testing.assert_array_equal(tb.A_shared, jb.A_shared)
    assert tb.A.shape == jb.A.shape and np.shares_memory(tb.A, tb.A_shared)
    obj, x = solve_ef(tb, solver="highs")
    jobj, _ = solve_ef(_batches(3)[1], solver="highs")
    assert obj == pytest.approx(jobj, rel=1e-9)
    np.testing.assert_allclose(tb.objective(x), jb.objective(x), rtol=1e-12)


def test_solve_ef_takes_a_shared_batch():
    """Twin of tests/test_shared.py::test_shared_ef_parity: HiGHS and the
    batched ADMM route on the shared-A family, against the reference."""
    from tpusppy.ef import solve_ef as jsolve_ef

    jb, tb = _batches(3, num_gens=3, horizon=6)
    obj_h, x = solve_ef(tb, solver="highs")
    assert obj_h == pytest.approx(jsolve_ef(jb, solver="highs")[0],
                                  rel=1e-9)
    obj_a, _ = solve_ef(tb, solver="admm", device="cpu")
    assert obj_a == pytest.approx(obj_h, rel=5e-4)
    assert x.shape == (3, tb.num_vars)


def test_state_carry_reproduces_next_iteration():
    """A reference uc_lite PH state with its SharedFactors, loaded through
    convert.load_ph_state, reproduces the reference's next iteration (a
    frozen solve on the carried factors) to 1e-9."""
    S = 3
    names = juc.scenario_names_creator(S)
    kw = dict(UC_KW, num_scens=S)
    opts = dict(PH_OPTIONS, PHIterLimit=5, convthresh=0.0)
    jph = JPH(dict(opts), names, juc.scenario_creator,
              scenario_creator_kwargs=kw)
    jph.ph_main()
    assert jph._iter == 5 and isinstance(jph._factors, jshared.SharedFactors)
    tph = TPH(dict(opts, device="cpu"), names, tuc.scenario_creator,
              scenario_creator_kwargs=kw)
    convert.load_ph_state(
        tph, jph.W, jph.xbars, jph.rho,
        warm=tuple(np.asarray(v) for v in jph._warm),
        factors={k: np.asarray(v) for k, v in jph._factors._asdict().items()},
        factors_age=jph._factors_age, iteration=jph._iter)
    assert isinstance(tph._factors, tshared.SharedFactors)
    age = jph._factors_age
    jph._iterk_one(6, 0.0)
    tph._iterk_one(6, 0.0)
    assert jph._factors_age == tph._factors_age == age + 1
    for name in ("W", "xbars"):
        _close(getattr(tph, name), getattr(jph, name), 1e-9, name)
    assert tph.conv == pytest.approx(jph.conv, rel=1e-9)


def test_missing_engines_raise():
    """A shared A the reference uploads as SparseA solves, on the sparse
    engine, and factors without K are taken.  The lowered sweep modes are
    taken; a mode the reference does not have raises and runs no
    substitute."""
    from tpusppy_torch.ir import LinearModelBuilder
    from tpusppy_torch.scenario_tree import ScenarioNode
    from tpusppy_torch.solvers.sparse import SparseA

    b = LinearModelBuilder("big")
    xs = b.add_vars("x", 2000, lb=0.0, ub=1.0, cost=1.0)
    for i in range(2100):
        b.add_ge({xs[i % 2000]: 1.0}, 0.0)
    template = b.build()

    def creator(name):
        return dataclasses.replace(
            template, name=name,
            nodes=[ScenarioNode("ROOT", 1.0, 1, np.arange(3))])

    opt = SPOpt({"device": "cpu", "solver_options": {"max_iter": 8,
                                                     "restarts": 1}},
                ["s0", "s1"], creator)
    assert opt.batch.A_shared is not None
    cuda_kernels.reset_counts()
    x = opt.solve_loop()
    assert isinstance(opt._device_consts(torch.float64)[0], SparseA)
    assert x.shape == (2, 2000) and np.isfinite(x).all()
    assert cuda_kernels.plain_calls["fused_sweeps_sparse"] > 0
    with pytest.raises(ValueError, match="must be one of"):
        make_admm_settings({"solver_options": {"sweep_precision": "bf16"}})
    assert make_admm_settings({"solver_options": {
        "sweep_precision": "default"}}).sweep_precision == "default"
    assert make_admm_settings({"solver_options": {
        "factors_keep_K": False}}) == TSettings(factors_keep_K=False)
    assert make_admm_settings({"solver_options": {
        "sweep_precision": "highest", "megastep": 1}}) == TSettings(
            megastep=1)


def test_uc_ph_without_a_device_raises_when_no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    names = tuc.scenario_names_creator(3)
    kw = dict(UC_KW, num_scens=3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TPH({"defaultPHrho": 10.0, "PHIterLimit": 2}, names,
            tuc.scenario_creator, scenario_creator_kwargs=kw)
    ph = TPH({"defaultPHrho": 10.0, "PHIterLimit": 2, "device": "cpu"},
             names, tuc.scenario_creator, scenario_creator_kwargs=kw)
    assert ph.device.type == "cpu" and ph.batch.A_shared is not None
