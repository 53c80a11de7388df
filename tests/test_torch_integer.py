"""The port's integer tiers against the reference's, float64 on the CPU.

The integer models (netdes, sizes, sslp) build the reference's problems
exactly.  From the reference's state after Iter0 and three legacy
iterations on netdes S=3 (carried into a port PH with
``tpusppy_torch.convert.load_ph_state``), the device half of
``tpusppy_torch.solvers.integer`` (the candidate ladder, the rounding
sweep, reduced-cost fixing and the integer bound pass, with fixing on and
off) agrees with ``tpusppy.solvers.integer``'s; every reduced-cost-tightened
per-scenario bound lies below that scenario's integer minimum (HiGHS); the
host candidate twin is the device ladder's; and the bound-pass window
wires the integer tail, its fixing compiled out on sizes (second-stage
integers), and a family without integer nonants keeps the plain tail.
The host half is held in ``tests/test_torch_milp_bound.py``, the whole
slice in ``tests/test_torch_mip_incumbents.py``.
"""

import numpy as np
import pytest
import torch

from tpusppy.models import netdes as jnetdes
from tpusppy.models import sizes as jsizes
from tpusppy.models import sslp as jsslp
from tpusppy.opt.ph import PH as JPH
from tpusppy.solvers import integer as JI
from tpusppy_torch import convert
from tpusppy_torch.models import farmer as tfarmer
from tpusppy_torch.models import netdes as tnetdes
from tpusppy_torch.models import sizes as tsizes
from tpusppy_torch.models import sslp as tsslp
from tpusppy_torch.obs import metrics
from tpusppy_torch.opt.ph import PH as TPH
from tpusppy_torch.parallel import sharded
from tpusppy_torch.solvers import admm
from tpusppy_torch.solvers import integer as TI
from tpusppy_torch.solvers import scipy_backend

torch.set_num_threads(1)

N = 3
NETDES_KW = {"num_scens": N, "relax_integers": False}
SIZES_KW = {"scenario_count": N, "relax_integers": False}
LP_EF, MIP_EF = 376.306, 398.333     # netdes S=3 (tests/test_integer.py)


def _opts(rho=1.0, **extra):
    return {"defaultPHrho": rho, "PHIterLimit": 40, "convthresh": -1.0,
            "in_wheel_bounds": True, "integer_escalation": False, **extra}


def _carried(jmod, tmod, kw, rho=1.0, iters=3, **extra):
    """(reference PH, port PH) at the reference's state after Iter0 and
    ``iters`` legacy iterations."""
    names = jmod.scenario_names_creator(N)
    jph = JPH(_opts(rho, **extra), names, jmod.scenario_creator,
              scenario_creator_kwargs=kw)
    jph.Iter0()
    for k in range(1, iters + 1):
        jph._iterk_one(k, -1.0)
    tph = TPH(_opts(rho, device="cpu", **extra), names,
              tmod.scenario_creator, scenario_creator_kwargs=kw)
    convert.load_ph_state(
        tph, jph.W, jph.xbars, jph.rho,
        warm=tuple(np.asarray(v) for v in jph._warm),
        factors={k: np.asarray(v) for k, v in jph._factors._asdict().items()},
        factors_age=jph._factors_age, iteration=jph._iter)
    tph.pri_res, tph.dua_res = (np.asarray(jph.pri_res),
                                np.asarray(jph.dua_res))
    tph.local_x = np.asarray(jph.local_x, dtype=float)
    return jph, tph


@pytest.fixture(scope="module")
def netdes_pair():
    return _carried(jnetdes, tnetdes, NETDES_KW)


def _ref_inputs(ph):
    """The reference bound pass's inputs from its warm host state."""
    import jax.numpy as jnp

    from tpusppy.parallel import sharded as jsharded

    st = ph.admm_settings
    dt = st.jdtype()
    arr = ph._mega_arrays(dt)
    w = ph._warm
    state = jsharded.PHState(
        W=jnp.asarray(ph.W, dt), xbars=jnp.asarray(ph.xbars, dt),
        rho=jnp.asarray(ph.rho, dt), x=jnp.asarray(w[0], dt),
        z=jnp.asarray(w[1], dt), y=jnp.asarray(w[2], dt),
        yx=jnp.asarray(w[3], dt))
    idx = jnp.asarray(ph.tree.nonant_indices)
    _, shared_frozen, _, frozen = jsharded._solver_fns_for(st, None, "scen")
    fsolve = shared_frozen if arr.A.ndim == 2 else frozen
    q, q2, _, _ = jsharded._ph_objective(arr, state, 1.0, idx, st)
    return arr, state, idx, q, q2, fsolve, dt


def _port_inputs(ph):
    """The port bound pass's inputs from its (carried) host state."""
    st = ph.admm_settings
    dt = st.tdtype()
    arr = ph._mega_arrays(dt)

    def t(v):
        return admm._tensor(v, dt, ph.device)

    w = ph._warm
    state = sharded.PHState(W=t(ph.W), xbars=t(ph.xbars), rho=t(ph.rho),
                            x=t(w[0]), z=t(w[1]), y=t(w[2]), yx=t(w[3]))
    idx = torch.as_tensor(np.asarray(ph.tree.nonant_indices),
                          dtype=torch.int64)
    q, q2, _, _ = sharded._ph_objective(arr, state, 1.0, idx)
    return arr, state, idx, q, q2, sharded._frozen_fn(arr.A), st


def _rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))


# ---- the models ----------------------------------------------------------
@pytest.mark.parametrize("jmod,tmod,kw", [
    (jnetdes, tnetdes, {"num_scens": 4, "relax_integers": False}),
    (jsizes, tsizes, {"scenario_count": 3, "relax_integers": False}),
    (jsizes, tsizes, {"scenario_count": 10}),
    (jsslp, tsslp, {"num_servers": 10, "num_clients": 50,
                    "relax_integers": False}),
], ids=["netdes", "sizes3", "sizes10", "sslp_10_50"])
def test_models_build_the_reference_problems(jmod, tmod, kw):
    from tpusppy.ir import ScenarioBatch as JBatch
    from tpusppy_torch.ir import ScenarioBatch as TBatch

    S = kw.get("num_scens", kw.get("scenario_count", 4))
    names = jmod.scenario_names_creator(S)
    assert names == tmod.scenario_names_creator(S)
    jb = JBatch.from_problems([jmod.scenario_creator(nm, **kw)
                               for nm in names])
    tb = TBatch.from_problems([tmod.scenario_creator(nm, **kw)
                               for nm in names])
    for f in ("c", "q2", "A", "cl", "cu", "lb", "ub", "is_int", "const"):
        np.testing.assert_array_equal(np.asarray(getattr(tb, f)),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert (tb.A_shared is None) == (jb.A_shared is None)
    for f in ("nonant_indices", "scen_prob", "node_prob", "scen_node_ids",
              "nonant_stage"):
        np.testing.assert_array_equal(getattr(tb.tree, f),
                                      np.asarray(getattr(jb.tree, f)),
                                      err_msg=f)
    assert tb.tree.node_names == list(jb.tree.node_names)
    if tmod is tsizes:
        np.testing.assert_array_equal(tsizes._rho_setter(tb),
                                      jsizes._rho_setter(jb))


# ---- the device half -----------------------------------------------------
def test_candidate_ladder_matches_reference_and_host_twin(netdes_pair):
    import jax
    import jax.numpy as jnp

    jph, tph = netdes_pair
    th = tph._inwheel_int_thresholds()
    assert th == jph._inwheel_int_thresholds() == TI.DEFAULT_THRESHOLDS
    jarr, jst, jidx, _, _, _, jdt = _ref_inputs(jph)
    mask = jnp.asarray(jph._inwheel_int_mask())
    jdev = jax.jit(lambda s: JI.candidate_ladder(
        s.xbars, s.x[:, jidx], mask, th, jarr.onehot, jarr.nid_sk,
        jarr.lb[:, jidx], jarr.ub[:, jidx]))(jst)
    arr, st, idx, _, _, _, _ = _port_inputs(tph)
    dev = TI.candidate_ladder(
        st.xbars, st.x[:, idx], tph._inwheel_int_mask(), th, arr.onehot,
        arr.nid_sk, arr.lb[:, idx], arr.ub[:, idx])
    assert dev.shape[0] == TI.n_candidates(th) == 5
    np.testing.assert_allclose(dev.numpy(), np.asarray(jdev), rtol=0,
                               atol=1e-12)
    host = TI.host_candidates(tph, th)
    np.testing.assert_array_equal(host, JI.host_candidates(jph, th))
    np.testing.assert_allclose(dev.numpy(), host, rtol=0, atol=1e-12)
    ints = tph._inwheel_int_mask()
    np.testing.assert_array_equal(host[:, :, ints],
                                  np.round(host[:, :, ints]))
    no_slams = TI.candidate_ladder(
        st.xbars, st.x[:, idx], ints, th, arr.onehot, arr.nid_sk,
        arr.lb[:, idx], arr.ub[:, idx], include_slams=False)
    assert no_slams.shape[0] == len(th)


def test_sweep_partials_match_reference(netdes_pair):
    import jax
    import jax.numpy as jnp

    jph, tph = netdes_pair
    th = TI.DEFAULT_THRESHOLDS
    tol = tph._inwheel_feas_tol()
    jarr, jst, jidx, jq, jq2, jf, jdt = _ref_inputs(jph)
    mask = jnp.asarray(jph._inwheel_int_mask())
    jout = jax.jit(lambda s: JI.sweep_partials(
        jarr, s, jidx, jq, jq2, jf, jph._factors, tol, jdt, mask, th))(jst)
    arr, st, idx, q, q2, frozen, settings = _port_inputs(tph)
    launches = [{} for _ in range(5)]
    out = TI.sweep_partials(arr, st, idx, q, q2, frozen, tph._factors,
                            settings, tol, tph._inwheel_int_mask(), th,
                            launches=launches)
    inner, feas, sweeps, u, ok = (v.numpy() for v in out)
    jinner, jfeas, jsweeps, ju, jok = (np.asarray(v) for v in jout)
    assert _rel(inner, jinner) <= 1e-7
    assert _rel(u, ju) <= 1e-7
    np.testing.assert_allclose(feas, jfeas, atol=1e-12)
    np.testing.assert_array_equal(sweeps, jsweeps)
    np.testing.assert_array_equal(ok, jok)
    # every candidate's evaluation went through the dense engine's sweeps
    assert all(d.get(("plain_calls", "fused_sweeps"), 0) > 0
               for d in launches)


@pytest.mark.parametrize("rcfix", [True, False], ids=["rcfix", "plain"])
def test_integer_bound_pass_matches_reference(netdes_pair, rcfix):
    import jax
    import jax.numpy as jnp

    jph, tph = netdes_pair
    th = TI.DEFAULT_THRESHOLDS
    tol = tph._inwheel_feas_tol()
    cols = np.asarray(tph.batch.is_int, bool)
    jarr, jst, jidx, jq, jq2, jf, jdt = _ref_inputs(jph)
    mask, jcols = jnp.asarray(jph._inwheel_int_mask()), jnp.asarray(cols)
    jtail = np.asarray(jax.jit(lambda s: JI.integer_bound_pass(
        jarr, s, jidx, jq, jq2, jf, jph._factors, tol, jdt, mask, th,
        jcols, rcfix_enabled=rcfix))(jst))
    arr, st, idx, q, q2, frozen, settings = _port_inputs(tph)
    tail = TI.integer_bound_pass(
        arr, st, idx, q, q2, frozen, tph._factors, settings, tol,
        tph._inwheel_int_mask(), th, torch.as_tensor(cols),
        rcfix_enabled=rcfix).numpy()
    assert tail.shape == jtail.shape == (
        sharded.BOUND_PACK_LEN + TI.INT_BOUND_EXTRA,)
    for i in (1, 2, 8):       # tightened outer, best inner, base outer
        assert _rel(tail[i], jtail[i]) <= 1e-7, i
    np.testing.assert_allclose(tail[3], jtail[3], atol=1e-12)
    # computed flag, sweeps, feasible count, best index, fixed slots
    np.testing.assert_array_equal(tail[[0, 4, 5, 6, 7]], jtail[[0, 4, 5, 6,
                                                                  7]])
    assert tail[1] >= tail[8] - 1e-9
    if not rcfix:
        assert tail[7] == 0 and tail[1] == tail[8]


def _integer_minima(ph):
    """(S,) each scenario's HiGHS integer minimum of the W-augmented
    objective (const-free)."""
    b = ph.batch
    qL = TI._waug_q(ph)
    out = []
    for s in range(b.num_scenarios):
        r = scipy_backend.solve_lp(qL[s], b.A[s], b.cl[s], b.cu[s], b.lb[s],
                                   b.ub[s], is_int=b.is_int, mip_rel_gap=1e-9)
        assert r.feasible
        out.append(float(qL[s] @ r.x))
    return np.array(out)


@pytest.mark.parametrize("upper", ["candidate", "minima"])
def test_rc_fixed_bounds_lower_bound_integer_minima(netdes_pair, upper):
    """THE property: every per-scenario reduced-cost-tightened bound is at
    most that scenario's integer minimum of the W-augmented objective.  The
    fixing's upper bound is the sweep's best candidate's value (what the
    pass uses), or the integer minima themselves (valid and tight, so
    slots do fix), where the reference's fixing and bounds agree."""
    import jax
    import jax.numpy as jnp

    jph, tph = netdes_pair
    arr, st, idx, q, q2, frozen, settings = _port_inputs(tph)
    cols = np.asarray(tph.batch.is_int, bool)
    minima = _integer_minima(tph)
    if upper == "candidate":
        inner, feas, _, u, ok = TI.sweep_partials(
            arr, st, idx, q, q2, frozen, tph._factors, settings,
            tph._inwheel_feas_tol(), tph._inwheel_int_mask(),
            TI.DEFAULT_THRESHOLDS)
        good = feas >= 1.0 - TI.feas_slack(N, torch.float64)
        best = int(torch.argmin(torch.where(good, inner,
                                            torch.tensor(float("inf")))))
        u, ok = u[best], ok[best]
    else:
        u = torch.tensor(minima)
        ok = torch.ones(N, dtype=torch.bool)
    final_s, d_cmp, n_fixed, sweeps = TI.rc_outer_partials(
        arr, st, idx, q, q2, frozen, tph._factors, settings,
        torch.as_tensor(cols), u, ok, want_perscen=True)
    final_s, d_cmp = final_s.numpy(), d_cmp.numpy()
    assert (final_s >= d_cmp - 1e-9).all()
    assert (final_s <= minima + 1e-6 * np.maximum(1.0, np.abs(minima))).all()
    if upper == "minima":
        assert float(n_fixed) > 0
        jarr, jst, jidx, jq, jq2, jf, jdt = _ref_inputs(jph)
        ju, jok, jcols = (jnp.asarray(v) for v in (u.numpy(), ok.numpy(),
                                                   cols))
        jout = jax.jit(lambda s: JI.rc_outer_partials(
            jarr, s, jidx, jq, jq2, jf, jph._factors, jdt, jcols, ju, jok,
            want_perscen=True))(jst)
        assert _rel(final_s, np.asarray(jout[0])) <= 1e-7
        assert float(n_fixed) == float(jout[2])
        assert float(sweeps) == float(jout[3])


def test_rc_fix_bounds_fixes_only_provable_slots():
    """A slot fixes at a bound only when one unit off it exceeds the
    scenario's upper bound, a linear integer slot with room, and never on a
    scenario whose evaluation missed the gate."""
    f64 = torch.float64
    lb = torch.zeros(2, 4, dtype=f64)
    ub = torch.ones(2, 4, dtype=f64)
    ub[:, 3] = 0.0                                   # no room
    q2 = torch.zeros(2, 4, dtype=f64)
    q2[:, 2] = 1.0                                   # quadratic slot
    g = torch.tensor([[5.0, -5.0, 5.0, 5.0], [0.5, -5.0, 5.0, 5.0]],
                     dtype=f64)
    d = torch.tensor([10.0, 10.0], dtype=f64)
    u = torch.tensor([12.0, 12.0], dtype=f64)
    cols = torch.tensor([True, True, True, True])
    lbF, ubF, n = TI.rc_fix_bounds(g, q2, lb, ub, g, d, u,
                                   torch.tensor([True, False]), cols, 1e-5)
    # scenario 0: slot 0 fixes at lb (10 + 5 > 12), slot 1 at ub
    assert ubF[0, 0] == 0.0 and lbF[0, 1] == 1.0
    assert ubF[0, 2] == 1.0 and lbF[0, 2] == 0.0    # quadratic: left
    assert torch.equal(lbF[1], lb[1]) and torch.equal(ubF[1], ub[1])
    assert float(n) == 2.0


def test_bound_pass_window_emits_the_integer_tail(netdes_pair):
    """One bound-pass window (``n_live=0``: the pass evaluates exactly the
    carried state) in both packages: the integer tail unpacks, agrees with
    the reference's, and bills the candidates' evaluations."""
    jph, tph = netdes_pair
    jm = jph._megastep_solve(4, 0, -1.0, jph.W, jph.xbars, jph.rho,
                             bound_live=True)
    with metrics.window() as w:
        tm = tph._megastep_solve(4, 0, -1.0, tph.W, tph.xbars, tph.rho,
                                 bound_live=True)
    assert tm["executed"] == 0 and tm["bound_computed"]
    for k in ("int_feas_cands", "int_best_idx", "int_rcfix_slots",
              "bound_sweeps"):
        assert tm[k] == jm[k], k
    for k in ("bound_outer", "bound_outer_base", "bound_inner_obj"):
        assert _rel(tm[k], jm[k]) <= 1e-7, k
    assert tm["bound_outer"] >= tm["bound_outer_base"] - 1e-9
    assert w.delta("megastep.bound_passes") == 1
    assert tph._inwheel_pass_evals() == jph._inwheel_pass_evals() == 6
    assert len(tph.bound_pass_launches) == 6


def test_second_stage_integers_compile_out_fixing():
    """sizes carries second-stage integer columns: the pass emits the plain
    weak-duality outer twice and fixes nothing, as the reference's."""
    extra = {"in_wheel_host_rescue": False}
    jph, tph = _carried(jsizes, tsizes, SIZES_KW, rho=0.01, **extra)
    assert not tph._inwheel_inner_ok() and not jph._inwheel_inner_ok()
    assert tph._inwheel_pass_evals() == jph._inwheel_pass_evals() == 5
    jm = jph._megastep_solve(4, 0, -1.0, jph.W, jph.xbars, jph.rho,
                             bound_live=True)
    tm = tph._megastep_solve(4, 0, -1.0, tph.W, tph.xbars, tph.rho,
                             bound_live=True)
    assert tm["int_rcfix_slots"] == 0
    assert tm["bound_outer"] == tm["bound_outer_base"]
    assert _rel(tm["bound_outer"], jm["bound_outer"]) <= 1e-7
    assert tm["int_best_idx"] == jm["int_best_idx"]


def test_families_without_integer_nonants_keep_the_plain_tail():
    names = tfarmer.scenario_names_creator(3)
    ph = TPH(_opts(in_wheel_int_thresholds=(0.5, 0.25, 0.75),
                   device="cpu"), names, tfarmer.scenario_creator,
             scenario_creator_kwargs={"num_scens": 3})
    assert ph._inwheel_int_thresholds() is None
    assert ph._inwheel_pass_evals() == 1
    ph.Iter0()
    ph._iterk_one(1, -1.0)
    meas = ph._megastep_solve(4, 0, -1.0, ph.W, ph.xbars, ph.rho,
                              bound_live=True)
    assert meas["bound_computed"] and "int_feas_cands" not in meas


def test_measure_pack_lengths_and_unpack():
    base = sharded.megastep_measure_len(4, N, 10, 5, bounds=True)
    intl = sharded.megastep_measure_len(4, N, 10, 5, bounds=True,
                                        int_sweep=True)
    assert intl - base == TI.INT_BOUND_EXTRA
    vec = np.zeros(intl)
    vec[-9:] = [1.0, 2.0, 3.0, 0.5, 7.0, 2.0, 1.0, 4.0, 1.5]
    out = sharded.megastep_unpack(vec, 4, N, 10, 5, bounds=True,
                                  int_sweep=True)
    assert out["bound_computed"] and out["bound_outer"] == 2.0
    assert (out["int_feas_cands"], out["int_best_idx"],
            out["int_rcfix_slots"], out["bound_outer_base"]) == (2, 1, 4,
                                                                 1.5)


def test_options_that_still_raise():
    names = tnetdes.scenario_names_creator(N)
    with pytest.raises(NotImplementedError, match="item 5"):
        TPH(_opts(in_wheel_int_autotune=True, device="cpu"), names,
            tnetdes.scenario_creator, scenario_creator_kwargs=NETDES_KW)
    with pytest.raises(NotImplementedError, match="item 7"):
        sharded.make_bucketed_wheel_megastep(np.arange(3), admm.ADMMSettings(),
                                             int_rounding=(0.5,))
