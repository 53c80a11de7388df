"""The port's wheel megastep (tpusppy_torch.parallel.sharded and PHBase's
windows) against the reference's, in float64 on the CPU.

Device level: the reference's ``sharded.make_wheel_megastep`` and the port's
take the same (state, arrays, factors), carried over from one reference
refresh (``tpusppy_torch.convert``), and their packed window measurements
agree to 1e-9, block by block relative to each block's largest entry
(floored at 1), with the executed count, the refresh flag, the done flags
and the sweep counts equal: on the dense engine (farmer S=6), the shared-A
engine (uc_lite, 3 generators x 6 hours, S=4) and the sparse engine (uc
with its A uploaded as a SparseA, 3 generators x 6 hours, S=4).  The same
fixtures pin the window's behaviour: the early exit at ``convthresh``, the
``n_live`` budget, a rejected iterate discarded, a divergence-frozen
scenario refused.

Host level (the port's PH): megastep windows against the legacy
per-iteration loop to 1e-9 (the objective is assembled on the device in
one and on the host in the other, so they part in ulps); a window's host syncs are its solves' flag
reads plus its one packed fetch; the options (forced N, the legacy toggle,
convthresh inside a window, extensions forcing legacy) and the unported
ones raising with their ROADMAP item.  The reference's own megastep-against-
legacy trajectory is pinned in tests/test_megastep.py.  Reference runs and
PH runs are shared through module-scope fixtures.
"""

import numpy as np
import pytest
import torch

from tpusppy.ir import ScenarioBatch as JBatch
from tpusppy.models import farmer as jfarmer
from tpusppy.models import uc as juc
from tpusppy.models import uc_lite as juc_lite
from tpusppy.parallel import sharded as jsharded
from tpusppy.solvers.admm import ADMMSettings as JSettings
from tpusppy.solvers.sparse import SparseA as JSparseA
from tpusppy_torch import convert
from tpusppy_torch.extensions.extension import Extension as TExtension
from tpusppy_torch.models import farmer as tfarmer
from tpusppy_torch.obs import metrics
from tpusppy_torch.opt.ph import PH as TPH
from tpusppy_torch.parallel import sharded as tsharded
from tpusppy_torch.solvers import hostsync
from tpusppy_torch.solvers.admm import ADMMSettings as TSettings
from tpusppy_torch.solvers.sparse import SparseA as TSparseA

torch.set_num_threads(1)

N_ITERS = 4
SETTINGS = dict(max_iter=120, restarts=2)


def _close(got, ref, tol, what=""):
    """Within ``tol`` of ``ref``'s largest finite entry (floored at 1);
    non-finite entries (a window that accepted nothing keeps inf
    residuals) must sit at the same places with the same values."""
    got = np.asarray(got, dtype=float)
    ref = np.asarray(ref, dtype=float)
    assert got.shape == ref.shape, what
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(got[~fin], ref[~fin], err_msg=what)
    got, ref = got[fin], ref[fin]
    scale = max(1.0, float(np.max(np.abs(ref))) if ref.size else 1.0)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} * {scale:.3g}"


class _Case:
    """One engine's reference refresh and window, and the port's twins of
    its arrays, state and factors."""

    def __init__(self, batch, sparse=False):
        st = JSettings(**SETTINGS)
        mesh = jsharded.make_mesh(1)
        self.jarr = jsharded.shard_batch(batch, mesh, sparse=sparse)
        idx = batch.tree.nonant_indices
        refresh, _ = jsharded.make_ph_step_pair(idx, st, mesh)
        state = jsharded.init_state(self.jarr, 1.0, st)
        state, _, _ = refresh(state, self.jarr, 0.0)
        self.jstate, _, self.jfactors = refresh(state, self.jarr, 1.0)
        self.jmega = jsharded.make_wheel_megastep(idx, st, mesh,
                                                  n_iters=N_ITERS,
                                                  donate=False)
        self.tmega = tsharded.make_wheel_megastep(idx, TSettings(**SETTINGS),
                                                  n_iters=N_ITERS)
        self.shape = (batch.num_scenarios, batch.num_vars,
                      batch.tree.num_nonants)

        def t(v):
            return torch.tensor(np.asarray(v), dtype=torch.float64)

        ja = self.jarr
        if isinstance(ja.A, JSparseA):
            A = TSparseA.from_dense(np.asarray(batch.A_shared),
                                    dtype=torch.float64, device="cpu",
                                    structure=True)
            self.tfactors = convert.shared_factors_from_arrays(
                self.jfactors._asdict(), "cpu", A=A)
        elif np.ndim(ja.A) == 2:
            A = t(ja.A)
            self.tfactors = convert.shared_factors_from_arrays(
                self.jfactors._asdict(), "cpu")
        else:
            A = t(ja.A)
            self.tfactors = convert.factors_from_arrays(
                {k: np.asarray(v)
                 for k, v in self.jfactors._asdict().items()}, "cpu")
        self.tarr = tsharded.PHArrays(
            c=t(ja.c), q2=t(ja.q2), A=A, cl=t(ja.cl), cu=t(ja.cu),
            lb=t(ja.lb), ub=t(ja.ub), const=t(ja.const), probs=t(ja.probs),
            onehot=t(ja.onehot),
            nid_sk=torch.tensor(np.asarray(ja.nid_sk), dtype=torch.int64))
        self.tstate = tsharded.PHState(*(t(v) for v in self.jstate))

    def run(self, convthresh=-1.0, n_live=N_ITERS, tol=np.inf, rho=None):
        """(reference, port) unpacked measurements and final states of one
        window from the case's state (``rho`` replaces its rho)."""
        jst, tst = self.jstate, self.tstate
        if rho is not None:
            jst = jst._replace(rho=np.asarray(rho))
            tst = tst._replace(rho=torch.tensor(rho))
        js, jp = self.jmega(jst, self.jarr, 1.0, self.jfactors, convthresh,
                            n_live, tol)
        ts, tp = self.tmega(tst, self.tarr, 1.0, self.tfactors, convthresh,
                            n_live, tol)
        S, n, K = self.shape
        jm = jsharded.megastep_unpack(np.asarray(jp), N_ITERS, S, n, K)
        tm = tsharded.megastep_unpack(tp.numpy(), N_ITERS, S, n, K)
        return jm, tm, js, ts


def _same_window(tm, jm, tol=1e-9):
    for k in ("executed", "refresh_hit"):
        assert tm[k] == jm[k], k
    for k in ("all_done", "done"):
        np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
    np.testing.assert_array_equal(tm["iters"], jm["iters"])
    for k in ("conv", "eobj", "pri_max", "dua_max", "pri", "dua", "x", "W",
              "xbars"):
        _close(tm[k], jm[k], tol, k)


@pytest.fixture(scope="module")
def dense():
    names = jfarmer.scenario_names_creator(6)
    return _Case(JBatch.from_problems(
        [jfarmer.scenario_creator(nm, num_scens=6) for nm in names]))


@pytest.fixture(scope="module")
def shared():
    S = 4
    names = juc_lite.scenario_names_creator(S)
    batch = JBatch.from_problems([
        juc_lite.scenario_creator(nm, num_scens=S, num_gens=3, horizon=6,
                                  relax_integers=True) for nm in names])
    assert batch.A_shared is not None
    return _Case(batch)


@pytest.fixture(scope="module")
def dense_window(dense):
    return dense.run()


# ---- device level: the packed window against the reference's ---------------
def test_dense_window_matches_reference(dense_window):
    jm, tm, js, ts = dense_window
    assert tm["executed"] == N_ITERS and not tm["refresh_hit"]
    _same_window(tm, jm)
    # the packed final state is the returned state
    np.testing.assert_array_equal(tm["W"], ts.W.numpy())
    np.testing.assert_array_equal(tm["x"], ts.x.numpy())
    for name in ("z", "y", "yx"):
        _close(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
               1e-9, name)


def test_shared_window_matches_reference(shared):
    jm, tm, _, _ = shared.run()
    assert tm["executed"] >= 1
    _same_window(tm, jm)


def test_sparse_window_matches_reference():
    S = 4
    names = juc.scenario_names_creator(S)
    batch = JBatch.from_problems([
        juc.scenario_creator(nm, num_scens=S, num_gens=3, horizon=6,
                             relax_integers=True) for nm in names])
    case = _Case(batch, sparse=True)
    assert isinstance(case.tarr.A, TSparseA)
    jm, tm, _, _ = case.run()
    assert tm["executed"] >= 1
    _same_window(tm, jm)


def test_early_exit_at_convthresh(dense, dense_window):
    convs = dense_window[0]["conv"]
    # between the 2nd and 3rd conv: the window stops after iteration 3
    th = float(convs[2]) * 1.0000001
    t = int(np.argmax(convs < th)) + 1
    assert 1 <= t < N_ITERS
    jm, tm, _, _ = dense.run(convthresh=th)
    assert tm["executed"] == t and not tm["refresh_hit"]
    assert np.all(tm["conv"][t:] == 0.0)      # the steps after are inert
    _same_window(tm, jm)


def test_n_live_budget(dense):
    jm, tm, _, _ = dense.run(n_live=2)
    assert tm["executed"] == 2
    assert np.all(tm["iters"][2:] == 0.0)
    _same_window(tm, jm)


def test_rejected_iterate_is_discarded(dense):
    """An absurdly tight acceptance ladder rejects the first iterate: the
    state passes through and refresh_hit is set, its stats row recorded
    for billing."""
    jm, tm, _, ts = dense.run(tol=1e-300)
    assert tm["executed"] == 0 and tm["refresh_hit"]
    assert tm["iters"][0] > 0 and np.all(tm["iters"][1:] == 0.0)
    np.testing.assert_array_equal(ts.W.numpy(), dense.tstate.W.numpy())
    np.testing.assert_array_equal(ts.x.numpy(), dense.tstate.x.numpy())
    _same_window(tm, jm)


def test_divergence_freeze_refused_as_reference(shared):
    """A scenario whose frozen solve diverges (a huge prox rho against the
    refreshed factors) fails the acceptance test in both packages."""
    rho = np.array(np.asarray(shared.jstate.rho), copy=True)
    rho[0, :] = 1e12
    jm, tm, _, ts = shared.run(tol=1e-4, rho=rho)
    assert tm["refresh_hit"] and tm["executed"] == jm["executed"] == 0
    np.testing.assert_array_equal(ts.W.numpy(), shared.tstate.W.numpy())
    for k in ("executed", "refresh_hit"):
        assert tm[k] == jm[k]
    np.testing.assert_array_equal(tm["iters"], jm["iters"])


def test_unpack_layout_round_trip():
    S, n, K, N = 3, 5, 2, 4
    for pack in ("full", "lean"):
        for bounds in (False, True):
            L = tsharded.megastep_measure_len(N, S, n, K, pack, bounds)
            assert L == jsharded.megastep_measure_len(N, S, n, K, pack,
                                                      bounds)
            vec = np.arange(L, dtype=float)
            got = tsharded.megastep_unpack(vec, N, S, n, K, pack, bounds)
            want = jsharded.megastep_unpack(vec, N, S, n, K, pack, bounds)
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_window_rejects_bad_arguments_and_unported_forms():
    with pytest.raises(ValueError):
        tsharded.make_wheel_megastep(np.arange(3), TSettings(), n_iters=0)
    with pytest.raises(ValueError):
        tsharded.make_wheel_megastep(np.arange(3), TSettings(), pack="x")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tsharded.make_wheel_megastep(np.arange(3), TSettings(), mesh=object())
    # the batched integer sweep is ported: the window builds, and ignores
    # the ladder where the family has no integer nonants
    assert callable(tsharded.make_wheel_megastep(
        np.arange(3), TSettings(), bounds=True,
        int_nonants=np.array([True, False, True]), int_rounding=(0.5,)))
    assert callable(tsharded.make_wheel_megastep(
        np.arange(3), TSettings(), bounds=True, int_rounding=(0.5,)))


# ---- host level: PH in windows ------------------------------------------------
def _tph(iters, mega, scens=3, extensions=None, **extra):
    opts = {"defaultPHrho": 1.0, "PHIterLimit": iters, "convthresh": -1.0,
            "device": "cpu", "solver_options": {"megastep": mega}, **extra}
    return TPH(opts, tfarmer.scenario_names_creator(scens),
               tfarmer.scenario_creator,
               scenario_creator_kwargs={"num_scens": scens},
               extensions=extensions)


class _ConvTrace(TExtension):
    """Records conv after every legacy iteration."""

    def enditer(self):
        self.opt.conv_trace.append(self.opt.conv)


@pytest.fixture(scope="module")
def trajectories():
    """(legacy, megastep) port runs of farmer S=3, 12 iterations at
    refresh_every=4: windows of 3 between the refreshes."""
    ph_l = _tph(12, 1, extensions=_ConvTrace, solver_refresh_every=4)
    ph_l.conv_trace = []
    names = ("dispatch.megasteps", "dispatch.mega_iterations",
             "dispatch.flops")
    with metrics.window() as w:
        ph_l.ph_main()
        legacy = {k: w.delta(k) for k in names}
    ph_m = _tph(12, 0, solver_refresh_every=4)
    with metrics.window() as w:
        ph_m.ph_main()
        mega = {k: w.delta(k) for k in names}
    return ph_l, ph_m, legacy, mega


def test_megastep_is_the_default_and_matches_legacy(trajectories):
    ph_l, ph_m, legacy, mega = trajectories
    assert ph_m._megastep_request() == 3 and ph_l._megastep_request() == 0
    assert legacy["dispatch.megasteps"] == 0
    assert mega["dispatch.megasteps"] >= 2
    # every iteration ran, in windows or in the legacy body (the refreshes)
    assert ph_m._iter == ph_l._iter == 12
    assert mega["dispatch.mega_iterations"] + ph_m.solves - 1 == 12
    for name in ("W", "xbars", "local_x"):
        _close(getattr(ph_m, name), getattr(ph_l, name), 1e-9, name)
    assert ph_m.conv == pytest.approx(ph_l.conv, rel=1e-9, abs=1e-12)
    assert mega["dispatch.flops"] > 0


def test_window_host_syncs_are_flag_reads_plus_one_fetch(trajectories):
    """A window's host reads: its solves' stop-flag reads and exactly one
    packed fetch."""
    ph = trajectories[1]
    ph._factors_age = 1
    with metrics.window() as w, hostsync.track() as tr:
        meas = ph._megastep_solve(3, 3, -1.0, ph.W, ph.xbars, ph.rho)
    assert meas["executed"] >= 1
    checks = w.delta("admm.loop_checks")
    assert checks >= meas["executed"]
    assert tr.count == checks + 1
    assert w.delta("host_sync.count") == checks + 1


def test_convthresh_stops_inside_a_window(trajectories):
    """A threshold the legacy loop first crosses at an iteration the
    megastep runs inside a window stops the window there."""
    conv = np.asarray(trajectories[0].conv_trace)
    windowed = [k for k in range(2, 13) if k % 4 != 1]  # 1, 5, 9 refresh
    k = next(k for k in windowed if conv[k - 1] < conv[:k - 1].min())
    th = float(conv[k - 1]) * 1.0000001
    ph_m = _tph(12, 0, convthresh=th, solver_refresh_every=4)
    with metrics.window() as w:
        ph_m.ph_main()
    assert w.delta("dispatch.megasteps") >= 1
    assert ph_m._iter == k
    assert ph_m.conv == pytest.approx(conv[k - 1], rel=1e-9)


def test_forced_n_and_legacy_toggle():
    with metrics.window() as w:
        ph = _tph(6, 4)
        assert ph._megastep_request() == 4
        ph.ph_main()
    # iteration 1 refreshes, then windows of at most 4: 2-5 and 6
    assert w.delta("dispatch.megasteps") == 2
    assert w.delta("dispatch.mega_iterations") == 5
    assert _tph(2, 1)._megastep_request() == 0


def test_extensions_force_legacy():
    class Counting(TExtension):
        calls = 0

        def miditer(self):
            Counting.calls += 1

    ph = _tph(2, 0, extensions=Counting)
    assert ph._megastep_request() == 0
    with metrics.window() as w:
        ph.ph_main()
    assert w.delta("dispatch.megasteps") == 0 and Counting.calls == 2


@pytest.mark.parametrize("option", ["megastep_autotune",
                                    "in_wheel_bound_autotune",
                                    "in_wheel_int_autotune"])
def test_autotuned_options_raise_with_their_item(option):
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        _tph(2, 0, **{option: True})


def test_integer_in_wheel_bounds_raise_with_their_item():
    """An integer family's in-wheel bounds are ported (the batched sweep and
    the escalation, or with both off the single rounded candidate); what
    still raises is the autotuned ladder (item 5) and a bucketed family's
    bound pass (item 7)."""
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 2, "device": "cpu",
            "in_wheel_bounds": True}
    kw = {"num_scens": 3, "use_integer": True}
    names = tfarmer.scenario_names_creator(3)
    ph = TPH(opts, names, tfarmer.scenario_creator,
             scenario_creator_kwargs=kw)
    assert ph._inwheel_int_sweep_on() and ph._integer_escalation_on()
    off = TPH(dict(opts, in_wheel_int_sweep=False, integer_escalation=False),
              names, tfarmer.scenario_creator, scenario_creator_kwargs=kw)
    assert not off._inwheel_int_sweep_on()
    assert not off._integer_escalation_on()
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        TPH(dict(opts, in_wheel_int_autotune=True), names,
            tfarmer.scenario_creator, scenario_creator_kwargs=kw)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        TPH(dict(opts, bundles_per_rank=2, shape_buckets=True,
                 shape_bucket_quantum=1),
            tfarmer.scenario_names_creator(5), tfarmer.scenario_creator,
            scenario_creator_kwargs={"num_scens": 5, "use_integer": True})


def test_billing_is_the_reference_model_and_the_cap_the_cards():
    """Executed iterations only, the reference's model flops; the card's
    window cap is shape-free, less one iteration a bound-pass evaluation."""
    from tpusppy.solvers import segmented as jsegmented
    from tpusppy_torch.solvers import segmented as tsegmented

    with metrics.window() as w:
        f3 = tsegmented.bill_megastep(10, 20, 30, 3, 50.0)
        f6 = tsegmented.bill_megastep(10, 20, 30, 6, 50.0,
                                      sparse_factor=0.25,
                                      rejected_sweeps=40.0)
        fb = tsegmented.bill_bound_pass(10, 20, 30, 70.0)
        assert w.delta("dispatch.mega_iterations") == 9
        assert w.delta("dispatch.megasteps") == 2
        assert w.delta("megastep.rejected_iterations") == 1
        assert w.delta("megastep.bound_passes") == 1
        assert w.delta("dispatch.flops") == pytest.approx(f3 + f6 + fb)
    assert f3 == jsegmented.bill_megastep(10, 20, 30, 3, 50.0)
    assert f6 == jsegmented.bill_megastep(10, 20, 30, 6, 50.0,
                                          sparse_factor=0.25,
                                          rejected_sweeps=40.0)
    assert fb == jsegmented.bill_bound_pass(10, 20, 30, 70.0)
    assert (tsegmented.SPARSE_DISPATCH_FACTOR
            == jsegmented.SPARSE_DISPATCH_FACTOR)
    cap = tsegmented.megastep_cap()
    assert cap == tsegmented.WINDOW_ITERS
    assert tsegmented.megastep_cap(bound_pass=True) == cap - 1
