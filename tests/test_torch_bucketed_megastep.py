"""The port's bucketed megastep (tpusppy_torch.parallel.sharded.
make_bucketed_wheel_megastep, SPOpt._megastep_solve_bucketed and PHBase's
bucketed windows) against the reference's, float64 on the CPU.

farmer 7 scenarios in 3 bundles at bucket quantum 1: two buckets.  The
reference runs Iter0 and one legacy iteration; its state (W, xbars, rho and
each bucket's warm state and refresh factors) is carried into a port PH
(``tpusppy_torch.convert``), and ONE bucketed window on each agrees to
1e-9 (the packed per-iteration stats, the scattered x, W, xbars and
residuals; the executed count, the refresh flag, the done flags and the
sweep counts equal).  The port's ``ph_main()`` at the default options runs
bucketed windows, agrees with its legacy loop to 1e-9 and with the
reference's default run to 1e-7, and counts every iteration once.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusppy.models import farmer as jfarmer
from tpusppy.opt.ph import PH as JPH
from tpusppy_torch import convert
from tpusppy_torch import ir as tir
from tpusppy_torch.models import farmer as tfarmer
from tpusppy_torch.obs import metrics
from tpusppy_torch.opt.ph import PH as TPH
from tpusppy_torch.parallel import sharded as tsharded

torch.set_num_threads(1)

N = 7
NAMES = tfarmer.scenario_names_creator(N)
KW = {"num_scens": N}
OPTS = {"bundles_per_rank": 3, "shape_buckets": True,
        "shape_bucket_quantum": 1, "defaultPHrho": 1.0, "convthresh": -1.0}
PER_ITER = ("conv", "eobj", "pri_max", "dua_max")
SCATTERED = ("pri", "dua", "x", "W", "xbars")


def _close(got, ref, tol, what=""):
    """Within ``tol`` of ``ref``'s largest finite entry (floored at 1),
    non-finite entries equal."""
    got = np.asarray(got, dtype=float)
    ref = np.asarray(ref, dtype=float)
    assert got.shape == ref.shape, what
    fin = np.isfinite(ref)
    np.testing.assert_array_equal(got[~fin], ref[~fin], err_msg=what)
    got, ref = got[fin], ref[fin]
    scale = max(1.0, float(np.max(np.abs(ref))) if ref.size else 1.0)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} * {scale:.3g}"


def _slot_factors(f):
    return {k: np.asarray(v) for k, v in f._asdict().items()}


@pytest.fixture(scope="module")
def carried():
    """(reference PH, port PH) at the reference's state after Iter0 and one
    legacy iteration: every bucket frozen-ready."""
    opts = dict(OPTS, PHIterLimit=40, solver_options={"megastep": 1})
    jph = JPH(opts, NAMES, jfarmer.scenario_creator,
              scenario_creator_kwargs=KW)
    jph.Iter0()
    jph._iterk_one(1, -1.0)
    tph = TPH(dict(opts, device="cpu"), NAMES, tfarmer.scenario_creator,
              scenario_creator_kwargs=KW)
    slots = jph._bucket_slots
    convert.load_ph_state(
        tph, jph.W, jph.xbars, jph.rho,
        warm=[tuple(np.asarray(v) for v in s["warm"]) for s in slots],
        factors=[_slot_factors(s["factors"]) for s in slots],
        factors_age=[s["age"] for s in slots], iteration=jph._iter)
    tph.pri_res = np.asarray(jph.pri_res)
    tph.dua_res = np.asarray(jph.dua_res)
    return jph, tph


def test_carried_batch_and_slots(carried):
    """The reference's BucketedBatch comes over field by field, and the
    carried slots are ready for a window as the reference's are."""
    jph, tph = carried
    tb = convert.bucketed_batch_from_arrays(**dataclasses.asdict(jph.batch))
    assert len(tb.buckets) == len(tph.batch.buckets) == 2
    for (ti, ts), (pi, ps) in zip(tb.buckets, tph.batch.buckets):
        np.testing.assert_array_equal(ti, pi)
        for f in ("c", "q2", "A", "cl", "cu", "lb", "ub"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(ps, f))
    for f in ("c", "q2", "lb", "ub", "cl", "cu", "const"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(tph.batch, f))
    re = tph._refresh_every()
    assert jph._mega_slots_ready(re) and tph._mega_slots_ready(re)
    assert tph._mega_age() == jph._mega_age()


def _snapshot(ph):
    """A copy of ``ph``'s bucket slots (the reference's window donates its
    warm buffers, so they are copied)."""
    return [dict(s, warm=tuple(jnp.array(v, copy=True) if hasattr(v, "device")
                               and not isinstance(v, torch.Tensor)
                               else v.clone() for v in s["warm"]))
            for s in ph._bucket_slots]


@pytest.mark.parametrize("n_live", [1, 4])
def test_one_bucketed_window_matches_reference(carried, n_live):
    jph, tph = carried
    saved, jsaved = _snapshot(tph), _snapshot(jph)
    try:
        jm = jph._megastep_solve_bucketed(6, n_live, -1.0, jph.W, jph.xbars,
                                          jph.rho)
        with metrics.window() as w:
            tm = tph._megastep_solve_bucketed(6, n_live, -1.0, tph.W,
                                              tph.xbars, tph.rho)
            assert w.delta("dispatch.megasteps") == 1
            assert w.delta("dispatch.mega_iterations") == tm["executed"]
    finally:
        tph._bucket_slots = saved
        jph._bucket_slots = jsaved
    assert tm["executed"] == jm["executed"] == n_live
    assert tm["refresh_hit"] == jm["refresh_hit"] is False
    np.testing.assert_array_equal(tm["iters"], np.asarray(jm["iters"]))
    np.testing.assert_array_equal(tm["all_done"], np.asarray(jm["all_done"]))
    np.testing.assert_array_equal(tm["done"], np.asarray(jm["done"]))
    for k in PER_ITER + SCATTERED:
        _close(tm[k], jm[k], 1e-9, k)


def test_bucketed_window_stops_on_a_rejected_iterate(carried):
    """An acceptance ladder no iterate meets: the first iterate is refused,
    nothing is installed, and each bucket's slot ages out, as the
    reference's."""
    jph, tph = carried
    saved, jsaved = _snapshot(tph), _snapshot(jph)
    try:
        for ph in (jph, tph):
            ph.options["straggler_tol_qp"] = 1e-30
        jm = jph._megastep_solve_bucketed(4, 4, -1.0, jph.W, jph.xbars,
                                          jph.rho)
        tm = tph._megastep_solve_bucketed(4, 4, -1.0, tph.W, tph.xbars,
                                          tph.rho)
        ages = [s["age"] for s in tph._bucket_slots]
    finally:
        for ph in (jph, tph):
            ph.options.pop("straggler_tol_qp")
        tph._bucket_slots = saved
        jph._bucket_slots = jsaved
    assert tm["executed"] == jm["executed"]
    assert tm["refresh_hit"] == jm["refresh_hit"]
    if not tm["all_done"][0]:
        assert tm["executed"] == 0 and tm["refresh_hit"]
        assert ages == [tph._refresh_every()] * 2
    _close(tm["pri_max"], jm["pri_max"], 1e-9, "pri_max")


def test_measure_len_matches_the_pack(carried):
    _, tph = carried
    shapes = [(idx.size, sub.num_vars) for idx, sub in tph.batch.buckets]
    K = tph.nonant_length
    vec = np.arange(tsharded.bucketed_megastep_measure_len(5, shapes, K))
    out = tsharded.bucketed_megastep_unpack(vec, 5, shapes, K)
    assert [x.shape for x in out["x"]] == [(s, n) for s, n in shapes]
    assert out["xbars"][-1][-1, -1] == vec[-1]


class _Counted:
    @staticmethod
    def wrap(base):
        class Counted(base):
            def _apply_megastep_meas(self, k, meas):
                super()._apply_megastep_meas(k, meas)
                self.window_iters = getattr(self, "window_iters", 0) \
                    + meas["executed"]

        return Counted


#: The default runs: a refresh every 4 iterations (windows of 3) and eps
#: 1e-6 keep them short; 8 iterations hold two windows.
DEFAULT_RUN = dict(OPTS, PHIterLimit=8, solver_refresh_every=4)
DEFAULT_SOLVER = {"eps_abs": 1e-6, "eps_rel": 1e-6}


@pytest.fixture(scope="module")
def default_runs():
    """The port at the default options (windows) and in the legacy loop,
    and the reference at its default."""
    out = {}
    for mega in (0, 1):
        ph = _Counted.wrap(TPH)(
            dict(DEFAULT_RUN, device="cpu",
                 solver_options=dict(DEFAULT_SOLVER, megastep=mega)),
            NAMES, tfarmer.scenario_creator, scenario_creator_kwargs=KW)
        with metrics.window() as w:
            res = ph.ph_main()
            out[mega] = (ph, res, w.delta("dispatch.megasteps"),
                         w.delta("dispatch.mega_iterations"))
    jph = JPH(dict(DEFAULT_RUN, solver_options=DEFAULT_SOLVER), NAMES,
              jfarmer.scenario_creator, scenario_creator_kwargs=KW)
    out["ref"] = (jph, jph.ph_main())
    return out


def test_bucketed_windows_match_legacy(default_runs):
    ph, (conv, eobj, _), megasteps, mega_iters = default_runs[0]
    lph, (lconv, leobj, _), lmegasteps, _ = default_runs[1]
    assert isinstance(ph.batch, tir.BucketedBatch)
    assert ph._megastep_request() == ph._refresh_every() - 1
    assert megasteps >= 1 and lmegasteps == 0
    # every iteration once: windows' plus the legacy body's (Iter0 aside)
    assert mega_iters == ph.window_iters
    assert ph.window_iters + ph.solves - 1 == ph._iter == 8
    assert ("plain_calls", "fused_sweeps") in ph.window_launches
    # each bucket's frozen solves ran inside the windows
    assert len(ph.bucket_window_launches) == 2
    assert all(d.get(("plain_calls", "fused_sweeps"), 0) > 0
               for d in ph.bucket_window_launches)
    assert eobj == pytest.approx(leobj, rel=1e-9)
    assert conv == pytest.approx(lconv, rel=1e-9, abs=1e-12)
    _close(ph.W, lph.W, 1e-9, "W")
    _close(ph.xbars, lph.xbars, 1e-9, "xbars")


def test_bucketed_ph_main_default_matches_reference(default_runs):
    ph, (conv, eobj, tbound), _, _ = default_runs[0]
    jph, (jconv, jeobj, jtbound) = default_runs["ref"]
    assert ph._iter == jph._iter == 8
    assert eobj == pytest.approx(jeobj, rel=1e-7)
    assert tbound == pytest.approx(jtbound, rel=1e-7)
    assert conv == pytest.approx(jconv, rel=1e-7, abs=1e-9)
    _close(ph.W, np.asarray(jph.W), 1e-7, "W")
    _close(ph.xbars, np.asarray(jph.xbars), 1e-7, "xbars")


def test_one_owner_keeps_an_operand_per_bucket_shape():
    """The buckets of one owner's window alternate their kernel operands
    (the lowered modes' bf16 copies): one is kept for each shape, so they
    do not repack each other's."""
    from tpusppy_torch.solvers import cuda_kernels, device_loop

    A, B = torch.ones(3, 2, 2), torch.ones(2, 4, 5)
    made = []

    def make(tag):
        made.append(tag)
        return tag

    with cuda_kernels.owned_by("window"):
        for _ in range(2):
            assert cuda_kernels._cached("t", (A,), 0, lambda: make("a")) \
                == "a"
            assert cuda_kernels._cached("t", (B,), 0, lambda: make("b")) \
                == "b"
    assert made == ["a", "b"]
    device_loop.release("window")
