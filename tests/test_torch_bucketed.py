"""The port's shape-bucketed ragged families (tpusppy_torch.ir.BucketedBatch,
SPOpt's bucketed solve and dual bound, Xhat_Eval's bucketed evaluation)
against the reference's, float64 on the CPU.

farmer 7 scenarios in 3 bundles (3, 2 and 2 scenarios) at bucket quantum 1
is the ragged family: two buckets.  The port's BucketedBatch equals the
reference's exactly (bucket indices, each bucket's sub-batch, the padded
bookkeeping arrays, ``padded_elements`` and ``objective``); the legacy
bucketed PH (``megastep`` 1) follows the reference's trajectory to 1e-7;
the certified per-scenario dual bound agrees with the reference's to 1e-9
and the bucketed xhat evaluation to 1e-7.  The global nonant indices are each
bucket's own (a bundle puts its root nonants first).  An integer bucket's
evaluation and in-wheel bounds on a bucketed batch raise with their
ROADMAP items, and a ragged family whose buckets each share one A runs
each multi-member bucket on the shared-A engine (``bucket_shared``).
"""

import numpy as np
import pytest
import torch

from tpusppy import bundles as jbundles
from tpusppy import ir as jir
from tpusppy.models import farmer as jfarmer
from tpusppy.opt.ph import PH as JPH
from tpusppy.phbase import PHBase as JPHBase
from tpusppy.scenario_tree import ScenarioNode as JNode
from tpusppy.xhat_eval import Xhat_Eval as JXhat
from tpusppy_torch import bundles as tbundles
from tpusppy_torch import ir as tir
from tpusppy_torch.models import farmer as tfarmer
from tpusppy_torch.models import uc_lite as tuc_lite
from tpusppy_torch.opt.ph import PH as TPH
from tpusppy_torch.parallel import sharded as tsharded
from tpusppy_torch.phbase import PHBase as TPHBase
from tpusppy_torch.scenario_tree import ScenarioNode as TNode
from tpusppy_torch.solvers import cuda_kernels
from tpusppy_torch.solvers import scipy_backend as tscipy
from tpusppy_torch.spopt import bucket_shared
from tpusppy_torch.xhat_eval import Xhat_Eval as TXhat

torch.set_num_threads(1)

N = 7
NAMES = tfarmer.scenario_names_creator(N)
KW = {"num_scens": N}
BUCKETED = {"bundles_per_rank": 3, "shape_buckets": True,
            "shape_bucket_quantum": 1}
SUB_ARRAYS = ("c", "q2", "A", "cl", "cu", "lb", "ub", "is_int", "const")
PADDED = ("c", "q2", "lb", "ub", "cl", "cu", "const")


def _bucketed_pair(quantum=1):
    jp = [jfarmer.scenario_creator(nm, **KW) for nm in NAMES]
    tp = [tfarmer.scenario_creator(nm, **KW) for nm in NAMES]
    return (jir.BucketedBatch.from_problems(jbundles.form_bundles(jp, 3),
                                            quantum),
            tir.BucketedBatch.from_problems(tbundles.form_bundles(tp, 3),
                                            quantum))


def _same_bucketed(tb, jb):
    assert tb.names == jb.names
    assert len(tb.buckets) == len(jb.buckets)
    for (ti, ts), (ji, js) in zip(tb.buckets, jb.buckets):
        np.testing.assert_array_equal(ti, ji)
        for f in SUB_ARRAYS:
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f),
                                          err_msg=f)
        np.testing.assert_array_equal(ts.tree.scen_prob, js.tree.scen_prob)
        np.testing.assert_array_equal(ts.tree.nonant_indices,
                                      js.tree.nonant_indices)
        assert (ts.A_shared is None) == (js.A_shared is None)
    for f in PADDED:
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f),
                                      err_msg=f)
    np.testing.assert_array_equal(tb.tree.scen_prob, jb.tree.scen_prob)
    np.testing.assert_array_equal(tb.tree.nonant_indices,
                                  jb.tree.nonant_indices)


def test_bucketed_batch_matches_reference():
    jb, tb = _bucketed_pair()
    _same_bucketed(tb, jb)
    assert len(tb.buckets) == 2
    assert [i.size for i, _ in tb.buckets] == [2, 1]
    assert tb.padded_elements() == jb.padded_elements()
    tp = [tfarmer.scenario_creator(nm, **KW) for nm in NAMES]
    naive = tir.ScenarioBatch.from_problems(tbundles.form_bundles(tp, 3))
    assert tb.padded_elements() < (naive.num_scenarios * naive.num_rows
                                   * naive.num_vars)
    assert tb.probs.sum() == pytest.approx(1.0, abs=1e-15)
    x = np.random.default_rng(0).standard_normal((3, tb.num_vars))
    np.testing.assert_array_equal(tb.objective(x), jb.objective(x))
    np.testing.assert_array_equal(tb.nonant_mask(), jb.nonant_mask())
    with pytest.raises(AttributeError, match="bucketing exists to avoid"):
        tb.A
    assert tb.A_shared is None
    # the default quantum buckets this family too: 16 rounds (19, 14) and
    # (27, 21) to different rows
    _same_bucketed(*_bucketed_pair(16)[::-1])


def test_global_nonant_indices_are_each_buckets_root_nonants():
    """The global nonant columns index every bucket's column space: a
    bundle's EF puts the root nonants first, so the bundle's columns
    0..K-1 carry its members' nonants (their costs, probability
    weighted)."""
    ph = TPHBase(dict(BUCKETED, defaultPHrho=1.0, PHIterLimit=1,
                      device="cpu"), NAMES, tfarmer.scenario_creator,
                 scenario_creator_kwargs=KW)
    b = ph.batch
    assert isinstance(b, tir.BucketedBatch)
    nid = ph.tree.nonant_indices
    K = ph.nonant_length
    np.testing.assert_array_equal(nid, np.arange(K))
    scen = [tfarmer.scenario_creator(nm, **KW) for nm in NAMES]
    members = np.array_split(np.arange(N), 3)
    for idx, sub in b.buckets:
        np.testing.assert_array_equal(sub.tree.nonant_indices, nid)
        for j, s in enumerate(idx):
            mem = [scen[i] for i in members[s]]
            w = np.array([p.prob if p.prob is not None else 1.0 / N
                          for p in mem])
            want = sum((wi / w.sum()) * p.c[p.nonant_indices()]
                       for wi, p in zip(w, mem))
            np.testing.assert_allclose(sub.c[j, nid], want, rtol=1e-15)


class _Traced:
    @staticmethod
    def wrap(base):
        class Traced(base):
            def Iter0(self):
                tb = super().Iter0()
                self.trace = [(self.conv, self.Eobjective(), self.W.copy())]
                return tb

            def _iterk_one(self, k, convthresh):
                out = super()._iterk_one(k, convthresh)
                self.trace.append((self.conv, self.Eobjective(),
                                   self.W.copy()))
                return out

        return Traced


def test_bucketed_legacy_ph_matches_reference():
    opts = dict(BUCKETED, defaultPHrho=1.0, PHIterLimit=6, convthresh=-1.0,
                solver_options={"megastep": 1})
    jph = _Traced.wrap(JPH)(opts, NAMES, jfarmer.scenario_creator,
                            scenario_creator_kwargs=KW)
    tph = _Traced.wrap(TPH)(dict(opts, device="cpu"), NAMES,
                            tfarmer.scenario_creator,
                            scenario_creator_kwargs=KW)
    assert isinstance(tph.batch, tir.BucketedBatch)
    assert tph.admm_settings.max_iter == 4000
    _, je, jt = jph.ph_main()
    _, te, tt = tph.ph_main()
    assert te == pytest.approx(je, rel=1e-7)
    assert tt == pytest.approx(jt, rel=1e-7)
    for i, ((tc, tev, tw), (jc, jev, jw)) in enumerate(zip(tph.trace,
                                                           jph.trace)):
        assert tev == pytest.approx(jev, rel=1e-7), i
        assert tc == pytest.approx(jc, rel=1e-7, abs=1e-7), i
        np.testing.assert_allclose(tw, jw, rtol=0,
                                   atol=1e-7 * max(1.0, np.abs(jw).max()))
    assert len(tph.trace) == 7
    np.testing.assert_allclose(tph.xbars, np.asarray(jph.xbars), rtol=0,
                               atol=1e-7 * np.abs(jph.xbars).max())


@pytest.fixture(scope="module")
def solved_pair():
    opts = dict(BUCKETED, defaultPHrho=1.0, PHIterLimit=1, convthresh=-1.0)
    jph = JPHBase(opts, NAMES, jfarmer.scenario_creator,
                  scenario_creator_kwargs=KW)
    tph = TPHBase(dict(opts, device="cpu"), NAMES, tfarmer.scenario_creator,
                  scenario_creator_kwargs=KW)
    jph.solve_loop()
    tph.solve_loop()
    return jph, tph


def test_bucketed_dual_bound_matches_reference(solved_pair):
    jph, tph = solved_pair
    np.testing.assert_allclose(tph.local_x, np.asarray(jph.local_x),
                               rtol=0, atol=1e-7 * np.abs(jph.local_x).max())
    jv = np.asarray(jph.Edualbound_perscen())
    tv = tph.Edualbound_perscen()
    np.testing.assert_allclose(tv, jv, rtol=1e-9)
    # the X-cap margin prices reduced costs that are near cancellations
    # (~1e-6 here), so it is held on the scale of the bound it corrects
    np.testing.assert_allclose(tph.last_bound_margin,
                               np.asarray(jph.last_bound_margin), rtol=0,
                               atol=1e-9 * np.abs(jv).max())
    bound = tph.Edualbound()
    exact = 0.0
    for idx, sub in tph.batch.buckets:
        for j, s in enumerate(idx):
            r = tscipy.solve_lp(sub.c[j], sub.A[j], sub.cl[j], sub.cu[j],
                                sub.lb[j], sub.ub[j])
            exact += tph.probs[s] * (r.obj + tph.batch.const[s])
    assert bound <= exact + 1e-6 * abs(exact)
    assert bound >= exact - 1e-3 * abs(exact)
    assert tph.dual_donor_bounds() is None
    with pytest.raises(RuntimeError, match="prior solve_loop"):
        TPHBase(dict(BUCKETED, defaultPHrho=1.0, PHIterLimit=1,
                     device="cpu"), NAMES, tfarmer.scenario_creator,
                scenario_creator_kwargs=KW).Edualbound()


def test_bucketed_xhat_eval_matches_reference():
    opts = dict(BUCKETED)
    jev = JXhat(opts, NAMES, jfarmer.scenario_creator,
                scenario_creator_kwargs=KW)
    tev = TXhat(dict(opts, device="cpu"), NAMES, tfarmer.scenario_creator,
                scenario_creator_kwargs=KW)
    assert isinstance(tev.batch, tir.BucketedBatch)
    K = tev.nonant_length
    cand = np.array([170.0, 80.0, 250.0] * (K // 3))[:K]
    jz = jev.evaluate(cand)
    tz = tev.evaluate(cand)
    assert np.isfinite(tz)
    assert tz == pytest.approx(jz, rel=1e-7)
    np.testing.assert_allclose(tev.objective_values(cand),
                               np.asarray(jev.objective_values(cand)),
                               rtol=1e-7)
    # the opt object is the bucketed batch again afterwards
    assert isinstance(tev.batch, tir.BucketedBatch)
    assert tev.local_x.shape == (3, tev.batch.num_vars)


def test_integer_buckets_and_bucketed_in_wheel_bounds_raise():
    kw = {"num_scens": 5, "num_gens": 3, "horizon": 6}
    names = tuc_lite.scenario_names_creator(5)
    ev = TXhat(dict(BUCKETED, bundles_per_rank=2, device="cpu"), names,
               tuc_lite.scenario_creator, scenario_creator_kwargs=kw)
    assert isinstance(ev.batch, tir.BucketedBatch)
    assert any(sub.is_int.any() for _, sub in ev.batch.buckets)
    with pytest.raises(AttributeError, match="shared is_int"):
        ev.batch.is_int
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        ev.evaluate(np.ones(ev.nonant_length))
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        TPH(dict(BUCKETED, defaultPHrho=1.0, PHIterLimit=2, device="cpu",
                 in_wheel_bounds=True), NAMES, tfarmer.scenario_creator,
            scenario_creator_kwargs=KW)
    st = TPH(dict(BUCKETED, defaultPHrho=1.0, PHIterLimit=2, device="cpu"),
             NAMES, tfarmer.scenario_creator,
             scenario_creator_kwargs=KW).admm_settings
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tsharded.make_bucketed_wheel_megastep(np.arange(3), st, 4,
                                              bounds=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        tsharded.make_bucketed_wheel_megastep(np.arange(3), st, 4,
                                              int_rounding=(0.5,))


# ---- a ragged family whose buckets each share one A -------------------------
_SHARED_A = {}


def _shared_family(ir, Node):
    """Scenarios 0-3 share one (6, 5) A, 4-6 one (8, 7) A (the same object
    within a shape); columns 0 and 1 are the nonants, costs and
    right-hand sides differ by scenario."""
    def creator(name, num_scens=7):
        s = int(name.split("_")[1])
        n, m = (5, 6) if s < 4 else (7, 8)
        key = (ir.__name__, n)
        if key not in _SHARED_A:
            rng = np.random.default_rng(n)
            _SHARED_A[key] = np.abs(rng.standard_normal((m, n))) + 0.1
        A = _SHARED_A[key]
        rng = np.random.default_rng(100 + s)
        return ir.ScenarioProblem(
            name=name, c=1.0 + rng.random(n), q2=np.zeros(n), A=A,
            cl=1.0 + rng.random(m), cu=np.full(m, np.inf),
            lb=np.zeros(n), ub=np.full(n, 10.0),
            is_int=np.zeros(n, dtype=bool), prob=None,
            nodes=[Node("ROOT", 1.0, 1, np.array([0, 1]))])
    return creator


def test_shared_buckets_run_the_shared_engine():
    names = [f"scen_{s}" for s in range(7)]
    opts = {"shape_buckets": True, "shape_bucket_quantum": 1,
            "defaultPHrho": 1.0, "PHIterLimit": 1}
    jph = JPHBase(opts, names, _shared_family(jir, JNode))
    tph = TPHBase(dict(opts, device="cpu"), names, _shared_family(tir, TNode))
    b = tph.batch
    assert isinstance(b, tir.BucketedBatch) and len(b.buckets) == 2
    assert all(bucket_shared(sub) for _, sub in b.buckets)
    # one (m, n) device matrix a bucket, never the broadcast view
    consts = tph._bucket_device_consts(torch.float64)
    assert [A.ndim for A, _, _ in consts] == [2, 2]
    cuda_kernels.reset_counts()
    tph.solve_loop()
    assert cuda_kernels.plain_calls["fused_sweeps_shared"] > 0
    assert cuda_kernels.plain_calls["fused_sweeps"] == 0
    jph.solve_loop()
    np.testing.assert_allclose(tph.local_x, np.asarray(jph.local_x),
                               rtol=0, atol=1e-7)
    np.testing.assert_allclose(tph.Edualbound_perscen(),
                               np.asarray(jph.Edualbound_perscen()),
                               rtol=1e-7)
