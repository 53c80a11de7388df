"""The port's content-keyed device-A cache (tpusppy_torch.spopt._device_A) on
CPU tensors: the port of tests/test_dev_cache.py, and cylinders that build
the same shared A holding one device copy of it, dense or SparseA."""

import sys
import threading

import numpy as np
import pytest
import torch

from tpusppy_torch import spopt
from tpusppy_torch.models import uc as tuc
from tpusppy_torch.phbase import PHBase
from tpusppy_torch.scenario_tree import ScenarioNode
from tpusppy_torch.ir import ScenarioProblem
from tpusppy_torch.solvers.sparse import SparseA

torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture
def fresh_cache(monkeypatch):
    monkeypatch.setattr(spopt, "_DEV_A_CACHE", type(spopt._DEV_A_CACHE)())
    yield spopt._DEV_A_CACHE


def test_content_dedup_and_thread_safety(fresh_cache):
    A = np.random.default_rng(0).standard_normal((2048, 2048))  # 32 MB
    n_threads = 8
    copies = [A.copy() for _ in range(n_threads)]
    out = [None] * n_threads

    def worker(i):
        out[i] = spopt._device_A(copies[i], torch.float64, CPU)

    held = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(held)
    assert not any(t.is_alive() for t in threads)
    # identical content: one cache entry, one shared tensor
    assert len(spopt._DEV_A_CACHE) == 1
    assert all(o is out[0] for o in out[1:])
    np.testing.assert_array_equal(out[0].numpy(), A)

    # a new digest at the same (shape, dtype) keeps only the newest prior
    # entry beside it
    for k in range(6):
        spopt._device_A(A + k + 1, torch.float64, CPU)
    assert len(spopt._DEV_A_CACHE) == 2
    d5 = spopt._device_A(A + 6, torch.float64, CPU)
    d4 = spopt._device_A(A + 5, torch.float64, CPU)
    assert spopt._device_A(A + 6, torch.float64, CPU) is d5
    assert spopt._device_A(A + 5, torch.float64, CPU) is d4
    # another dtype is another entry; the LRU holds four at most
    spopt._device_A(A, torch.float32, CPU)
    for k in range(3):
        spopt._device_A(np.ones((1100 + k, 2048)), torch.float64, CPU)
    assert len(spopt._DEV_A_CACHE) == 4

    spopt.clear_device_caches()
    assert len(spopt._DEV_A_CACHE) == 0

    # small dense matrices bypass the cache
    spopt._device_A(np.ones((8, 8)), torch.float64, CPU)
    assert len(spopt._DEV_A_CACHE) == 0
    # a sparse upload is always cached, whatever its size
    sp = spopt._device_A(np.eye(8), torch.float64, CPU, sparse=True)
    assert isinstance(sp, SparseA) and len(spopt._DEV_A_CACHE) == 1
    assert spopt._device_A(np.eye(8), torch.float64, CPU, sparse=True) is sp


_BIG_A = {}


def _big_shared_creator(name, num_scens=3):
    """Scenarios sharing one (1500, 1400) float64 A (16.8 MB, above the
    cache's floor); rhs differ."""
    A = _BIG_A.get("A")
    if A is None:
        rng = np.random.default_rng(3)
        A = _BIG_A["A"] = np.abs(rng.standard_normal((1500, 1400)))
    s = int(name.split("_")[1])
    n, m = A.shape[1], A.shape[0]
    return ScenarioProblem(
        name=name, c=np.ones(n), q2=np.zeros(n), A=A,
        cl=np.full(m, 1.0 + s), cu=np.full(m, np.inf), lb=np.zeros(n),
        ub=np.full(n, 10.0), is_int=np.zeros(n, dtype=bool), prob=None,
        nodes=[ScenarioNode("ROOT", 1.0, 1, np.array([0, 1]))])


def _two(options, names, creator, kw=None):
    return [PHBase(dict(options, device="cpu", defaultPHrho=1.0,
                        PHIterLimit=1), names, creator,
                   scenario_creator_kwargs=kw) for _ in range(2)]


def test_two_opts_share_one_dense_device_A(fresh_cache):
    names = [f"scen_{s}" for s in range(3)]
    a, b = _two({"sparse_device_A": False}, names, _big_shared_creator)
    assert a.batch is not b.batch and a.batch.A_shared is not None
    Aa = a._device_consts(torch.float64)[0]
    Ab = b._device_consts(torch.float64)[0]
    assert isinstance(Aa, torch.Tensor) and Aa.shape == (1500, 1400)
    assert Aa is Ab and len(spopt._DEV_A_CACHE) == 1
    # cl and cu stay each opt's own
    assert a._device_consts(torch.float64)[1] is not \
        b._device_consts(torch.float64)[1]
    spopt.clear_device_caches()
    assert a._device_consts(torch.float64)[0] is Aa    # the opt's own cache
    assert len(spopt._DEV_A_CACHE) == 0


def test_two_opts_share_one_sparse_device_A(fresh_cache):
    kw = {"num_scens": 3, "num_gens": 3, "horizon": 6,
          "relax_integers": True}
    names = tuc.scenario_names_creator(3)
    a, b = _two({"sparse_device_A": True}, names, tuc.scenario_creator, kw)
    Aa = a._device_consts(torch.float64)[0]
    assert isinstance(Aa, SparseA)
    assert b._device_consts(torch.float64)[0] is Aa
    # a solve derives its factors per opt and leaves the shared A as it was
    vals = [v.clone() for v in Aa.values()]
    a.solve_loop()
    b.solve_loop()
    assert a._factors is not b._factors
    for v, w in zip(Aa.values(), vals):
        assert torch.equal(v, w)
    np.testing.assert_allclose(a.local_x, b.local_x, rtol=0, atol=1e-12)
    # the f32 upload is another entry
    assert a._device_consts(torch.float32)[0] is not Aa
    assert len(spopt._DEV_A_CACHE) == 2


def test_dispatch_helpers_take_the_shared_matrix():
    """``dispatch_A`` and ``batch_solve_dispatch`` hand the shared-A engine
    the one (m, n) matrix (and the dense engine the per-scenario tensor,
    sliced by ``rows`` and tiled), and ``mega_arrays_for_batch`` builds a
    batch's window arrays (its own tree's probabilities) without an opt
    object."""
    from tpusppy_torch.models import farmer, uc_lite
    from tpusppy_torch.solvers import admm, shared_admm
    from tpusppy_torch.solvers.admm import ADMMSettings
    from tpusppy_torch.spbase import build_batch

    kw = {"num_scens": 3, "num_gens": 3, "horizon": 6,
          "relax_integers": True}
    b, _ = build_batch(uc_lite.scenario_names_creator(3),
                       uc_lite.scenario_creator, kw)
    assert spopt.dispatch_A(b) is b.A_shared
    st = ADMMSettings(max_iter=200)
    args = (b.c, b.q2, b.cl, b.cu, b.lb, b.ub)
    sol = spopt.batch_solve_dispatch(b, *args, st, device="cpu")
    ref = shared_admm.solve_shared(b.c, b.q2, b.A_shared, *args[2:],
                                   settings=st, device="cpu")
    assert torch.equal(sol.x, ref.x)
    arr = spopt.mega_arrays_for_batch(b, torch.float64, CPU, sparse=False)
    assert arr.A.shape == b.A_shared.shape
    np.testing.assert_array_equal(arr.probs.numpy(), b.tree.scen_prob)
    np.testing.assert_array_equal(arr.nid_sk.numpy(), b.tree.nid_sk())

    f, _ = build_batch(farmer.scenario_names_creator(3),
                       farmer.scenario_creator, {"num_scens": 3})
    assert spopt.dispatch_A(f) is f.A
    rows = np.array([2, 0])

    def rep(v):
        return np.repeat(v[rows], 2, axis=0)

    sol = spopt.batch_solve_dispatch(
        f, *(rep(v) for v in (f.c, f.q2, f.cl, f.cu, f.lb, f.ub)), st,
        rows=rows, tile=2, device="cpu")
    ref = admm.solve_batch(*(rep(v) for v in (f.c, f.q2)), rep(f.A),
                           *(rep(v) for v in (f.cl, f.cu, f.lb, f.ub)),
                           settings=st, device="cpu")
    assert torch.equal(sol.x, ref.x)
