"""The port's sparse and structured-KKT engines against the reference's.

``tpusppy_torch.solvers.sparse`` (SparseA, the ELL twin, structure
detection), ``structured_kkt`` (block/Woodbury factors), the plain version
of the ``fused_sweeps_sparse`` kernel, the shared-A engine on a SparseA, and
uc PH on it, each held against the JAX package on the same inputs (seeded
numpy arrays, or the uc model's own scenarios), in float64 on the CPU.
Tolerances, relative to the largest entry (floored at 1):

- ELL indices and structure: exactly equal (integer bookkeeping);
- SparseA products, the structured factors and their kernel layout's
  apply: 1e-10 (summation order only);
- the plain sweep against the Pallas interpreter: 1e-12 (the same slot-by-
  slot recurrence);
- shared solves (adaptive, factored, frozen) and a carried PH state: 1e-9.
  Both packages apply the structured K^-1 through the Woodbury operator;
- PH trajectories (W, xbar, eobj per iteration): 1e-7, as the other PH
  parity tests.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusppy.extensions.extension import Extension as JExtension
from tpusppy.ir import ScenarioBatch as JBatch
from tpusppy.models import uc as juc
from tpusppy.opt.ph import PH as JPH
from tpusppy.solvers import admm as jadmm
from tpusppy.solvers import pallas_kernels
from tpusppy.solvers import shared_admm as jshared
from tpusppy.solvers import structured_kkt as jsk
from tpusppy.solvers.admm import ADMMSettings as JSettings
from tpusppy.solvers.sparse import SparseA as JSparseA
from tpusppy.solvers.sparse import _build_ell as j_build_ell
from tpusppy.solvers.sparse import detect_structure as jdetect
from tpusppy_torch import convert
from tpusppy_torch.ef import solve_ef
from tpusppy_torch.extensions.extension import Extension as TExtension
from tpusppy_torch.models import uc as tuc
from tpusppy_torch.opt.ph import PH as TPH
from tpusppy_torch.solvers import admm as tadmm
from tpusppy_torch.solvers import cuda_kernels
from tpusppy_torch.solvers import shared_admm as tshared
from tpusppy_torch.solvers import sparse as tsparse
from tpusppy_torch.solvers import structured_kkt as tsk
from tpusppy_torch.solvers.admm import ADMMSettings as TSettings
from tpusppy_torch.spbase import build_batch
from tpusppy_torch.spopt import SPOpt

torch.set_num_threads(1)

SETTINGS = dict(max_iter=200, restarts=2)


def _close(got, ref, tol, what=""):
    got = np.asarray(got, dtype=float)
    ref = np.asarray(ref, dtype=float)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.max(np.abs(ref))) if ref.size else 1.0)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} * {scale:.3g}"


def _block_lp(seed=42, n_blk=6, bs=5, S=5):
    """tests/test_sparse_structured.py's block-structured random LP: six
    5-variable blocks with 7 narrow rows each, plus 3 wide coupling rows."""
    rng = np.random.default_rng(seed)
    n = n_blk * bs
    rows = []
    for k in range(n_blk):
        for _ in range(7):
            r = np.zeros(n)
            idx = rng.choice(np.arange(k * bs, (k + 1) * bs), 3,
                             replace=False)
            r[idx] = rng.normal(size=3)
            rows.append(r)
    for _ in range(3):
        rows.append(np.where(rng.random(n) < 0.6, rng.normal(size=n), 0.0))
    A = np.array(rows)
    b = rng.normal(size=(S, n)) @ A.T
    c = rng.normal(size=(S, n))
    return (A, c, b - 1.0, b + 1.0, np.full((S, n), -10.0),
            np.full((S, n), 10.0))


def _uc_A(num_gens=3, horizon=4):
    """The uc model's shared A at a small size."""
    b, _ = build_batch(tuc.scenario_names_creator(2), tuc.scenario_creator,
                       {"num_scens": 2, "num_gens": num_gens,
                        "horizon": horizon, "relax_integers": True})
    return b.A_shared


def _both_sparse(A, structure=False, **kw):
    j = JSparseA.from_dense(A, jnp.float64, structure=structure, ell=True,
                            **kw)
    t = tsparse.SparseA.from_dense(A, torch.float64, "cpu",
                                   structure=structure, **kw)
    return j, t


# ---- SparseA, ELL and structure ---------------------------------------------

@pytest.mark.parametrize("which", ["random", "wide", "uc"])
def test_sparse_ops_match_reference(which):
    rng = np.random.default_rng(0)
    if which in ("random", "wide"):
        m, n = 40, 30
        A = np.where(rng.random((m, n)) < 0.1, rng.normal(size=(m, n)), 0.0)
        A[3, :] = 0.0       # an empty row and an empty column
        A[:, 7] = 0.0
        if which == "wide":
            # rows past NARROW_K non-zeros: A x takes them from the dense
            # product
            A[[5, 17, 30], :] = rng.normal(size=(3, n))
            A[[5, 17, 30], 7] = 0.0
    else:
        A = _uc_A()
        m, n = A.shape
    j, t = _both_sparse(A)
    assert t.ndim == 2 and t.shape == (m, n) and t.nnz == j.nnz
    assert t.dtype == torch.float64 and t.astype(torch.float32).dtype == \
        torch.float32
    for f in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)))
    # the ELL twin: indices exactly equal, values too
    for f in ("rowcols", "rowvals", "colrows", "colvals"):
        np.testing.assert_array_equal(getattr(t.ell, f).numpy(),
                                      np.asarray(getattr(j.ell, f)))
    assert t.ell.rowcols.dtype == torch.int32
    S = 5
    x = rng.normal(size=(S, n))
    y = rng.normal(size=(S, m))
    _close(t.matvec(torch.as_tensor(x)), j.matvec(jnp.asarray(x)), 1e-10,
           "matvec")
    _close(t.rmatvec(torch.as_tensor(y)), j.rmatvec(jnp.asarray(y)), 1e-10,
           "rmatvec")
    np.testing.assert_array_equal(t.todense().numpy(), A)
    E, D = rng.random(m) + 0.5, rng.random(n) + 0.5
    ts = t.scale(torch.as_tensor(E), torch.as_tensor(D))
    js = j.scale(jnp.asarray(E), jnp.asarray(D))
    _close(ts.todense(), js.todense(), 1e-12, "scale")
    for f in ("rowvals", "colvals"):
        _close(getattr(ts.ell, f), getattr(js.ell, f), 1e-12, f"scaled {f}")
    for f in ("row_absmax", "col_absmax"):
        got, ref = getattr(ts, f)().numpy(), np.asarray(getattr(js, f)())
        np.testing.assert_array_equal(got, ref)
        assert (got >= 0).all()
    if which != "uc":
        assert ts.row_absmax()[3] == 0 and ts.col_absmax()[7] == 0
    if which == "wide":
        assert t.wide.tolist() == [5, 17, 30] and t.kn <= tsparse.NARROW_K
        _close(ts.matvec(torch.as_tensor(x)), js.matvec(jnp.asarray(x)),
               1e-10, "scaled matvec")
        _close(ts.astype(torch.float32).matvec(
            torch.as_tensor(x, dtype=torch.float32)),
            js.matvec(jnp.asarray(x)), 1e-5, "f32 matvec")


def test_build_ell_matches_reference_and_has_no_cap():
    rng = np.random.default_rng(3)
    A = np.where(rng.random((30, 20)) < 0.2, rng.normal(size=(30, 20)), 0.0)
    A[5, :] = rng.normal(size=20)           # a dense row: kr = 20
    rows, cols = np.nonzero(A)
    vals = A[rows, cols]
    for got, ref in zip(tsparse._build_ell(rows, cols, vals, 30, 20),
                        j_build_ell(rows, cols, vals, 30, 20)):
        np.testing.assert_array_equal(got, ref)
    # past the reference's 64-slot cap the port still builds the twin
    wide = np.zeros((3, 100))
    wide[0] = 1.0
    r, c = np.nonzero(wide)
    assert j_build_ell(r, c, wide[r, c], 3, 100) is None
    rc, rv, cr, cv = tsparse._build_ell(r, c, wide[r, c], 3, 100)
    assert rc.shape == (3, 100) and cr.shape == (100, 1)
    assert tsparse._build_ell(r, c, wide[r, c], 3, 100, max_k=64) is None


@pytest.mark.parametrize("which", ["block_lp", "uc"])
def test_detect_structure_matches_reference(which):
    if which == "block_lp":
        A, kw = _block_lp()[0], {"min_blocks": 2}
    else:
        A, kw = _uc_A(num_gens=10, horizon=4), {}
    got, ref = tsparse.detect_structure(A, **kw), jdetect(A, **kw)
    assert got is not None and ref is not None
    np.testing.assert_array_equal(got.narrow_rows, ref.narrow_rows)
    np.testing.assert_array_equal(got.wide_rows, ref.wide_rows)
    assert (got.n, got.m, got.r) == (ref.n, ref.m, ref.r)
    assert len(got.buckets) == len(ref.buckets)
    for (gv, gr), (rv, rr) in zip(got.buckets, ref.buckets):
        np.testing.assert_array_equal(gv, rv)
        np.testing.assert_array_equal(gr, rr)
    # and none where everything is one component (uc at 3 generators: its
    # balance and reserve rows are narrow)
    A3 = _uc_A(num_gens=3, horizon=4)
    assert tsparse.detect_structure(A3) is None and jdetect(A3) is None


def test_default_uc_batch_is_sparsified():
    """The full-width uc (30 generators, 24 hours) goes up as a structured
    SparseA with the shapes the main path runs at, checked without
    solving."""
    opt = SPOpt({"device": "cpu"}, tuc.scenario_names_creator(2),
                tuc.scenario_creator,
                scenario_creator_kwargs={"num_scens": 2,
                                         "relax_integers": True})
    A_np = opt.batch.A_shared
    assert A_np is not None and A_np.shape == (4626, 2928)
    assert np.count_nonzero(A_np) == 18937
    assert tsparse.should_sparsify(A_np)
    A_d, cl_d, cu_d = opt._device_consts(torch.float32)
    assert isinstance(A_d, tsparse.SparseA) and A_d.dtype == torch.float32
    assert tuple(cl_d.shape) == (2, 4626)
    assert tuple(A_d.ell.rowcols.shape) == (4626, 61)
    assert tuple(A_d.ell.colrows.shape) == (2928, 10)
    st = A_d.structure
    assert st is not None and tuple(st.wide_rows.shape) == (184,)
    assert sorted(tuple(bv.shape) for bv in st.bvars) == [(30, 128),
                                                          (48, 8)]
    assert [tuple(br.shape)[1] for bv, br in zip(st.bvars, st.brows)
            if bv.shape[1] == 128] == [167]
    # the kernel takes it: 8 scenarios a block in f32, 4 in f64
    assert cuda_kernels.usable_sparse(1000, 4626, 2928, 61, 10,
                                      torch.float32) == 8
    assert cuda_kernels.usable_sparse(1000, 4626, 2928, 61, 10,
                                      torch.float64) == 4
    # sparse_device_A=False keeps it dense
    opt.options["sparse_device_A"] = False
    opt._dev_consts = None
    assert isinstance(opt._device_consts(torch.float32)[0], torch.Tensor)


# ---- structured factors ----------------------------------------------------

def test_structured_factors_match_reference():
    A = _block_lp()[0]
    m, n = A.shape
    rng = np.random.default_rng(1)
    j, t = _both_sparse(A, structure=True, min_blocks=2)
    assert t.structure is not None and j.structure is not None
    d, rho = rng.random(n) + 0.5, rng.random(m) + 0.5
    jbw = jsk.factor_structured(j, j.structure, jnp.asarray(d),
                                jnp.asarray(rho), 1e-6)
    tbw = tsk.factor_structured(t, t.structure, torch.as_tensor(d),
                                torch.as_tensor(rho), 1e-6)
    for gb, rb in zip(tbw.binv, jbw.binv):
        _close(gb, rb, 1e-10, "binv")
    _close(tbw.Aw, jbw.Aw, 1e-12, "Aw")
    _close(tbw.Cinv, jbw.Cinv, 1e-10, "Cinv")
    b = rng.normal(size=(4, n))
    _close(tsk.kinv_apply(tbw, torch.as_tensor(b)),
           jsk.kinv_apply(jbw, jnp.asarray(b)), 1e-10, "kinv_apply")
    # the kernel layout is the same operator, and the inverse of K
    lay = tsk.woodbury_layout(tbw, t)
    Kd = tsk.layout_apply(lay, torch.eye(n, dtype=torch.float64))
    ref = np.asarray(jsk.kinv_apply(jbw, jnp.eye(n)))
    _close(Kd, ref, 1e-10, "layout's K^-1")
    K = np.diag(d + 1e-6) + A.T @ (rho[:, None] * A)
    _close(Kd, np.linalg.inv(K), 1e-10, "against inv(K)")
    _close(tsk.layout_apply(lay, torch.as_tensor(b)),
           tsk.kinv_apply(tbw, torch.as_tensor(b)), 1e-10, "apply")


# ---- the plain sweep against the Pallas interpreter ------------------------

_SPARSE_ORDER = ("q", "rowcols", "rowvals", "colrows", "colvals", "Kinv",
                 "diagK", "cl", "cu", "lb", "ub", "rho_a", "rho_x", "dq2",
                 "has", "gamma", "x", "z", "zx", "y", "yx", "Ax")


def _sparse_case(A, S, has, seed=11):
    """tests/test_pallas.py::test_fused_sweeps_sparse_matches_xla's inputs
    for a given A: K = A' diag(rho_a) A + sigma I + diag(rho_x), diagK =
    rho_x + sigma (q2ref = 0), gamma in [0.5, 1.5], dq2 ~ 0.1 |N(0, 1)|
    (zero when ``has`` is unset)."""
    rng = np.random.RandomState(seed)
    m, n = A.shape
    sigma = 1e-6
    _, sp = _both_sparse(A)
    rho_a = np.full(m, 0.7)
    rho_x = np.full(n, 0.4)
    K = (A.T * rho_a) @ A + sigma * np.eye(n) + np.diag(rho_x)
    cl = -np.abs(rng.randn(S, m)) - 0.5
    cu = np.abs(rng.randn(S, m)) + 0.5
    x = rng.randn(S, n) * 0.1
    c = dict(q=rng.randn(S, n), rowcols=sp.ell.rowcols.numpy(),
             rowvals=sp.ell.rowvals.numpy(), colrows=sp.ell.colrows.numpy(),
             colvals=sp.ell.colvals.numpy(), Kinv=np.linalg.inv(K),
             diagK=(rho_x + sigma)[None, :], cl=cl, cu=cu,
             lb=-2.0 * np.ones((S, n)), ub=2.0 * np.ones((S, n)),
             rho_a=rho_a[None, :], rho_x=rho_x[None, :],
             dq2=0.1 * np.abs(rng.randn(S, n)) * has,
             has=np.full((1, 1), float(has)),
             gamma=0.5 + rng.rand(S, 1), x=x,
             z=np.clip(rng.randn(S, m), cl, cu), zx=np.clip(x, -2.0, 2.0),
             y=rng.randn(S, m) * 0.1, yx=rng.randn(S, n) * 0.1, Ax=x @ A.T)
    return c, sigma


def _sparse_args(c, device="cpu", dtype=torch.float64):
    return [torch.as_tensor(c[k], device=device,
                            dtype=(torch.int32 if k in ("rowcols", "colrows")
                                   else dtype)) for k in _SPARSE_ORDER]


def _pallas_A():
    """tests/test_pallas.py:297's matrix."""
    rng = np.random.RandomState(11)
    A = np.where(rng.rand(10, 6) < 0.35, rng.randn(10, 6), 0.0)
    A[0, 0] = 1.3
    return A


@pytest.mark.parametrize("has", [1, 0])
@pytest.mark.parametrize("which,S", [("pallas_case", 12), ("uc", 8)])
def test_sparse_plain_matches_pallas_interpret(which, S, has):
    """The port's plain version against the reference kernel in the Pallas
    interpreter at "highest", with the extra refinement passes armed
    (has=1) and not (has=0)."""
    A = _pallas_A() if which == "pallas_case" else _uc_A()
    c, sigma = _sparse_case(A, S, has)
    n_sweeps, n_refine, n_extra, alpha = 3, 2, 2, 1.6
    ref = pallas_kernels.fused_sweeps_sparse(
        *(jnp.asarray(c[k]) for k in _SPARSE_ORDER), n_sweeps=n_sweeps,
        n_refine=n_refine, n_extra=n_extra, sigma=sigma, alpha=alpha, bs=8,
        precision="highest", interpret=True)
    cuda_kernels.reset_counts()
    got = cuda_kernels.fused_sweeps_sparse_plain(
        *_sparse_args(c), n_sweeps, n_refine, n_extra, sigma, alpha)
    assert cuda_kernels.plain_calls["fused_sweeps_sparse"] == 1
    for name, g, r in zip(("x", "z", "zx", "y", "yx", "Ax"), got, ref):
        _close(g, r, 1e-12, name)


def test_sparse_wrapper_on_cpu_runs_plain_and_counts_cover_it():
    """The review carry-over: the launch and plain-call counts and
    reset_counts cover the sparse kernel; on CPU tensors its wrapper runs
    the plain version and launches nothing."""
    assert set(cuda_kernels.launches) == set(cuda_kernels.plain_calls) == {
        "fused_sweeps", "fused_sweeps_shared", "fused_sweeps_sparse"}
    c, sigma = _sparse_case(_pallas_A(), 5, 1)
    cuda_kernels.plain_calls["fused_sweeps_sparse"] = 7
    cuda_kernels.launches["fused_sweeps_sparse"] = 3
    cuda_kernels.reset_counts()
    assert not any(cuda_kernels.launches.values())
    assert not any(cuda_kernels.plain_calls.values())
    got = cuda_kernels.fused_sweeps_sparse(*_sparse_args(c), 2, 1, 2, sigma,
                                           1.6)
    want = cuda_kernels.fused_sweeps_sparse_plain(*_sparse_args(c), 2, 1, 2,
                                                  sigma, 1.6)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert cuda_kernels.launches["fused_sweeps_sparse"] == 0
    assert cuda_kernels.plain_calls["fused_sweeps_sparse"] == 2
    # the lowered modes: the wrapper on CPU tensors runs the plain version
    # at the mode; a mode the reference does not have raises
    for prec in ("default", "high"):
        got = cuda_kernels.fused_sweeps_sparse(*_sparse_args(c), 2, 1, 2,
                                               sigma, 1.6, precision=prec)
        want = cuda_kernels.fused_sweeps_sparse_plain(
            *_sparse_args(c), 2, 1, 2, sigma, 1.6, precision=prec)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert cuda_kernels.launches["fused_sweeps_sparse"] == 0
    assert cuda_kernels.plain_calls["fused_sweeps_sparse"] == 6
    with pytest.raises(ValueError, match="must be one of"):
        cuda_kernels.fused_sweeps_sparse(*_sparse_args(c), 2, 1, 2, sigma,
                                         1.6, precision="bf16")


def test_usable_sparse_gate():
    f32, f64 = torch.float32, torch.float64
    # the tile shrinks with n; no slot cap on kr/kc
    assert cuda_kernels.usable_sparse(1000, 4626, 2928, 61, 10, f32) == 8
    assert cuda_kernels.sparse_smem_bytes(2928, 4, 8) == 203808
    assert cuda_kernels.usable_sparse(10, 50, 3000, 500, 300, f32) == 8
    assert cuda_kernels.usable_sparse(10, 50, 3500, 5, 5, f32) == 4
    assert cuda_kernels.usable_sparse(10, 50, 14000, 5, 5, f64) == 1
    assert cuda_kernels.usable_sparse(10, 50, 15000, 5, 5, f64) is None
    assert cuda_kernels.usable_sparse(10, 50, 30000, 5, 5, f32) is None
    assert cuda_kernels.usable_sparse(10, 5, 5, 1, 1, torch.float16) is None
    assert cuda_kernels.usable_sparse(0, 5, 5, 1, 1, f32) is None
    assert cuda_kernels.usable_sparse(4, 2 ** 20, 100, 2 ** 12, 1,
                                      f32) is None


# ---- shared solves on a SparseA --------------------------------------------

def _solve_inputs(regime):
    """(A for the reference, A for the port, arrays, settings kwargs)."""
    A, c, cl, cu, lb, ub = _block_lp()
    q2 = np.zeros_like(c)
    kw = dict(SETTINGS)
    if regime == "dense_noK":
        return jnp.asarray(A), A, (c, q2, cl, cu, lb, ub), dict(
            kw, factors_keep_K=False)
    j, t = _both_sparse(A, structure=regime == "structured", min_blocks=2)
    assert (t.structure is not None) == (regime == "structured")
    return j, t, (c, q2, cl, cu, lb, ub), kw


def _args(A, arrs, q=None, q2=None):
    c, q2_, cl, cu, lb, ub = arrs
    return (c if q is None else q, q2_ if q2 is None else q2, A, cl, cu, lb,
            ub)


def _same_solution(tsol, jsol, tol=1e-9):
    for name in ("x", "z", "y", "yx", "pri_res", "dua_res"):
        _close(getattr(tsol, name), getattr(jsol, name), tol, name)
    assert np.array_equal(np.asarray(tsol.done), np.asarray(jsol.done))
    assert int(tsol.iters[0]) == int(np.asarray(jsol.iters)[0])


@pytest.mark.parametrize("regime", ["structured", "unstructured",
                                    "dense_noK"])
def test_sparse_solves_match_reference(regime):
    """Adaptive, factored and frozen shared solves, on a SparseA with and
    without block/Woodbury structure and on a dense A whose factors carry
    no K.  The factored solve runs on a prox QP, so gamma moves off 1 and
    the frozen solves run the dq2 refinement with the extra passes armed,
    matrix-free through A."""
    jA, tA, arrs, kw = _solve_inputs(regime)
    jst, tst = JSettings(**kw), TSettings(**kw)
    if regime != "dense_noK":
        jsol = jshared.solve_shared(*_args(jA, arrs), settings=jst)
        tsol = tshared.solve_shared(*_args(tA, arrs), settings=tst,
                                    device="cpu")
        _same_solution(tsol, jsol)
    q2 = np.full_like(arrs[0], 1.0)
    q2[:, :7] += 5.0
    jsol, jfac = jshared.solve_shared_factored(*_args(jA, arrs, q2=q2),
                                               settings=jst)
    cuda_kernels.reset_counts()
    tsol, tfac = tshared.solve_shared_factored(*_args(tA, arrs, q2=q2),
                                               settings=tst, device="cpu")
    _same_solution(tsol, jsol)
    # which kernel ran the adaptive blocks: the sparse one on a SparseA
    # (no dense K), the shared one on the dense A (K kept while adapting)
    adaptive = "fused_sweeps_shared" if regime == "dense_noK" \
        else "fused_sweeps_sparse"
    assert cuda_kernels.plain_calls[adaptive] > 0
    assert sum(cuda_kernels.plain_calls.values()) == \
        cuda_kernels.plain_calls[adaptive]
    assert tfac.K is None and jfac.K is None
    for name in ("D", "E", "cost", "rho_a", "rho_x", "gamma", "q2ref"):
        _close(getattr(tfac, name), getattr(jfac, name), 1e-9, name)
    if regime == "structured":
        # the sweep operand is the factors' kernel layout: no dense K^-1
        assert isinstance(tfac.Kinv, tsk.BlockWoodbury)
        assert isinstance(tfac.Kinv_op, tsk.KernelWoodbury)
        assert tfac.Kinv_op.bw is tfac.Kinv
        _close(tfac.Kinv.Cinv, jfac.Kinv.Cinv, 1e-9, "Cinv")
        n = arrs[0].shape[1]
        _close(tsk.layout_apply(tfac.Kinv_op,
                                torch.eye(n, dtype=torch.float64)),
               jsk.kinv_apply(jfac.Kinv, jnp.eye(n)), 1e-9, "Kinv_op")
    else:
        _close(tfac.Kinv, jfac.Kinv, 1e-9, "Kinv")
        assert tfac.Kinv_op is tfac.Kinv
    assert not np.allclose(np.asarray(tfac.gamma), 1.0)
    rng = np.random.RandomState(0)
    jw, tw = jsol.raw, tsol.raw
    for step in range(2):
        q = arrs[0] + 0.5 * rng.randn(*arrs[0].shape)
        jsol = jshared.solve_shared_frozen(*_args(jA, arrs, q=q, q2=q2),
                                           jfac, settings=jst, warm=jw)
        cuda_kernels.reset_counts()
        tsol = tshared.solve_shared_frozen(*_args(tA, arrs, q=q, q2=q2),
                                           tfac, settings=tst, warm=tw)
        _same_solution(tsol, jsol)
        # frozen blocks refine matrix-free: the sparse kernel's plain
        # version, whatever A's type
        assert cuda_kernels.plain_calls["fused_sweeps_sparse"] > 0
        assert cuda_kernels.plain_calls["fused_sweeps_shared"] == 0
        jw, tw = jsol.raw, tsol.raw


@pytest.mark.parametrize("use_kernel", [True, False])
def test_engine_routes_every_sparse_block_to_the_wrapper(use_kernel,
                                                         monkeypatch):
    """Every sweep block of a SparseA solve goes to ``fused_sweeps_sparse``
    (on the card it launches or raises), whatever the shape gate says;
    only ``use_kernel=False`` calls the plain version directly."""
    monkeypatch.setattr(cuda_kernels, "usable_sparse", lambda *a: None)
    wrapper = cuda_kernels.fused_sweeps_sparse
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return wrapper(*a, **k)

    monkeypatch.setattr(cuda_kernels, "fused_sweeps_sparse", counted)
    jA, tA, arrs, kw = _solve_inputs("structured")
    cuda_kernels.reset_counts()
    tshared.solve_shared(*_args(tA, arrs), settings=TSettings(
        max_iter=16, restarts=1, use_kernel=use_kernel), device="cpu")
    assert bool(calls) == use_kernel
    assert cuda_kernels.plain_calls["fused_sweeps_sparse"] == 4
    assert cuda_kernels.plain_calls["fused_sweeps_shared"] == 0
    assert not any(cuda_kernels.launches.values())


def test_dual_objective_takes_a_sparse_A():
    """The certified bound's A'y rides the SparseA's transpose matvec: the
    same bound as the dense A, and as the reference's, to 1e-10."""
    jA, tA, arrs, _ = _solve_inputs("structured")
    A = tA.todense().numpy()
    sol = tshared.solve_shared(*_args(tA, arrs), settings=TSettings(
        **SETTINGS), device="cpu")
    c, q2, cl, cu, lb, ub = arrs
    y, x = sol.y.numpy(), sol.x.numpy()
    t = torch.as_tensor
    targs = [t(c), t(q2), tA, t(cl), t(cu), t(lb), t(ub), t(y), t(x)]
    ds = tadmm.dual_objective_with_margin(*targs).numpy()
    targs[2] = t(A)
    dd = tadmm.dual_objective_with_margin(*targs).numpy()
    jd = np.asarray(jadmm.dual_objective(
        *(jnp.asarray(v) for v in (c, q2)), jA,
        *(jnp.asarray(v) for v in (cl, cu, lb, ub, y, x))))
    _close(ds, dd, 1e-10, "sparse vs dense")
    _close(ds[0], jd, 1e-10, "against the reference")


# ---- uc PH on the sparse engine --------------------------------------------

UC_KW = {"num_gens": 3, "horizon": 6, "relax_integers": True}
PH_OPTIONS = {"defaultPHrho": 10.0, "convthresh": 1e-6,
              "sparse_device_A": True,
              "solver_options": {"megastep": 1, "max_iter": 200,
                                 "restarts": 2}}


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


def test_uc_ph_matches_reference():
    S, iters = 4, 6
    names = juc.scenario_names_creator(S)
    kw = dict(UC_KW, num_scens=S)
    opts = dict(PH_OPTIONS, PHIterLimit=iters)
    jph = JPH(dict(opts), names, juc.scenario_creator,
              scenario_creator_kwargs=kw, extensions=_recorder(JExtension))
    assert jph._megastep_request() == 0
    assert isinstance(jph._device_consts(jph.admm_settings.jdtype())[0],
                      JSparseA)
    jres = jph.ph_main()
    tph = TPH(dict(opts, device="cpu"), names, tuc.scenario_creator,
              scenario_creator_kwargs=kw, extensions=_recorder(TExtension))
    cuda_kernels.reset_counts()
    tres = tph.ph_main()
    assert isinstance(tph._device_consts(torch.float64)[0], tsparse.SparseA)
    # every sweep block went through the sparse kernel's wrapper
    assert cuda_kernels.plain_calls["fused_sweeps_sparse"] > 0
    assert cuda_kernels.plain_calls["fused_sweeps_shared"] == 0
    assert len(tph.trace) == len(jph.trace) == iters
    for k, ((tw, tx, te), (jw, jx, je)) in enumerate(zip(tph.trace,
                                                         jph.trace)):
        _close(tw, jw, 1e-7, f"W at iteration {k + 1}")
        _close(tx, jx, 1e-7, f"xbars at iteration {k + 1}")
        assert te == pytest.approx(je, rel=1e-7)
    for a, b in zip(tres, jres):
        assert a == pytest.approx(b, rel=1e-7)
    ef_obj, _ = solve_ef(tph.batch, solver="highs")
    assert tres[2] <= ef_obj + 1e-6 * abs(ef_obj)


def test_structured_state_carry_reproduces_next_iteration():
    """A reference uc PH state on the structured engine (10 generators: its
    balance and reserve rows are wide), with its SharedFactors (a
    BlockWoodbury and no K), loaded through convert.load_ph_state,
    reproduces the reference's next iteration to 1e-9; and the reference's
    SparseA comes over through convert.sparse_from_arrays."""
    S = 3
    names = juc.scenario_names_creator(S)
    kw = dict(UC_KW, num_gens=10, horizon=3, num_scens=S)
    opts = dict(PH_OPTIONS, PHIterLimit=3, convthresh=0.0)
    jph = JPH(dict(opts), names, juc.scenario_creator,
              scenario_creator_kwargs=kw)
    jph.ph_main()
    assert isinstance(jph._factors.Kinv, jsk.BlockWoodbury)
    assert jph._factors.K is None
    tph = TPH(dict(opts, device="cpu"), names, tuc.scenario_creator,
              scenario_creator_kwargs=kw)
    fac = {k: (v if k in ("Kinv", "K") else np.asarray(v))
           for k, v in jph._factors._asdict().items()}
    convert.load_ph_state(
        tph, jph.W, jph.xbars, jph.rho,
        warm=tuple(np.asarray(v) for v in jph._warm), factors=fac,
        factors_age=jph._factors_age, iteration=jph._iter)
    assert isinstance(tph._factors.Kinv, tsk.BlockWoodbury)
    assert isinstance(tph._factors.Kinv_op, tsk.KernelWoodbury)
    assert tph._factors.K is None
    age = jph._factors_age
    jph._iterk_one(jph._iter + 1, 0.0)
    tph._iterk_one(tph._iter + 1, 0.0)
    assert jph._factors_age == tph._factors_age == age + 1
    for name in ("W", "xbars"):
        _close(getattr(tph, name), getattr(jph, name), 1e-9, name)
    assert tph.conv == pytest.approx(jph.conv, rel=1e-9)
    jA = jph._device_consts(jph.admm_settings.jdtype())[0]
    tA = convert.sparse_from_arrays(
        np.asarray(jA.rows), np.asarray(jA.cols), np.asarray(jA.vals),
        jA.shape, structure=jA.structure._asdict(), device="cpu")
    ref = tph._device_consts(torch.float64)[0]
    np.testing.assert_array_equal(tA.todense().numpy(),
                                  ref.todense().numpy())
    for f in ("rowcols", "colrows"):
        assert torch.equal(getattr(tA.ell, f), getattr(ref.ell, f))
    for got, want in zip(tA.structure.bvars, ref.structure.bvars):
        assert torch.equal(got, want)
    assert torch.equal(tA.structure.wide_rows, ref.structure.wide_rows)


def test_uc_batch_fields_match_reference():
    """The port's uc model builds the reference's batch."""
    names = juc.scenario_names_creator(3)
    kw = dict(UC_KW, num_gens=4, horizon=5, num_scens=3)
    jb = JBatch.from_problems([juc.scenario_creator(nm, **kw)
                               for nm in names])
    tb, _ = build_batch(names, tuc.scenario_creator, kw)
    assert tb.A_shared is not None
    np.testing.assert_array_equal(tb.A_shared, jb.A_shared)
    for f in dataclasses.fields(jb):
        if f.name in ("c", "q2", "cl", "cu", "lb", "ub", "const", "is_int"):
            np.testing.assert_array_equal(getattr(tb, f.name),
                                          getattr(jb, f.name))
    np.testing.assert_array_equal(tb.tree.nonant_indices,
                                  jb.tree.nonant_indices)
