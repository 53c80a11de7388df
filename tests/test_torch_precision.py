"""The mixed-precision sweep (``sweep_precision``) of the port against the
reference, in float64 and float32 on the CPU (doc/precision.md).

Inputs are made from seeds with numpy and handed to both packages.  What
each test holds, with its tolerance (relative to the largest entry of the
reference, floored at 1, unless said):

- ``precision.contract`` against the reference's emulation at every mode
  and dtype: 1e-6 (both sum exact bf16 products in float32, in another
  order); bitwise on an elementwise contraction, operands on bf16 rounding
  ties and float64 values that reach a tie only through float32 (the chain
  is float64 -> float32 -> bf16, round to nearest even, in both);
- each plain kernel version against the Pallas interpreter at its modes
  (``tests/test_pallas.py``'s patterns): 1e-10, the same bf16 operands and
  products summed in float64 in another order;
- the structured ``kinv_apply(bw, b, prec)`` against the reference's:
  1e-6 in float64 and 1e-5 in float32 (each lowered product summed in
  float32, in another order), and so the plain sweep's apply (the same
  products summed in the working dtype, as the kernel and the Pallas
  kernels' ``_pdot`` sum them); the structured plain sweep against the
  reference's XLA sweep block over 3 sweeps, float64, the reference's
  lowered products made by that rule: 1e-6 at "default" and 2e-5 at
  "high" (measured 2.0e-6).  At "high" a float32 sum one ulp apart, fed to
  the next lowered product, moves its operand's low bf16 part by 2^-16 of
  the operand in about one element of 256, so bf16x3 chains part at that
  level, not at float32's;
- the frozen solves against the reference's (``tests/test_precision.py``'s
  problems): iterates within 1e-6 where the reference converges, with the
  kernel on (the port's "high" runs the dense kernel exact, as the TPU
  kernel does) and off (the reference's XLA sweep, "high" as bf16x3); the
  shared engine's plateau family within the guard's bar of the
  full-precision floor;
- farmer S=3 PH at "default" against the reference's, iteration by
  iteration: the expected objective to 2e-7 and ``conv`` to 2e-4.  Frozen
  solves accepted inside the rescue tolerance (before eps) carry the
  float32 summation differences of the lowered products (1e-7 of a
  product) into the PH state; measured 3.0e-8 and 3.9e-5 over 30
  iterations.  There and on uc_lite S=5 in float32 at eps 1e-5, the
  guard trips exactly as often as the reference's and the refinement
  phases sweep exactly as much (the counts, not a tolerance).

The ``cuda`` cases hold each kernel at each lowered mode against its plain
version on the card, with the plain version at "highest" as a control,
and skip here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusppy.extensions.extension import Extension as JExtension
from tpusppy.models import farmer
from tpusppy.models import uc_lite as juc_lite
from tpusppy.obs import metrics as jmetrics
from tpusppy.opt.ph import PH as JPH
from tpusppy.solvers import admm as jadmm
from tpusppy.solvers import pallas_kernels
from tpusppy.solvers import precision as jprec
from tpusppy.solvers import shared_admm as jshared
from tpusppy.solvers import structured_kkt as jsk
from tpusppy.solvers.sparse import SparseA as JSparseA
from tpusppy_torch.extensions.extension import Extension as TExtension
from tpusppy_torch.models import farmer as tfarmer
from tpusppy_torch.models import uc as tuc
from tpusppy_torch.models import uc_lite as tuc_lite
from tpusppy_torch.obs import metrics as tmetrics
from tpusppy_torch.opt.ph import PH as TPH
from tpusppy_torch.solvers import admm as tadmm
from tpusppy_torch.solvers import cuda_kernels
from tpusppy_torch.solvers import precision as tprec
from tpusppy_torch.solvers import shared_admm as tshared
from tpusppy_torch.solvers import sparse as tsparse
from tpusppy_torch.solvers import structured_kkt as tsk
from tpusppy_torch.spbase import build_batch, make_admm_settings
from tpusppy_torch.spopt import SPOpt

torch.set_num_threads(1)

LOW = ("default", "high")
F64 = torch.float64


def _close(got, ref, tol, what=""):
    got = np.asarray(got, dtype=float)
    ref = np.asarray(ref, dtype=float)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.max(np.abs(ref))) if ref.size else 1.0)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} * {scale:.3g}"


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


# ---------------------------------------------------------------------------
# precision.contract and the rounding chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("mode", ["default", "high", "highest"])
def test_contract_matches_reference(mode, dtype):
    rng = np.random.RandomState(0)
    a = rng.randn(7, 12, 9).astype(dtype)
    b = rng.randn(9, 5).astype(dtype)
    for spec, x, y in (("sij,jk->sik", a, b), ("sij,sij->si", a, a)):
        ref = np.asarray(jprec.contract(spec, jnp.asarray(x), jnp.asarray(y),
                                        mode, platform="cpu"))
        got = tprec.contract(spec, torch.as_tensor(x), torch.as_tensor(y),
                             mode)
        assert got.dtype == getattr(torch, dtype)
        _close(_np(got), ref, 1e-6 if mode != "highest" or dtype ==
               "float32" else 1e-12, f"{spec} {mode}")


def _ties(dtype):
    """Values on bf16 rounding ties (1 + k 2^-8 for odd k, both parities of
    the neighbours, negated, scaled by powers of two), their neighbours one
    float32 ulp away, and, in float64, values a float64 ulp off a tie that
    land on it in float32."""
    k = np.arange(1, 64, 2)
    base = np.concatenate([1.0 + k * 2.0 ** -8, -(1.0 + k * 2.0 ** -8)])
    base = np.concatenate([base * 2.0 ** e for e in (-20, -3, 0, 7, 30)])
    vals = [base, np.nextafter(base.astype(np.float32), np.float32(np.inf)),
            np.nextafter(base.astype(np.float32), np.float32(-np.inf))]
    if dtype == "float64":
        vals += [base + base * 2.0 ** -30, base - base * 2.0 ** -30]
    return np.concatenate(vals).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_rounding_chain_matches_reference_on_ties(dtype):
    """bf16 rounding through float32, nearest even, back in the operand's
    dtype: the port's helpers and contract against the reference's chain,
    bitwise (an elementwise contraction has no sums to reorder)."""
    v = _ties(dtype)
    jv = jnp.asarray(v)
    ref1 = np.asarray(jv.astype(jnp.float32).astype(jnp.bfloat16)
                      .astype(jnp.float32))
    ref2 = np.asarray((jv.astype(jnp.float32) - jnp.asarray(ref1))
                      .astype(jnp.bfloat16).astype(jnp.float32))
    t = torch.as_tensor(v)
    p1, p2 = tprec.bf16_parts(t, "high")
    assert np.array_equal(p1.float().numpy(), ref1)
    assert np.array_equal(p2.float().numpy(), ref2)
    assert np.array_equal(tprec.bf16_round(t).numpy(), ref1.astype(dtype))
    # a tie goes to the even neighbour: 1 + 2^-8 -> 1, 1 + 3 2^-8 -> 1+2^-6
    assert tprec.bf16_round(torch.tensor([1 + 2 ** -8, 1 + 3 * 2 ** -8],
                                         dtype=t.dtype)).tolist() == [
        1.0, 1.0 + 2 ** -6]
    w = np.linspace(-3.0, 3.0, v.size).astype(dtype)
    for mode in LOW:
        ref = np.asarray(jprec.contract("i,i->i", jv, jnp.asarray(w), mode,
                                        platform="cpu"))
        got = tprec.contract("i,i->i", t, torch.as_tensor(w), mode)
        assert np.array_equal(got.numpy(), ref), mode


def test_contract_modes_order_and_canon():
    rng = np.random.RandomState(0)
    a = torch.as_tensor(rng.randn(12, 9))
    b = torch.as_tensor(rng.randn(9, 7))
    exact = (a @ b).numpy()

    def err(mode):
        return float(np.abs(tprec.contract("ij,jk->ik", a, b,
                                           mode).numpy() - exact).max())

    assert err("highest") <= 1e-12
    assert 0 < err("high") < err("default") < 1e-1
    assert tprec.canon(None) == "highest"
    assert tprec.is_low("default") and not tprec.is_low("highest")
    assert not tprec.is_low(None)
    with pytest.raises(ValueError, match="must be one of"):
        tprec.contract("ij,jk->ik", a, b, "bf8")
    before = tmetrics.value("precision.lowered_contractions.high")
    tprec.contract("ij,jk->ik", a, b, "high")
    assert tmetrics.value("precision.lowered_contractions.high") == before + 1


# ---------------------------------------------------------------------------
# the plain kernel versions against the Pallas interpreter
# ---------------------------------------------------------------------------

def _dense_case(seed=21, S=8, m=9, n=5, a_scale=1.0):
    rng = np.random.RandomState(seed)
    sigma = 1e-6
    A = rng.randn(S, m, n) * a_scale
    q = rng.randn(S, n)
    cl = -np.abs(rng.randn(S, m)) - 0.5
    cu = np.abs(rng.randn(S, m)) + 0.5
    rho_a = np.full((S, m), 0.7)
    rho_x = np.full((S, n), 0.4)
    K = np.einsum("smn,sm,smk->snk", A, rho_a, A)
    K += sigma * np.eye(n)[None]
    K += np.einsum("sn,nk->snk", rho_x, np.eye(n))
    x = rng.randn(S, n) * 0.1
    c = dict(q=q, A=A, Kinv=np.linalg.inv(K), K=K, cl=cl, cu=cu,
             lb=-2.0 * np.ones((S, n)), ub=2.0 * np.ones((S, n)),
             rho_a=rho_a, rho_x=rho_x, x=x, z=np.clip(rng.randn(S, m), cl, cu),
             zx=np.clip(x, -2.0, 2.0), y=rng.randn(S, m) * 0.1,
             yx=rng.randn(S, n) * 0.1, Ax=np.einsum("smn,sn->sm", A, x))
    return c, sigma


_DENSE = ("q", "A", "Kinv", "K", "cl", "cu", "lb", "ub", "rho_a", "rho_x",
          "x", "z", "zx", "y", "yx", "Ax")


@pytest.mark.parametrize("mode", LOW)
def test_dense_plain_matches_pallas(mode):
    """``fused_sweeps_plain`` at "default" (bf16 A and K^-1, rounded vector
    operands, the K defect exact) and "high" (the exact path) against
    ``pallas_kernels.fused_sweeps`` in the interpreter; the TPU caller
    casts A, A' and K^-1 to bf16 at "default"."""
    c, sigma = _dense_case()
    n_sweeps, n_refine, alpha = 4, 2, 1.6
    tT = lambda a: jnp.transpose(jnp.asarray(a), (1, 2, 0))
    cast = (lambda a: a.astype(jnp.bfloat16)) if mode == "default" else (
        lambda a: a)
    outs = pallas_kernels.fused_sweeps(
        jnp.asarray(c["q"]).T, cast(tT(c["A"])),
        cast(jnp.transpose(jnp.asarray(c["A"]), (2, 1, 0))),
        cast(tT(c["Kinv"])), tT(c["K"]),
        *(jnp.asarray(c[k]).T for k in ("cl", "cu", "lb", "ub", "rho_a",
                                        "rho_x", "x", "z", "zx", "y", "yx",
                                        "Ax")),
        n_sweeps=n_sweeps, n_refine=n_refine, sigma=sigma, alpha=alpha,
        bs=c["q"].shape[0], precision=mode, interpret=True)
    args = [torch.as_tensor(c[k]) for k in _DENSE]
    got = cuda_kernels.fused_sweeps_plain(*args, n_sweeps, n_refine, sigma,
                                          alpha, precision=mode)
    exact = cuda_kernels.fused_sweeps_plain(*args, n_sweeps, n_refine, sigma,
                                            alpha)
    for g, r, e, name in zip(got, outs, exact, ("x", "z", "zx", "y", "yx",
                                                 "Ax")):
        _close(_np(g), np.asarray(r).T, 1e-10, name)
        if mode == "high":
            assert torch.equal(g, e), name
    if mode == "default":
        assert max(float((g - e).abs().max()) for g, e in zip(got, exact)) \
            > 1e-6


def _shared_case(seed=3, S=16, m=9, n=5, has=1, a_scale=1.0):
    rng = np.random.RandomState(seed)
    sigma = 1e-6
    A = rng.randn(m, n) * a_scale
    rho_a = np.full(m, 0.7)
    rho_x = np.full(n, 0.4)
    K = (A.T * rho_a) @ A + sigma * np.eye(n) + np.diag(rho_x)
    cl = -np.abs(rng.randn(S, m)) - 0.5
    cu = np.abs(rng.randn(S, m)) + 0.5
    x = rng.randn(S, n) * 0.1
    c = dict(q=rng.randn(S, n), A=A, Kinv=np.linalg.inv(K), K=K, cl=cl,
             cu=cu, lb=-2.0 * np.ones((S, n)), ub=2.0 * np.ones((S, n)),
             rho_a=rho_a[None, :], rho_x=rho_x[None, :],
             dq2=0.1 * np.abs(rng.randn(S, n)) * has,
             has=np.full((1, 1), float(has)), gamma=0.5 + rng.rand(S, 1),
             x=x, z=np.clip(rng.randn(S, m), cl, cu),
             zx=np.clip(x, -2.0, 2.0), y=rng.randn(S, m) * 0.1,
             yx=rng.randn(S, n) * 0.1, Ax=x @ A.T)
    return c, sigma


_SHARED = ("q", "A", "Kinv", "K", "cl", "cu", "lb", "ub", "rho_a", "rho_x",
           "dq2", "has", "gamma", "x", "z", "zx", "y", "yx", "Ax")


@pytest.mark.parametrize("has", [1, 0])
@pytest.mark.parametrize("mode", LOW)
def test_shared_plain_matches_pallas(mode, has):
    """``fused_sweeps_shared_plain`` at "default" and "high" (``_pdot``'s
    splits, the K defect exact, the extra passes armed by ``has``) against
    ``pallas_kernels.fused_sweeps_shared`` in the interpreter."""
    c, sigma = _shared_case(has=has)
    fixed = dict(n_sweeps=3, n_refine=2, n_extra=2, sigma=sigma, alpha=1.6)
    outs = pallas_kernels.fused_sweeps_shared(
        *(jnp.asarray(c[k]) for k in _SHARED), bs=8, precision=mode,
        interpret=True, **fixed)
    got = cuda_kernels.fused_sweeps_shared_plain(
        *(torch.as_tensor(c[k]) for k in _SHARED), *fixed.values(),
        precision=mode)
    for g, r, name in zip(got, outs, ("x", "z", "zx", "y", "yx", "Ax")):
        _close(_np(g), np.asarray(r), 1e-10, name)


def _sparse_A(seed=11, m=10, n=6, a_scale=1.0):
    rng = np.random.RandomState(seed)
    A = np.where(rng.rand(m, n) < 0.35, rng.randn(m, n) * a_scale, 0.0)
    A[0, 0] = 1.3
    return A


@pytest.mark.parametrize("has", [1, 0])
@pytest.mark.parametrize("mode", LOW)
def test_sparse_plain_matches_pallas(mode, has):
    """``fused_sweeps_sparse_plain`` with a dense K^-1 at "default" and
    "high" (lowered K^-1 applies only; the ELL products and the
    matrix-free defect exact) against ``pallas_kernels.fused_sweeps_sparse``
    in the interpreter."""
    A = _sparse_A()
    m, n = A.shape
    c, sigma = _shared_case(seed=11, S=12, m=m, n=n, has=has)
    K = (A.T * c["rho_a"][0]) @ A + sigma * np.eye(n) + np.diag(c["rho_x"][0])
    c.update(Kinv=np.linalg.inv(K), Ax=c["x"] @ A.T)
    diagK = c["rho_x"] + sigma
    jsp = JSparseA.from_dense(A, jnp.float64, ell=True)
    ell = (jsp.ell.rowcols, jsp.ell.rowvals, jsp.ell.colrows, jsp.ell.colvals)
    fixed = dict(n_sweeps=3, n_refine=2, n_extra=2, sigma=sigma, alpha=1.6)
    rest = ("cl", "cu", "lb", "ub", "rho_a", "rho_x", "dq2", "has", "gamma",
            "x", "z", "zx", "y", "yx", "Ax")
    outs = pallas_kernels.fused_sweeps_sparse(
        jnp.asarray(c["q"]), *ell, jnp.asarray(c["Kinv"]),
        jnp.asarray(diagK), *(jnp.asarray(c[k]) for k in rest), bs=8,
        precision=mode, interpret=True, **fixed)
    tell = [torch.as_tensor(np.array(e)) for e in ell]
    got = cuda_kernels.fused_sweeps_sparse_plain(
        torch.as_tensor(c["q"]), *tell, torch.as_tensor(c["Kinv"]),
        torch.as_tensor(diagK), *(torch.as_tensor(c[k]) for k in rest),
        *fixed.values(), precision=mode)
    for g, r, name in zip(got, outs, ("x", "z", "zx", "y", "yx", "Ax")):
        _close(_np(g), np.asarray(r), 1e-10, name)


# ---------------------------------------------------------------------------
# the structured operator
# ---------------------------------------------------------------------------

def _uc_A():
    b, _ = build_batch(tuc.scenario_names_creator(2), tuc.scenario_creator,
                       {"num_scens": 2, "num_gens": 10, "horizon": 4,
                        "relax_integers": True})
    return b.A_shared


def _structured(dtype=F64, seed=5):
    """The uc model's A (10 generators: blocks and one-variable
    components), its block/Woodbury factors made by the reference and
    carried over to the port value for value."""
    A = _uc_A()
    jdt = jnp.float64 if dtype == F64 else jnp.float32
    j = JSparseA.from_dense(A, jdt, structure=True, ell=True)
    t = tsparse.SparseA.from_dense(A, dtype, "cpu", structure=True)
    rng = np.random.RandomState(seed)
    m, n = A.shape
    rho_a = rng.uniform(0.5, 1.0, m).astype(jdt)
    rho_x = rng.uniform(0.5, 1.0, n).astype(jdt)
    jbw = jsk.factor_structured(j, j.structure, jnp.asarray(rho_x),
                                jnp.asarray(rho_a), 1e-6)

    def tt(v):
        return torch.as_tensor(np.array(v))

    tbw = tsk.BlockWoodbury(binv=tuple(tt(b) for b in jbw.binv),
                            bvars=tuple(tt(b).long() for b in jbw.bvars),
                            Aw=tt(jbw.Aw), Cinv=tt(jbw.Cinv))
    return A, j, t, jbw, tbw, rho_a, rho_x


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-6),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("mode", LOW)
def test_structured_kinv_apply_matches_reference(mode, dtype, tol):
    """``structured_kkt.kinv_apply(bw, b, prec)``: the block products (the
    one-variable blocks too) and the three Woodbury products lowered, each
    summed in float32, the final ``t - B^-1 w`` exact."""
    _, _, _, jbw, tbw, _, _ = _structured(dtype)
    n = tbw.Aw.shape[1]
    b = np.random.RandomState(1).randn(6, n).astype(
        "float64" if dtype == F64 else "float32")
    ref = np.asarray(jsk.kinv_apply(jbw, jnp.asarray(b), mode))
    got = tsk.kinv_apply(tbw, torch.as_tensor(b), mode)
    assert got.dtype == dtype
    _close(_np(got), ref, tol, mode)
    exact = tsk.kinv_apply(tbw, torch.as_tensor(b))
    assert float((got - exact).abs().max()) > 0
    # the plain sweep's apply: the same products summed in the working
    # dtype (float32 here is the reference's rule; float64 sums part from
    # its float32 sums by their rounding)
    _close(_np(tsk.kinv_apply(tbw, torch.as_tensor(b), mode,
                              cuda_kernels._kernel_dot)), ref, tol, mode)
    # the uniform entry point
    _close(_np(tsk.apply_kinv_like(tbw, torch.as_tensor(b), mode)), ref, tol)


def _pdot_rule(spec, a, b, mode=None, platform=None):
    """``jprec.contract`` with the lowered products summed in the operands'
    dtype, as ``pallas_kernels._pdot`` sums them (``preferred_element_type
    =dt``): the parts through float32, the products exact.  In float32 it
    is ``contract`` itself."""
    mode = jprec.canon(mode)
    hi = jax.lax.Precision.HIGHEST
    if mode == "highest":
        return jnp.einsum(spec, a, b, precision=hi)
    dt = jnp.result_type(a, b)

    def parts(v):
        v32 = v.astype(jnp.float32)
        v1 = v32.astype(jnp.bfloat16)
        return v1.astype(dt), (v32 - v1.astype(jnp.float32)).astype(
            jnp.bfloat16).astype(dt)

    (a1, a2), (b1, b2) = parts(a), parts(b)
    out = jnp.einsum(spec, a1, b1, precision=hi)
    if mode == "default":
        return out
    return (out + jnp.einsum(spec, a1, b2, precision=hi)
            + jnp.einsum(spec, a2, b1, precision=hi))


@pytest.mark.parametrize("has", [1, 0])
@pytest.mark.parametrize("mode", LOW)
def test_structured_plain_sweep_matches_reference_xla(mode, has,
                                                      monkeypatch):
    """The structured plain sweep at a lowered mode against the reference's
    XLA block on the same SparseA and factors (``shared_admm.
    _solve_shared_K`` with the BlockWoodbury at the mode, exact products
    and defect), in float64.  The plain version sums each lowered product
    of its K^-1 apply in the working dtype, as the kernel and the Pallas
    kernels' ``_pdot`` do; the reference's XLA apply sums them in float32
    (the same in a float32 run), so here it makes them by that rule
    (:func:`_pdot_rule`): a float32 sum one ulp apart can move the next
    product's bf16 operand by 2^-8 of it, and the sweep logic, not that
    rounding, is what this test holds."""
    monkeypatch.setattr(jprec, "contract", _pdot_rule)
    A, j, t, jbw, tbw, rho_a, rho_x = _structured()
    lay = tsk.woodbury_layout(tbw, t)
    m, n = A.shape
    c, sigma = _shared_case(seed=8, S=6, m=m, n=n, has=has)
    c.update(rho_a=rho_a[None, :], rho_x=rho_x[None, :], Ax=c["x"] @ A.T)
    diagK = c["rho_x"] + 1e-6
    n_sweeps, n_refine, n_extra, alpha = 3, 1, 2, 1.6
    v = {k: jnp.asarray(c[k]) for k in c}
    g, ra, rx, dq2 = v["gamma"], v["rho_a"], v["rho_x"], v["dq2"]
    x, z, zx, y, yx, Ax = (v[k] for k in ("x", "z", "zx", "y", "yx", "Ax"))

    def Kmul(u):
        return u * jnp.asarray(diagK) + j.rmatvec(j.matvec(u) * ra)

    for _ in range(n_sweeps):
        rhs = (g * 1e-6 * x - v["q"] + j.rmatvec(g * ra * z - y)
               + (g * rx * zx - yx))
        xt = jshared._solve_shared_K(jbw, Kmul, dq2, g, rhs, n_refine,
                                     extra_if_dq2=n_extra, prec=mode)
        Axt = j.matvec(xt)
        x, z, zx, y, yx, Ax = (
            alpha * xt + (1 - alpha) * x,
            jnp.clip(alpha * Axt + (1 - alpha) * z + y / (g * ra), v["cl"],
                     v["cu"]),
            jnp.clip(alpha * xt + (1 - alpha) * zx + yx / (g * rx), v["lb"],
                     v["ub"]),
            y + g * ra * (alpha * Axt + (1 - alpha) * z - jnp.clip(
                alpha * Axt + (1 - alpha) * z + y / (g * ra), v["cl"],
                v["cu"])),
            yx + g * rx * (alpha * xt + (1 - alpha) * zx - jnp.clip(
                alpha * xt + (1 - alpha) * zx + yx / (g * rx), v["lb"],
                v["ub"])),
            alpha * Axt + (1 - alpha) * Ax)
    ell = [t.ell.rowcols, t.ell.rowvals, t.ell.colrows, t.ell.colvals]
    rest = ("cl", "cu", "lb", "ub", "rho_a", "rho_x", "dq2", "has", "gamma",
            "x", "z", "zx", "y", "yx", "Ax")
    got = cuda_kernels.fused_sweeps_sparse_plain(
        torch.as_tensor(c["q"]), *ell, lay, torch.as_tensor(diagK),
        *(torch.as_tensor(c[k]) for k in rest), n_sweeps, n_refine, n_extra,
        1e-6, alpha, precision=mode)
    tol = 1e-6 if mode == "default" else 2e-5
    for gt, r, name in zip(got, (x, z, zx, y, yx, Ax),
                           ("x", "z", "zx", "y", "yx", "Ax")):
        _close(_np(gt), np.asarray(r), tol, name)


def test_lowered_layout_parts():
    """The copies the structured kernel reads at a lowered mode: bf16
    entries, or bf16 pairs (both parts of an entry side by side), and the
    one-variable inverses and wide-row values as their parts in the
    working dtype, P = 1 or 2 of them (the count the kernel's wrapper
    checks against the mode)."""
    A, _, t, _, tbw, _, _ = _structured()
    lay = tsk.woodbury_layout(tbw, t)
    d = tsk.lowered_layout(lay, "default")
    h = tsk.lowered_layout(lay, "high")
    assert d.lo[0].dtype == torch.bfloat16 and d.lo[0].numel() == \
        lay.mats.numel()
    assert h.lo[0].numel() == 2 * lay.mats.numel()
    m1, m2 = tprec.bf16_parts(lay.mats, "high")
    assert torch.equal(h.lo[0].view(-1, 2)[:, 0], m1)
    assert torch.equal(h.lo[0].view(-1, 2)[:, 1], m2)
    for src, got in ((lay.dinv, h.lo[1]), (lay.wvals, h.lo[2]),
                     (lay.wtvals, h.lo[3])):
        p1, p2 = tprec.bf16_parts(src, "high")
        assert got.dtype == src.dtype and got.shape == (2,) + src.shape
        assert torch.equal(got[0], p1.to(src.dtype))
        assert torch.equal(got[1], p2.to(src.dtype))
    assert d.lo[1].shape[0] == 1 and d.lo[1].dtype == lay.dinv.dtype
    assert torch.equal(d.lo[1][0], tprec.bf16_parts(lay.dinv, "default")[0]
                       .to(lay.dinv.dtype))
    assert tsk.lowered_layout(lay, "highest").lo == ()


# ---------------------------------------------------------------------------
# frozen solves: the sweep phases against the reference
# ---------------------------------------------------------------------------

def _dense_problem(rng, S=5, m=8, n=6):
    A = rng.randn(S, m, n)
    c = rng.randn(S, n)
    q2 = np.abs(rng.randn(S, n)) * 0.1
    cl = -np.abs(rng.randn(S, m)) - 1.0
    cu = np.abs(rng.randn(S, m)) + 1.0
    lb = -2.0 * np.ones((S, n))
    ub = 2.0 * np.ones((S, n))
    return c, q2, A, cl, cu, lb, ub


@pytest.mark.parametrize("use_kernel", ["auto", False])
@pytest.mark.parametrize("mode", LOW)
def test_dense_frozen_matches_reference(mode, use_kernel):
    """``tests/test_precision.py``'s dense family: the lowered frozen solve
    with its refinement phase converges, and its iterate lies within 1e-6
    of the reference's lowered solve (and of the full-precision one)."""
    args = _dense_problem(np.random.RandomState(7))
    jst = jadmm.ADMMSettings(dtype="float64", max_iter=400, restarts=2)
    jsol, jfac = jadmm.solve_batch_factored(*args, settings=jst)
    jlo = jadmm.solve_batch_frozen(
        *args, jfac, settings=dataclasses.replace(
            jst, sweep_precision=mode, precision_refine_iters=200),
        warm=jsol.raw)
    assert bool(np.asarray(jlo.done).all())
    st = tadmm.ADMMSettings(dtype="float64", max_iter=400, restarts=2,
                            use_kernel=use_kernel)
    sol, fac = tadmm.solve_batch_factored(*args, settings=st, device="cpu")
    ref = tadmm.solve_batch_frozen(*args, fac, settings=st, warm=sol.raw)
    lo = tadmm.solve_batch_frozen(
        *args, fac, settings=dataclasses.replace(
            st, sweep_precision=mode, precision_refine_iters=200),
        warm=sol.raw)
    assert bool(lo.done.all())
    assert float(np.abs(_np(lo.x) - np.asarray(jlo.x)).max()) <= 1e-6
    assert float((lo.x - ref.x).abs().max()) <= 1e-6
    assert int(lo.iters[0]) > 0


@pytest.mark.parametrize("mode", LOW)
def test_shared_frozen_floor_matches_reference(mode):
    """``tests/test_precision.py``'s shared family (uc_lite S=5 with a
    prox term, a plateau at any precision): the lowered frozen solve holds
    the full-precision floor within the guard's bar, the port's and the
    reference's floor both, and the guard does not trip."""
    from tpusppy.ir import ScenarioBatch
    from tpusppy.models import uc_lite

    S = 5
    names = uc_lite.scenario_names_creator(S)
    batch = ScenarioBatch.from_problems(
        [uc_lite.scenario_creator(nm, num_scens=S, relax_integers=True)
         for nm in names])
    q2 = batch.q2.copy()
    q2[:, batch.tree.nonant_indices] += 5.0
    args = (batch.c, q2, batch.A_shared, batch.cl, batch.cu, batch.lb,
            batch.ub)
    jst = jadmm.ADMMSettings(dtype="float64", max_iter=1000, restarts=4)
    jsol, jfac = jshared.solve_shared_factored(*args, settings=jst)
    jref = jshared.solve_shared_frozen(*args, jfac, settings=jst,
                                       warm=jsol.raw)
    j_worst = float(max(np.asarray(jref.pri_res).max(),
                        np.asarray(jref.dua_res).max()))
    st = tadmm.ADMMSettings(dtype="float64", max_iter=1000, restarts=4)
    sol, fac = tshared.solve_shared_factored(*args, settings=st, device="cpu")
    ref = tshared.solve_shared_frozen(*args, fac, settings=st, warm=sol.raw)
    t_worst = float(max(ref.pri_res.max(), ref.dua_res.max()))
    st_lo = dataclasses.replace(st, sweep_precision=mode,
                                precision_refine_iters=300)
    got = tshared.solve_shared_frozen(*args, fac, settings=st_lo,
                                      warm=sol.raw)
    worst = float(max(got.pri_res.max(), got.dua_res.max()))
    assert np.isfinite(worst)
    for floor in (t_worst, j_worst):
        assert worst <= 10.0 * max(floor, st.eps_abs)
    assert not tadmm.precision_guard_trips(got, st_lo, t_worst)


def _phases_spy(monkeypatch, module, name):
    """Record (prec, sweeps) of every core run of a frozen solve."""
    calls = []
    core = getattr(module, name)

    def spy(*a, **k):
        out = core(*a, **k)
        calls.append((k.get("prec", a[12] if len(a) > 12 else None),
                      int(out.k)))
        return out

    monkeypatch.setattr(module, name, spy)
    return calls


def test_refinement_phase_adds_its_sweeps(monkeypatch):
    """A lowered phase 1 that stops short of eps (f64 eps 1e-8 in bf16)
    is followed by a full-precision phase on the same factors; the sweep
    count adds up across the phases, and the result converges."""
    args = _dense_problem(np.random.RandomState(7))
    st = tadmm.ADMMSettings(dtype="float64", max_iter=400, restarts=2)
    sol, fac = tadmm.solve_batch_factored(*args, settings=st, device="cpu")
    calls = _phases_spy(monkeypatch, tadmm, "_admm_core")
    lo = tadmm.solve_batch_frozen(
        *args, fac, settings=dataclasses.replace(
            st, sweep_precision="default", precision_refine_iters=200),
        warm=sol.raw)
    assert [c[0] for c in calls] == ["default", "highest"]
    assert calls[0][1] == st.max_iter and 0 < calls[1][1] <= 200
    assert int(lo.iters[0]) == calls[0][1] + calls[1][1]
    assert bool(lo.done.all())
    # without the refinement phase the bf16 iterate parks above the floor
    calls.clear()
    parked = tadmm.solve_batch_frozen(
        *args, fac, settings=dataclasses.replace(
            st, sweep_precision="default", precision_refine_iters=0),
        warm=sol.raw)
    assert [c[0] for c in calls] == ["default"]
    assert float(max(parked.pri_res.max(), parked.dua_res.max())) > float(
        max(lo.pri_res.max(), lo.dua_res.max()))


@pytest.mark.parametrize("engine", ["dense", "shared"])
def test_refinement_phase_sweeps_nothing_after_convergence(monkeypatch,
                                                           engine):
    """Where the lowered phase already converged, the refinement phase's
    first vote stops it: zero sweeps, the count unchanged.  At "high" the
    dense kernel runs exact (as the TPU kernel does) and converges at f64's
    eps; the shared kernel runs bf16x3 and converges at a looser one."""
    if engine == "dense":
        eps = 1e-8
        args = _dense_problem(np.random.RandomState(7))
        mod, name, frozen, factored = (tadmm, "_admm_core",
                                       tadmm.solve_batch_frozen,
                                       tadmm.solve_batch_factored)
    else:
        c, q2, A, cl, cu, lb, ub = _dense_problem(np.random.RandomState(7))
        args = (c, q2, A[0], cl, cu, lb, ub)     # one A for the batch
        mod, name, frozen, factored = (tshared, "_core",
                                       tshared.solve_shared_frozen,
                                       tshared.solve_shared_factored)
        eps = 1e-4
    st = tadmm.ADMMSettings(dtype="float64", max_iter=400, restarts=2,
                            eps_abs=eps, eps_rel=eps)
    sol, fac = factored(*args, settings=st, device="cpu")
    calls = _phases_spy(monkeypatch, mod, name)
    lo = frozen(*args, fac, settings=dataclasses.replace(
        st, sweep_precision="high"), warm=sol.raw)
    assert bool(lo.done.all())
    assert len(calls) == 2 and calls[1] == ("highest", 0)
    assert int(lo.iters[0]) == calls[0][1]


# ---------------------------------------------------------------------------
# the guard and the fallback
# ---------------------------------------------------------------------------

def _fake_sol(pri, dua, done):
    S = len(pri)
    z = torch.zeros((S, 1), dtype=F64)
    return tadmm.BatchSolution(
        x=z, z=z, y=z, yx=z, pri_res=torch.tensor(pri, dtype=F64),
        dua_res=torch.tensor(dua, dtype=F64),
        iters=torch.zeros(S, dtype=torch.int64),
        done=torch.tensor(done), raw=(z, z, z, z))


_GUARD = tadmm.ADMMSettings(eps_abs=1e-6, eps_rel=1e-6,
                            sweep_precision="default", precision_guard=10.0)


@pytest.mark.parametrize("case,settings,sol,ref_worst,trips", [
    ("converged never trips", {}, ([1.0], [1.0], [True]), 1e-8, False),
    ("parked above the floor trips", {}, ([1e-2], [1e-3], [False]), 1e-6,
     True),
    ("a plateau family at its floor", {}, ([1e-1], [1e-2], [False]), 1e-1,
     False),
    ("non-finite always trips", {}, ([np.nan], [1.0], [False]), 1e-1, True),
    ("full precision never", {"sweep_precision": None},
     ([1e2], [1e2], [False]), 1e-8, False),
    ("guard off never", {"precision_guard": 0.0}, ([1e2], [1e2], [False]),
     1e-8, False),
])
def test_precision_guard_trips(case, settings, sol, ref_worst, trips):
    """``tests/test_precision.py:195``'s six cases, through the fetch and
    through precomputed stats, both packages agreeing."""
    st = dataclasses.replace(_GUARD, **settings)
    fake = _fake_sol(*sol)
    assert tadmm.precision_guard_trips(fake, st, ref_worst) is trips, case
    worst = float(np.nanmax(sol[0] + sol[1])) if not np.isnan(
        sol[0] + sol[1]).any() else float("nan")
    assert tadmm.precision_guard_trips(
        fake, st, ref_worst, stats=(worst, all(sol[2]))) is trips, case
    jst = dataclasses.replace(
        jadmm.ADMMSettings(eps_abs=1e-6, eps_rel=1e-6,
                           sweep_precision="default", precision_guard=10.0),
        **settings)
    z = np.zeros((1, 1))
    jsol = jadmm.BatchSolution(
        x=z, z=z, y=z, yx=z, pri_res=np.asarray(sol[0]),
        dua_res=np.asarray(sol[1]), iters=np.zeros(1),
        done=np.asarray(sol[2]), raw=(z, z, z, z))
    assert jadmm.precision_guard_trips(jsol, jst, ref_worst) is trips


def test_guard_fallback_restores_full_precision_result():
    """``tests/test_precision.py:219``'s protocol: a crippled lowered
    solve (no refinement phase) trips the guard, and the re-run at
    "highest" on the same factors converges and does not."""
    args = _dense_problem(np.random.RandomState(10))
    st = tadmm.ADMMSettings(dtype="float64", max_iter=400, restarts=2)
    sol, fac = tadmm.solve_batch_factored(*args, settings=st, device="cpu")
    ref_worst = float(max(sol.pri_res.max(), sol.dua_res.max()))
    st_lo = dataclasses.replace(st, sweep_precision="default",
                                precision_refine_iters=0)
    cand = tadmm.solve_batch_frozen(*args, fac, settings=st_lo, warm=sol.raw)
    assert tadmm.precision_guard_trips(cand, st_lo, ref_worst)
    st_full = dataclasses.replace(st_lo, sweep_precision="highest")
    fixed = tadmm.solve_batch_frozen(*args, fac, settings=st_full,
                                     warm=sol.raw)
    assert bool(fixed.done.all())
    assert not tadmm.precision_guard_trips(fixed, st_full, ref_worst)


def test_spopt_guard_fallback_counts_and_restores(monkeypatch):
    """The solve loop's fallback: a lowered frozen attempt the guard trips
    on is re-run at "highest" on the same factors, ``precision.guard_trips``
    counts it, and the solve takes the full-precision result; the refresh
    itself never runs lowered."""
    names = tfarmer.scenario_names_creator(3)
    opts = {"device": "cpu", "solver_options": {
        "sweep_precision": "default", "precision_refine_iters": 0,
        "max_iter": 400, "restarts": 2}}
    opt = SPOpt(opts, names, tfarmer.scenario_creator,
                scenario_creator_kwargs={"num_scens": 3})
    full = SPOpt(dict(opts, solver_options=dict(
        opts["solver_options"], sweep_precision=None)), names,
        tfarmer.scenario_creator, scenario_creator_kwargs={"num_scens": 3})
    precs = []
    frozen = tadmm.solve_batch_frozen

    def spy(*a, settings, **k):
        precs.append(settings.sweep_precision)
        return frozen(*a, settings=settings, **k)

    factored = tadmm.solve_batch_factored
    refresh_precs = []

    def spy_f(*a, settings, **k):
        refresh_precs.append(settings.sweep_precision)
        return factored(*a, settings=settings, **k)

    monkeypatch.setattr(tadmm, "solve_batch_frozen", spy)
    monkeypatch.setattr(tadmm, "solve_batch_factored", spy_f)
    q = opt.batch.c * 1.01
    for o in (opt, full):
        o.solve_loop()
    assert opt._factors_ref_worst is not None
    t0 = tmetrics.value("precision.guard_trips")
    precs.clear()
    x = opt.solve_loop(q=q)
    assert tmetrics.value("precision.guard_trips") == t0 + 1
    assert precs == ["default", "highest"]
    assert refresh_precs[0] in (None, "highest")
    x_full = full.solve_loop(q=q)
    np.testing.assert_allclose(x, x_full, rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# PH and the options
# ---------------------------------------------------------------------------

def _recorder(base):
    class Recorder(base):
        def __init__(self, opt):
            super().__init__(opt)
            opt.trace = []

        def enditer(self):
            self.opt.trace.append((self.opt.conv, self.opt.Eobjective()))

    return Recorder


def _reference_refinement_spy(monkeypatch):
    """The sweeps of every refinement phase the reference runs, recorded
    from inside its frozen programs (``jax.debug.callback``); its caches
    are cleared so that the programs are traced with the spy."""
    swept = []
    phases = jadmm._frozen_sweep_phases

    def spy(run_core, state0, settings, dt):
        def core(state, st, prec):
            out = run_core(state, st, prec)
            if prec == "highest":       # only the refinement phase's
                jax.debug.callback(lambda k: swept.append(int(k)), out.k)
            return out

        return phases(core, state0, settings, dt)

    monkeypatch.setattr(jadmm, "_frozen_sweep_phases", spy)
    monkeypatch.setattr(jshared, "_frozen_sweep_phases", spy)
    jax.clear_caches()
    return swept


def _guard_counts(run_reference, run_port, monkeypatch):
    """``(reference, port)`` guard trips and refinement-phase sweeps of
    the two runs."""
    swept = _reference_refinement_spy(monkeypatch)
    j0 = jmetrics.value("precision.guard_trips")
    run_reference()
    jax.effects_barrier()
    ref = (jmetrics.value("precision.guard_trips") - j0, sum(swept))
    tadmm.refinement_sweeps(reset=True)
    t0 = tmetrics.value("precision.guard_trips")
    run_port()
    port = (tmetrics.value("precision.guard_trips") - t0,
            tadmm.refinement_sweeps(reset=True))
    return ref, port


def test_ph_default_matches_reference_farmer3(monkeypatch):
    """farmer S=3 PH with the frozen solves at "default" (bf16 sweeps, a
    400-sweep refinement phase, the guard on) in both packages, the
    reference on its legacy per-iteration loop: the same trajectory to
    the tolerances of the module docstring, the same trivial bound (Iter0
    refreshes at full precision), both took the lowered path, and the
    guard tripped as often and the refinement phases swept as much in
    both."""
    so = {"megastep": 1, "sweep_precision": "default",
          "precision_refine_iters": 400}
    opts = {"defaultPHrho": 1.0, "PHIterLimit": 20, "convthresh": 1e-6,
            "solver_options": so}
    names = farmer.scenario_names_creator(3)
    kw = {"num_scens": 3}
    jph = JPH(dict(opts), names, farmer.scenario_creator,
              scenario_creator_kwargs=kw, extensions=_recorder(JExtension))
    runs = {}
    modes = []
    plain = cuda_kernels.fused_sweeps_plain

    def spy(*a, **k):
        modes.append(a[20] if len(a) > 20 else k.get("precision", "highest"))
        return plain(*a, **k)

    monkeypatch.setattr(cuda_kernels, "fused_sweeps_plain", spy)
    tph = TPH(dict(opts, device="cpu"), names, tfarmer.scenario_creator,
              scenario_creator_kwargs=kw, extensions=_recorder(TExtension))
    ref, port = _guard_counts(lambda: runs.update(j=jph.ph_main()),
                              lambda: runs.update(t=tph.ph_main()),
                              monkeypatch)
    jres, tres = runs["j"], runs["t"]
    assert port == ref and ref[0] > 0
    assert tph.admm_settings.sweep_precision == "default"
    a, b = np.asarray(jph.trace), np.asarray(tph.trace)
    assert a.shape == b.shape == (20, 2)
    np.testing.assert_allclose(b[:, 1], a[:, 1], rtol=2e-7, atol=0)
    np.testing.assert_allclose(b[:, 0], a[:, 0], rtol=2e-4, atol=0)
    assert tres[2] == pytest.approx(jres[2], rel=1e-9)
    assert tres[1] == pytest.approx(jres[1], rel=2e-7)
    # the kernel path's plain version ran lowered in the frozen phases and
    # exact in the refreshes and refinement phases
    assert modes.count("default") > 0 and modes.count("highest") > 0


def test_guard_trips_match_reference_uc_lite_f32(monkeypatch):
    """uc_lite S=5 PH in float32 at eps 1e-5 (the main paths' settings on
    the card) with the frozen solves at "default" and the default 64-sweep
    refinement phase: the bf16 phase parks and the refinement phase runs
    out of sweeps above eps, so the guard re-runs the frozen solve at
    "highest", in the reference as in the port: the same guard trips and
    refinement-phase sweeps, and eobj to 1e-5 (float32 sums in another
    order)."""
    so = {"megastep": 1, "sweep_precision": "default", "dtype": "float32",
          "eps_abs": 1e-5, "eps_rel": 1e-5}
    opts = {"defaultPHrho": 500.0, "PHIterLimit": 6, "convthresh": 1e-5,
            "solver_options": so}
    kw = {"num_scens": 5, "relax_integers": True}
    names = tuc_lite.scenario_names_creator(5)
    jph = JPH(dict(opts), names, juc_lite.scenario_creator,
              scenario_creator_kwargs=kw)
    tph = TPH(dict(opts, device="cpu"), names, tuc_lite.scenario_creator,
              scenario_creator_kwargs=kw)
    runs = {}
    ref, port = _guard_counts(lambda: runs.update(j=jph.ph_main()),
                              lambda: runs.update(t=tph.ph_main()),
                              monkeypatch)
    assert port == ref and ref[0] > 0
    assert runs["t"][1] == pytest.approx(runs["j"][1], rel=1e-5)


def test_make_admm_settings_precision_options():
    st = make_admm_settings({"solver_options": {
        "sweep_precision": "high", "precision_refine_iters": 17,
        "precision_guard": 3.0}})
    assert (st.sweep_precision, st.precision_refine_iters,
            st.precision_guard) == ("high", 17, 3.0)
    assert st.sweep_mode() == "high"
    assert make_admm_settings({"solver_options": {
        "sweep_precision": None}}).sweep_mode() == "highest"
    with pytest.raises(ValueError, match="must be one of"):
        make_admm_settings({"solver_options": {"sweep_precision": "bf16"}})
    with pytest.raises(NotImplementedError, match="matmul_precision"):
        make_admm_settings({"solver_options": {"matmul_precision": "high"}})


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _rms(got, want):
    """Largest over the outputs of ||got - want|| / ||want||."""
    return max(float((g.double() - w.double()).norm() / w.double().norm())
               for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel,mode", [
    ("dense", "default"), ("shared", "default"), ("shared", "high"),
    ("sparse", "default"), ("sparse", "high"), ("structured", "default"),
    ("structured", "high")])
def test_cuda_kernels_lowered_match_plain(kernel, mode, dtype):
    """Each kernel at each lowered mode against its plain version on the
    card (its launch counted as lowered), at ``chip_smoke.py``'s
    tolerances: f64 to 1e-7 (the same bf16 products summed in f64 in
    another order, the structured apply's too), f32 to 2e-2 at "default"
    and 2e-4 at "high" (where two f32 sums differ in their last digit, the
    next operand's bf16 rounding can fall the other way: 2^-8 of it at
    "default", 2^-16 at "high"; measured up to 7.1e-3 and 1.8e-5 on an
    H100).  The control of ``chip_smoke.py``: the kernel lies at most a
    third as far (relative Frobenius distance) from the lowered plain
    version as from the plain version at "highest", in f64 and in f32 at
    "default" (in f32 at "high" bf16x3 keeps an operand to about what an
    f32 sum's last digit moves its low part by).  A structured operand
    without its lowered copies is refused at a lowered mode."""
    tol = 1e-7 if dtype == F64 else {"default": 2e-2, "high": 2e-4}[mode]
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    dev = "cuda"
    # A scaled by 1/sqrt(n), so K stays well conditioned in f32
    if kernel == "dense":
        c, sigma = _dense_case(S=64, m=28, n=44, a_scale=44 ** -0.5)
        args = [torch.as_tensor(c[k], dtype=dtype, device=dev)
                for k in _DENSE]
        run = lambda f, p=mode: f(*args, 4, 2, sigma, 1.6, precision=p)
        kern, plain = (cuda_kernels.fused_sweeps,
                       cuda_kernels.fused_sweeps_plain)
    elif kernel == "shared":
        c, sigma = _shared_case(S=40, m=30, n=20, a_scale=20 ** -0.5)
        args = [torch.as_tensor(c[k], dtype=dtype, device=dev)
                for k in _SHARED]
        run = lambda f, p=mode: f(*args, 4, 2, 2, sigma, 1.6, precision=p)
        kern, plain = (cuda_kernels.fused_sweeps_shared,
                       cuda_kernels.fused_sweeps_shared_plain)
    else:
        if kernel == "sparse":
            A = _sparse_A(m=40, n=24, a_scale=24 ** -0.5)
        else:
            # the uc model's pattern (blocks, one-variable components and
            # wide rows), values of magnitude 1 / sqrt(kr kc)
            pat = _uc_A() != 0
            scale = (pat.sum(1).max() * pat.sum(0).max()) ** -0.5
            A = np.where(pat, np.random.RandomState(4).uniform(
                0.5, 1.0, pat.shape), 0.0) * scale
        m, n = A.shape
        c, sigma = _shared_case(seed=11, S=20, m=m, n=n)
        sp = tsparse.SparseA.from_dense(A, dtype, dev,
                                        structure=kernel == "structured")
        if kernel == "sparse":
            K = (A.T * c["rho_a"][0]) @ A + sigma * np.eye(n) + np.diag(
                c["rho_x"][0])
            Kinv = torch.as_tensor(np.linalg.inv(K), dtype=dtype,
                                   device=dev)
        else:
            assert sp.structure is not None
            t = lambda v: torch.as_tensor(v[0], dtype=dtype, device=dev)
            lay = tsk.woodbury_layout(tsk.factor_structured(
                sp, sp.structure, t(c["rho_x"]), t(c["rho_a"]), sigma), sp)
            bare = lay
            Kinv = tsk.lowered_layout(lay, mode)
        c.update(Ax=c["x"] @ A.T)
        rest = ("cl", "cu", "lb", "ub", "rho_a", "rho_x", "dq2", "has",
                "gamma", "x", "z", "zx", "y", "yx", "Ax")
        head = [torch.as_tensor(c["q"], dtype=dtype, device=dev)] + list(
            sp.ell)
        tail = [torch.as_tensor(c["rho_x"] + sigma, dtype=dtype,
                                device=dev)] + [
            torch.as_tensor(c[k], dtype=dtype, device=dev) for k in rest]
        args = head + [Kinv] + tail
        run = lambda f, p=mode: f(*args, 4, 1, 2, sigma, 1.6, precision=p)
        kern, plain = (cuda_kernels.fused_sweeps_sparse,
                       cuda_kernels.fused_sweeps_sparse_plain)
        if kernel == "structured":
            with pytest.raises(ValueError, match="lowered copies"):
                kern(*head, bare, *tail, 4, 1, 2, sigma, 1.6,
                     precision=mode)
    cuda_kernels.reset_counts()
    got = run(kern)
    torch.cuda.synchronize()
    name = {"dense": "fused_sweeps", "shared": "fused_sweeps_shared"}.get(
        kernel, "fused_sweeps_sparse")
    assert cuda_kernels.launches[name] == 1
    assert cuda_kernels.lowered_launches[f"{name}:{mode}"] == 1
    if kernel in ("sparse", "structured"):
        assert cuda_kernels.sparse_modes[
            "dense" if kernel == "sparse" else "structured"] == 1
    want = run(plain)
    for g, w in zip(got, want):
        _close(_np(g), _np(w), tol)
    if dtype == F64 or mode == "default":
        exact = run(plain, "highest")
        assert _rms(got, want) <= _rms(got, exact) / 3
