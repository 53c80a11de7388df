"""The structured mode of ``fused_sweeps_sparse`` against the reference.

The port's sparse sweep applies the block/Woodbury K^-1 itself, through the
operator's kernel layout (``structured_kkt.KernelWoodbury``), where the
reference's Pallas kernel takes a densified (n, n) matrix and its XLA sweep
applies the BlockWoodbury.  Each test runs both packages on the same inputs
(seeded numpy arrays, or the uc model's own matrix), in float64 on the CPU.
Tolerances, relative to the largest entry (floored at 1):

- the structured plain sweep against the reference's XLA sweep block on the
  same SparseA and BlockWoodbury (``shared_admm._solve_shared_K``): 1e-12,
  the same operator summed in another order;
- the same sweep against the Pallas interpreter fed the densified operator:
  1e-10, the Woodbury operator against its densified matrix;
- the narrow/wide split of A x against the full ELL product: 1e-14 (the
  same terms; a narrow row's padding slots add zeros);
- the layout's apply against ``kinv_apply``: 1e-12.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpusppy.solvers import pallas_kernels
from tpusppy.solvers import shared_admm as jshared
from tpusppy.solvers import structured_kkt as jsk
from tpusppy.solvers.sparse import SparseA as JSparseA
from tpusppy_torch import convert
from tpusppy_torch.models import uc as tuc
from tpusppy_torch.solvers import cuda_kernels
from tpusppy_torch.solvers import shared_admm as tshared
from tpusppy_torch.solvers import sparse as tsparse
from tpusppy_torch.solvers import structured_kkt as tsk
from tpusppy_torch.solvers.admm import ADMMSettings as TSettings
from tpusppy_torch.spbase import build_batch

torch.set_num_threads(1)

_ORDER = ("q", "rowcols", "rowvals", "colrows", "colvals", "Kinv", "diagK",
          "cl", "cu", "lb", "ub", "rho_a", "rho_x", "dq2", "has", "gamma",
          "x", "z", "zx", "y", "yx", "Ax")


def _close(got, ref, tol, what=""):
    got = np.asarray(got, dtype=float)
    ref = np.asarray(ref, dtype=float)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.max(np.abs(ref))) if ref.size else 1.0)
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol:.0e} * {scale:.3g}"


def _block_A(seed=42, n_blk=6, bs=5):
    """Six 5-variable blocks with 7 narrow rows each, one variable alone,
    and 3 wide coupling rows (tests/test_sparse_structured.py's matrix with
    a one-variable component added)."""
    rng = np.random.default_rng(seed)
    n = n_blk * bs + 1
    rows = []
    for k in range(n_blk):
        for _ in range(7):
            r = np.zeros(n)
            idx = rng.choice(np.arange(k * bs, (k + 1) * bs), 3,
                             replace=False)
            r[idx] = rng.normal(size=3)
            rows.append(r)
    r = np.zeros(n)
    r[n - 1] = 1.5
    rows.append(r)
    for _ in range(3):
        rows.append(np.where(rng.random(n) < 0.6, rng.normal(size=n), 0.0))
    return np.array(rows)


def _uc_A(num_gens=10, horizon=4):
    """The uc model's shared A: at 10 generators its balance and reserve
    rows are wide, and the structure has 16-variable blocks and
    one-variable components."""
    b, _ = build_batch(tuc.scenario_names_creator(2), tuc.scenario_creator,
                       {"num_scens": 2, "num_gens": num_gens,
                        "horizon": horizon, "relax_integers": True})
    return b.A_shared


_MATRICES = {"block": (_block_A, {"min_blocks": 2}), "uc": (_uc_A, {})}


def _both(which):
    make, kw = _MATRICES[which]
    A = make()
    j = JSparseA.from_dense(A, jnp.float64, structure=True, ell=True, **kw)
    t = tsparse.SparseA.from_dense(A, torch.float64, "cpu", structure=True,
                                   **kw)
    assert j.structure is not None and t.structure is not None
    return A, j, t


def _port_bw(jbw):
    """The reference's BlockWoodbury as the port's, value for value."""
    def t(v):
        return torch.as_tensor(np.array(v))
    return tsk.BlockWoodbury(
        binv=tuple(t(b) for b in jbw.binv),
        bvars=tuple(t(b).long() for b in jbw.bvars), Aw=t(jbw.Aw),
        Cinv=t(jbw.Cinv))


def _case(which, S, has, seed=5):
    """Sweep inputs on a structured matrix: rho_a, rho_x in [0.5, 1], K's
    block/Woodbury factors made by the reference (and carried over to the
    port exactly), gamma in [0.5, 1.5], dq2 ~ 0.1 |N(0, 1)| when ``has``."""
    A, j, t = _both(which)
    rng = np.random.RandomState(seed)
    m, n = A.shape
    sigma = 1e-6
    rho_a = rng.uniform(0.5, 1.0, m)
    rho_x = rng.uniform(0.5, 1.0, n)
    jbw = jsk.factor_structured(j, j.structure, jnp.asarray(rho_x),
                                jnp.asarray(rho_a), sigma)
    lay = tsk.woodbury_layout(_port_bw(jbw), t)
    cl = -np.abs(rng.randn(S, m)) - 0.5
    cu = np.abs(rng.randn(S, m)) + 0.5
    x = rng.randn(S, n) * 0.1
    c = dict(q=rng.randn(S, n), rowcols=t.ell.rowcols.numpy(),
             rowvals=t.ell.rowvals.numpy(), colrows=t.ell.colrows.numpy(),
             colvals=t.ell.colvals.numpy(), diagK=(rho_x + sigma)[None, :],
             cl=cl, cu=cu, lb=-2.0 * np.ones((S, n)),
             ub=2.0 * np.ones((S, n)), rho_a=rho_a[None, :],
             rho_x=rho_x[None, :],
             dq2=0.1 * np.abs(rng.randn(S, n)) * has,
             has=np.full((1, 1), float(has)),
             gamma=0.5 + rng.rand(S, 1), x=x,
             z=np.clip(rng.randn(S, m), cl, cu), zx=np.clip(x, -2.0, 2.0),
             y=rng.randn(S, m) * 0.1, yx=rng.randn(S, n) * 0.1, Ax=x @ A.T)
    return c, j, jbw, lay, sigma


def _port_args(c, lay):
    return [lay if k == "Kinv" else torch.as_tensor(
        c[k], dtype=torch.int32 if k in ("rowcols", "colrows")
        else torch.float64) for k in _ORDER]


def _xla_block(c, jA, jbw, n_sweeps, n_refine, n_extra, sigma, alpha):
    """The reference's XLA sweep block (``shared_admm._core``'s ``block``
    on a SparseA at full precision), its K^-1 through ``_solve_shared_K``
    with the BlockWoodbury and the defect matrix-free through A."""
    v = {k: jnp.asarray(c[k]) for k in c}
    g, rho_a, rho_x, dq2 = v["gamma"], v["rho_a"], v["rho_x"], v["dq2"]
    x, z, zx, y, yx, Ax = (v[k] for k in ("x", "z", "zx", "y", "yx", "Ax"))
    q, cl, cu, lb, ub = (v[k] for k in ("q", "cl", "cu", "lb", "ub"))

    def Kmul(u):
        return u * v["diagK"] + jA.rmatvec(jA.matvec(u) * rho_a)

    sigma_s, rho_a_s, rho_x_s = g * sigma, g * rho_a, g * rho_x
    for _ in range(n_sweeps):
        rhs = (sigma_s * x - q + jA.rmatvec(rho_a_s * z - y)
               + (rho_x_s * zx - yx))
        xt = jshared._solve_shared_K(jbw, Kmul, dq2, g, rhs, n_refine,
                                     extra_if_dq2=n_extra)
        Axt = jA.matvec(xt)
        x_new = alpha * xt + (1 - alpha) * x
        Ax_new = alpha * Axt + (1 - alpha) * Ax
        z_new = jnp.clip(alpha * Axt + (1 - alpha) * z + y / rho_a_s, cl, cu)
        y_new = y + rho_a_s * (alpha * Axt + (1 - alpha) * z - z_new)
        zx_new = jnp.clip(alpha * xt + (1 - alpha) * zx + yx / rho_x_s, lb,
                          ub)
        yx_new = yx + rho_x_s * (alpha * xt + (1 - alpha) * zx - zx_new)
        x, z, zx, y, yx, Ax = x_new, z_new, zx_new, y_new, yx_new, Ax_new
    return x, z, zx, y, yx, Ax


_FIXED = (3, 1, 2, 1.6)      # n_sweeps, n_refine, n_extra, alpha


@pytest.mark.parametrize("has", [1, 0])
@pytest.mark.parametrize("which", ["block", "uc"])
def test_structured_plain_sweep_matches_reference_xla(which, has):
    c, jA, jbw, lay, sigma = _case(which, 6, has)
    n_sweeps, n_refine, n_extra, alpha = _FIXED
    ref = _xla_block(c, jA, jbw, n_sweeps, n_refine, n_extra, sigma, alpha)
    cuda_kernels.reset_counts()
    got = cuda_kernels.fused_sweeps_sparse_plain(
        *_port_args(c, lay), n_sweeps, n_refine, n_extra, sigma, alpha)
    assert cuda_kernels.plain_calls["fused_sweeps_sparse"] == 1
    for name, g, r in zip(("x", "z", "zx", "y", "yx", "Ax"), got, ref):
        _close(g, r, 1e-12, name)


@pytest.mark.parametrize("has", [1, 0])
@pytest.mark.parametrize("which", ["block", "uc"])
def test_structured_plain_sweep_matches_pallas_densified(which, has):
    """The reference's Pallas kernel in the interpreter, fed the densified
    operator, as its engine feeds it."""
    c, jA, jbw, lay, sigma = _case(which, 9, has)
    n = c["q"].shape[1]
    n_sweeps, n_refine, n_extra, alpha = _FIXED
    dense = dict(c, Kinv=np.asarray(jsk.kinv_apply(jbw, jnp.eye(n))))
    ref = pallas_kernels.fused_sweeps_sparse(
        *(jnp.asarray(dense[k]) for k in _ORDER), n_sweeps=n_sweeps,
        n_refine=n_refine, n_extra=n_extra, sigma=sigma, alpha=alpha, bs=8,
        precision="highest", interpret=True)
    got = cuda_kernels.fused_sweeps_sparse_plain(
        *_port_args(c, lay), n_sweeps, n_refine, n_extra, sigma, alpha)
    for name, g, r in zip(("x", "z", "zx", "y", "yx", "Ax"), got, ref):
        _close(g, r, 1e-10, name)


@pytest.mark.parametrize("which", ["block", "uc", "uc_wide"])
def test_narrow_wide_split_matches_full_ell(which):
    """Every A product the structured mode takes (A x for the defect and
    for Ax) reads a narrow row's first kn slots and a wide row's own list:
    the same terms as the full ELL row, and as the reference's product."""
    if which == "uc_wide":
        A = _uc_A(num_gens=12, horizon=3)
        j = JSparseA.from_dense(A, jnp.float64, structure=True, ell=True)
        t = tsparse.SparseA.from_dense(A, torch.float64, "cpu",
                                       structure=True)
    else:
        A, j, t = _both(which)
    rng = np.random.default_rng(2)
    m, n = A.shape
    E, D = rng.random(m) + 0.5, rng.random(n) + 0.5
    ts = t.scale(torch.as_tensor(E), torch.as_tensor(D))
    jbw_rho = rng.random(m) + 0.5
    bw = tsk.factor_structured(ts, ts.structure,
                               torch.as_tensor(rng.random(n) + 0.5),
                               torch.as_tensor(jbw_rho), 1e-6)
    lay = tsk.woodbury_layout(bw, ts)
    pat = lay.pattern
    counts = np.bincount(t.rows.numpy(), minlength=m)
    narrow = np.setdiff1d(np.arange(m), pat.wide.numpy())
    assert pat.kn == counts[narrow].max() <= tsparse.NARROW_K
    assert (counts[pat.wide.numpy()] > pat.kn).all()
    x = rng.normal(size=(4, n))
    rc_t, rv_t, _, _ = ts.ell_t()
    got = tsk.narrow_wide_matvec(lay, torch.as_tensor(x))
    ncols = pat.ncols.numpy()
    assert (ncols[0, pat.wide.numpy()] == -1).all()
    np.testing.assert_array_equal(ncols[:, narrow], rc_t[:pat.kn, narrow])
    assert not lay.nvals[:, pat.wide].any()
    _close(got, tsparse.ell_matvec(rc_t, rv_t, torch.as_tensor(x)), 1e-14,
           "split vs full ELL")
    js = j.scale(jnp.asarray(E), jnp.asarray(D))
    _close(got, js.matvec(jnp.asarray(x)), 1e-14, "split vs reference")


@pytest.mark.parametrize("which", ["block", "uc"])
def test_layout_apply_matches_kinv_apply(which):
    """The kernel layout, read step by step as the kernel reads it, is the
    reference's operator; its blocks are the components at their real
    sizes, in position order."""
    c, _, jbw, lay, _ = _case(which, 4, 1)
    pat = lay.pattern
    n = c["q"].shape[1]
    order, pos = pat.order.numpy(), pat.pos.numpy()
    np.testing.assert_array_equal(np.sort(order), np.arange(n))
    np.testing.assert_array_equal(pos[order], np.arange(n))
    sizes = [s for _, s, _, _ in pat.binfo[:-1]]
    assert pat.pd == sum(sizes) and min(sizes, default=2) >= 2
    assert pat.binfo[-1][1] == pat.r
    for off, s, ld, p0 in pat.binfo:
        assert ld % tsk.ROW_PAD == 0 and s <= ld < s + tsk.ROW_PAD
        blk = lay.mats[off:off + ld * ld].view(ld, ld)
        assert not blk[s:].any() and not blk[:, s:].any()
    if which == "block":
        assert sizes == [5] * 6 and n - pat.pd == 1
    b = np.random.default_rng(7).normal(size=(3, n))
    ref = np.asarray(jsk.kinv_apply(jbw, jnp.asarray(b)))
    _close(tsk.layout_apply(lay, torch.as_tensor(b)), ref, 1e-12,
           "layout_apply")
    _close(tsk.kinv_apply(lay.bw, torch.as_tensor(b)), ref, 1e-12,
           "kinv_apply")
    # every panel is whole rows of one stored matrix, in order
    for isz in (4, 8):
        items = pat.items[isz].numpy()
        for blk in range(pat.nb + 1):
            mine = items[items[:, 0] == blk]
            ld = pat.binfo[blk][2]
            assert mine[0, 1] == 0 and mine[:, 2].sum() == ld
            assert (mine[:, 2] * ld * isz <= max(
                tsk.STAGE_BYTES, tsk.ROW_PAD * ld * isz)).all()
        assert pat.stage_elems[isz] == max(
            r * pat.binfo[b_][2] for b_, _, r in items)


def test_full_width_uc_layout():
    """The main path's operator: uc at 30 generators x 24 hours splits into
    30 components of 96 variables and 48 of one, with 184 wide rows; the
    kernel works on the real sizes (96, not the bucket's 128)."""
    A = _uc_A(num_gens=30, horizon=24)
    t = tsparse.SparseA.from_dense(A, torch.float32, "cpu", structure=True)
    pat = tsk.woodbury_pattern(t)
    assert tsk.woodbury_pattern(t.scale(torch.ones(A.shape[0]),
                                        torch.ones(A.shape[1]))) is pat
    assert pat.nb == 30 and {s for _, s, _, _ in pat.binfo[:-1]} == {96}
    assert all(ld == 96 for _, _, ld, _ in pat.binfo[:-1])
    assert pat.binfo[-1][1:3] == (184, 192) and pat.r == 184
    assert pat.pd == 2880 and A.shape[1] - pat.pd == 48
    assert pat.kn <= tsparse.NARROW_K and pat.wcols.shape == (61, 184)
    # a 96-block is one f32 panel and two f64 panels
    assert pat.items[4].shape[0] == 30 + 4
    assert pat.items[8].shape[0] == 60 + 12
    assert pat.stage_elems == {4: 96 * 96, 8: 48 * 96}
    assert pat.mats_src.numel() == 30 * 96 * 96 + 192 * 192


def test_structured_sizing_gate():
    """The structured mode keeps one n-vector a scenario in shared memory
    beside two staged panels: 8 scenarios a block in f32 and 4 in f64 at
    uc's shape, like the dense mode."""
    A = _uc_A(num_gens=30, horizon=24)
    t = tsparse.SparseA.from_dense(A, torch.float32, "cpu", structure=True)
    m, n = A.shape
    rng = np.random.default_rng(0)
    bw = tsk.factor_structured(t, t.structure,
                               torch.as_tensor(rng.random(n) + 0.5,
                                               dtype=torch.float32),
                               torch.as_tensor(rng.random(m) + 0.5,
                                               dtype=torch.float32), 1e-6)
    lay = tsk.woodbury_layout(bw, t)
    f32, f64 = torch.float32, torch.float64
    assert cuda_kernels.usable_sparse(1000, m, n, 61, 10, f32, lay) == 8
    assert cuda_kernels.usable_sparse(1000, m, n, 61, 10, f64,
                                      lay.astype(f64)) == 4
    # gammas, x-tilde, two stages, partial sums, four bmax-row vectors
    assert cuda_kernels.sparse_smem_bytes(n, 4, 8, lay) == (
        16 + 32 + 4 * 8 * n + 2 * 4 * 96 * 96 + 4 * 8 * 512
        + 4 * 4 * 8 * 192)
    assert cuda_kernels.sparse_smem_bytes(n, 4, 8, lay) <= \
        cuda_kernels.SMEM_LIMIT
    # the dense mode's sizes are unchanged
    assert cuda_kernels.sparse_smem_bytes(n, 4, 8) == 203808
    # one scenario a block up to n ~ 38,600 in f32 at uc's stages
    assert cuda_kernels.usable_sparse(10, m, 38000, 61, 10, f32, lay) == 1
    assert cuda_kernels.usable_sparse(10, m, 40000, 61, 10, f32, lay) is None
    # a stored block wider than the threads of a block
    wide = lay._replace(pattern=lay.pattern._replace(bmax=520))
    assert cuda_kernels.usable_sparse(10, m, n, 61, 10, f32, wide) is None


def test_structured_wrapper_on_cpu_runs_plain():
    """On CPU tensors the wrapper runs the plain version in the operand's
    mode and launches nothing."""
    c, _, _, lay, sigma = _case("uc", 5, 1)
    cuda_kernels.reset_counts()
    got = cuda_kernels.fused_sweeps_sparse(*_port_args(c, lay), 2, 1, 2,
                                           sigma, 1.6)
    want = cuda_kernels.fused_sweeps_sparse_plain(*_port_args(c, lay), 2, 1,
                                                  2, sigma, 1.6)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert cuda_kernels.plain_calls["fused_sweeps_sparse"] == 2
    assert not any(cuda_kernels.launches.values())
    assert not any(cuda_kernels.sparse_modes.values())
    assert lay.device.type == "cpu" and lay.dtype == torch.float64
    assert lay.astype(torch.float32).mats.dtype == torch.float32


def test_structured_engine_builds_no_dense_inverse():
    """The structured regime factors into the BlockWoodbury and its kernel
    layout: nothing (n, n) in the factors; the sweep blocks take the layout,
    and the unstructured regime keeps its dense inverse."""
    A, _, t = _both("uc")
    m, n = A.shape
    rng = np.random.default_rng(3)
    S = 3
    x0 = rng.uniform(0, 1, (S, n))
    b = x0 @ A.T
    arrs = (rng.normal(size=(S, n)), np.zeros((S, n)), t, b - 1.0, b + 1.0,
            np.zeros((S, n)), np.full((S, n), 5.0))
    seen = []
    plain = cuda_kernels.fused_sweeps_sparse_plain

    def spy(*a, **k):
        seen.append(type(a[5]))
        return plain(*a, **k)

    cuda_kernels.fused_sweeps_sparse_plain = spy
    try:
        _, fac = tshared.solve_shared_factored(
            *arrs, settings=TSettings(max_iter=40, restarts=1),
            device="cpu")
    finally:
        cuda_kernels.fused_sweeps_sparse_plain = plain
    assert seen and set(seen) == {tsk.KernelWoodbury}
    assert isinstance(fac.Kinv_op, tsk.KernelWoodbury)
    assert fac.Kinv_op.bw is fac.Kinv and fac.K is None
    big = [f for f in fac if isinstance(f, torch.Tensor) and f.ndim == 2
           and f.shape == (n, n)]
    assert not big
    t.structure = None
    _, fac = tshared.solve_shared_factored(
        *arrs, settings=TSettings(max_iter=40, restarts=1), device="cpu")
    assert fac.Kinv_op is fac.Kinv and tuple(fac.Kinv.shape) == (n, n)


def test_structured_factors_need_the_matrix_to_seat():
    """Seating the reference's structured factors builds the kernel layout
    from the batch's SparseA, and refuses without it."""
    _, j, t = _both("uc")
    m, n = t.shape
    rng = np.random.default_rng(4)
    D, E = rng.random(n) + 0.5, rng.random(m) + 0.5
    js = j.scale(jnp.asarray(E), jnp.asarray(D))
    rho_a, d = rng.random(m) + 0.5, rng.random(n) + 0.5
    jbw = jsk.factor_structured(js, j.structure, jnp.asarray(d),
                                jnp.asarray(rho_a), 1e-6)
    arrays = dict(D=D, E=E, cost=np.float64(1.0), rho_a=rho_a, rho_x=d,
                  gamma=np.ones(2), q2ref=np.zeros(n), Kinv=jbw, K=None)
    with pytest.raises(ValueError, match="SparseA"):
        convert.shared_factors_from_arrays(arrays, "cpu")
    fac = convert.shared_factors_from_arrays(arrays, "cpu", A=t)
    b = rng.normal(size=(2, n))
    _close(tsk.layout_apply(fac.Kinv_op, torch.as_tensor(b)),
           jsk.kinv_apply(jbw, jnp.asarray(b)), 1e-12, "seated layout")
