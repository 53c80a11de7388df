"""The port's fused_sweeps kernel module against the reference's Pallas kernel.

``fused_sweeps_plain`` (tpusppy_torch/solvers/cuda_kernels.py) is the CPU
path and the oracle the CUDA kernel is held against on the card; here it is
held against ``tpusppy.solvers.pallas_kernels.fused_sweeps`` run through the
Pallas interpreter, fed the transposed (scenarios-last) layout that kernel
takes.  Tolerance 1e-12 (relative to the largest entry): the recurrence is
the same and only the summation order of the matvecs differs.
"""

import numpy as np
import pytest
import torch

from tpusppy.solvers import pallas_kernels
from tpusppy_torch.solvers import cuda_kernels

torch.set_num_threads(1)

TOL_F64 = 1e-12


def _case(S, m, n, seed=7, a_scale=1.0):
    """Random sweep inputs with K = sigma I + A' diag(rho_a) A + diag(rho_x)
    as in admm._factor (the tests/test_pallas.py construction)."""
    rng = np.random.RandomState(seed)
    sigma = 1e-6
    A = rng.randn(S, m, n) * a_scale
    q = rng.randn(S, n)
    cl = -np.abs(rng.randn(S, m)) - 0.5
    cu = np.abs(rng.randn(S, m)) + 0.5
    lb = -np.ones((S, n)) * 2
    ub = np.ones((S, n)) * 2
    rho_a = np.full((S, m), 0.7)
    rho_x = np.full((S, n), 0.4)
    K = np.einsum("smn,sm,smk->snk", A, rho_a, A)
    K += sigma * np.eye(n)[None]
    K += np.einsum("sn,nk->snk", rho_x, np.eye(n))
    Kinv = np.linalg.inv(K)
    x = rng.randn(S, n) * 0.1
    z = np.clip(rng.randn(S, m), cl, cu)
    zx = np.clip(x, lb, ub)
    y = rng.randn(S, m) * 0.1
    yx = rng.randn(S, n) * 0.1
    Ax = np.einsum("smn,sn->sm", A, x)
    return dict(q=q, A=A, Kinv=Kinv, K=K, cl=cl, cu=cu, lb=lb, ub=ub,
                rho_a=rho_a, rho_x=rho_x, x=x, z=z, zx=zx, y=y, yx=yx,
                Ax=Ax), sigma


_ORDER = ("q", "A", "Kinv", "K", "cl", "cu", "lb", "ub", "rho_a", "rho_x",
          "x", "z", "zx", "y", "yx", "Ax")


def _pallas(c, n_sweeps, n_refine, sigma, alpha):
    import jax.numpy as jnp

    S = c["A"].shape[0]
    tT = lambda a: jnp.transpose(jnp.asarray(a), (1, 2, 0))
    vec = lambda k: jnp.asarray(c[k]).T
    outs = pallas_kernels.fused_sweeps(
        vec("q"), tT(c["A"]), jnp.transpose(jnp.asarray(c["A"]), (2, 1, 0)),
        tT(c["Kinv"]), tT(c["K"]), vec("cl"), vec("cu"), vec("lb"),
        vec("ub"), vec("rho_a"), vec("rho_x"), vec("x"), vec("z"),
        vec("zx"), vec("y"), vec("yx"), vec("Ax"), n_sweeps=n_sweeps,
        n_refine=n_refine, sigma=sigma, alpha=alpha, bs=S, interpret=True)
    return [np.asarray(o).T for o in outs]


def _max_err(a, b):
    """Largest difference relative to the largest entry of ``b``, or
    absolute where ``b`` is below 1 (a dual at roundoff level, say)."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1.0))


def _torch_args(c, device="cpu", dtype=torch.float64):
    return [torch.as_tensor(c[k], dtype=dtype, device=device)
            for k in _ORDER]


def _max_rel(a, b):
    a, b = np.asarray(a, float), np.asarray(b, float)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


@pytest.mark.parametrize("S,m,n,n_sweeps,n_refine", [
    (6, 9, 5, 5, 2),       # tests/test_pallas.py's shape
    (8, 28, 44, 4, 2),     # farmer crops_multiplier=4 (the main path)
])
def test_plain_matches_pallas_interpret(S, m, n, n_sweeps, n_refine):
    c, sigma = _case(S, m, n)
    alpha = 1.6
    ref = _pallas(c, n_sweeps, n_refine, sigma, alpha)
    got = cuda_kernels.fused_sweeps_plain(
        *_torch_args(c), n_sweeps, n_refine, sigma, alpha)
    for name, g, r in zip(("x", "z", "zx", "y", "yx", "Ax"), got, ref):
        assert g.shape == r.shape
        assert _max_rel(g.numpy(), r) < TOL_F64, name


def test_wrapper_on_cpu_runs_plain_and_launches_nothing():
    c, sigma = _case(4, 6, 5)
    cuda_kernels.reset_counts()
    got = cuda_kernels.fused_sweeps(*_torch_args(c), 3, 1, sigma, 1.6)
    want = cuda_kernels.fused_sweeps_plain(*_torch_args(c), 3, 1, sigma, 1.6)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert cuda_kernels.launches["fused_sweeps"] == 0
    assert cuda_kernels.plain_calls["fused_sweeps"] == 2


def test_usable_gate_sized_to_shared_memory():
    # farmer-1000 crops_multiplier=4 fits in f32 and f64
    assert cuda_kernels.usable(1000, 28, 44, torch.float32)
    assert cuda_kernels.usable(1000, 28, 44, torch.float64)
    # farmer's shape takes the resident mode: two buffers of a scenario's
    # 16 arrays (each in a slot 16 bytes past its rounded size) beside the
    # work vectors fit, 91,152 B in f64, 45,872 in f32
    assert cuda_kernels.dense_layout(28, 44, 8)["mode"] == "resident"
    assert cuda_kernels.dense_layout(28, 44, 8)["smem"] == 91152
    assert cuda_kernels.dense_layout(28, 44, 4)["smem"] == 45872
    # n=100 and n=120 f64: the scenario no longer fits two buffers, and the
    # streamed mode takes it (n=120 raised before the streamed mode)
    assert cuda_kernels.usable(10, 50, 100, torch.float64)
    assert cuda_kernels.usable(10, 50, 120, torch.float64)
    assert cuda_kernels.dense_layout(50, 120, 8)["mode"] == "streamed"
    assert cuda_kernels.usable(10, 50, 120, torch.float32)
    assert not cuda_kernels.usable(10, 5, 5, torch.float16)
    assert not cuda_kernels.usable(0, 5, 5, torch.float32)


def test_usable_takes_every_tpu_shape():
    """Every (S, m, n) the TPU kernel takes, and every shape the reference
    sends to its XLA sweep instead, ``fused_sweeps`` takes in f32 and f64
    (on the grid of ``test_usable_shared_takes_every_tpu_shape``); the
    mode follows from whether two of a scenario fit shared memory."""
    taken = 0
    for n in (1, 5, 44, 132, 300, 443):
        for m in (0, 1, 9, 242, 2000, 20000, 120000):
            for S in (1, 7, 1000):
                taken += pallas_kernels.usable(S, m, n,
                                               platform="tpu") is not None
                for dt in (torch.float32, torch.float64):
                    assert cuda_kernels.usable(S, m, n, dt), (S, m, n, dt)
                    lay = cuda_kernels.dense_layout(m, n, dt.itemsize)
                    assert lay["smem"] <= cuda_kernels.SMEM_LIMIT
                    assert lay["mode"] == ("resident" if 2 * lay.get(
                        "buffer", 1 << 40) + lay.get("buf", 0)
                        <= cuda_kernels.SMEM_LIMIT else "streamed")
    assert taken > 40
    assert cuda_kernels.dense_layout(84, 132, 8)["mode"] == "streamed"


@pytest.mark.cuda
@pytest.mark.parametrize("S,m,n,mode", [
    (1000, 28, 44, "resident"),    # farmer crops_multiplier=4: main path
    (37, 84, 132, "streamed"),     # farmer crops_multiplier=12 (raised
                                   # before the streamed mode in f64)
    (3, 0, 7, "resident"),         # no constraint rows
    (5000, 3, 7, "resident"),      # more scenarios than one wave of
                                   # blocks holds: two buffers a block
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_cuda_kernel_matches_plain(dtype, tol, S, m, n, mode):
    """The hand-written kernel against its plain version on the card, in
    the mode each shape is pinned to, with A scaled so cond(K) stays below
    ~10 (f32 tolerance for its rounding, f64 for summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    assert cuda_kernels.dense_layout(m, n, dtype.itemsize)["mode"] == mode
    c, sigma = _case(S, m, n, seed=3, a_scale=n ** -0.5)
    args = _torch_args(c, "cuda", dtype)
    cuda_kernels.reset_counts()
    got = cuda_kernels.fused_sweeps(*args, 4, 2, sigma, 1.6)
    torch.cuda.synchronize()
    assert cuda_kernels.launches["fused_sweeps"] == 1
    assert cuda_kernels.dense_modes[mode] == 1
    want = cuda_kernels.fused_sweeps_plain(*args, 4, 2, sigma, 1.6)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        if g.numel():
            assert _max_rel(g.cpu().numpy(), w.cpu().numpy()) < tol


# ---- fused_sweeps_shared ---------------------------------------------------

_SHARED_ORDER = ("q", "A", "Kinv", "K", "cl", "cu", "lb", "ub", "rho_a",
                 "rho_x", "dq2", "has", "gamma", "x", "z", "zx", "y", "yx",
                 "Ax")


def _shared_case(S, m, n, has, seed=3, a_scale=1.0, contract=None):
    """Random shared-A sweep inputs as tests/test_pallas.py builds them: one
    A, K = A' diag(rho_a) A + sigma I + diag(rho_x), gamma in [0.5, 1.5]
    and dq2 ~ 0.1 |N(0, 1)| (zero when ``has`` is unset).

    ``contract``: draw dq2 instead uniform in [0, contract * gamma * lo],
    where lo = min(rho_x) + sigma bounds K's eigenvalues from below, so
    each refinement pass shrinks the solve's error at least by that factor.
    Without it, a wide n (K near rho_x I) lets dq2 pass gamma K, and the
    passes then expand the error."""
    rng = np.random.RandomState(seed)
    sigma = 1e-6
    A = rng.randn(m, n) * a_scale
    q = rng.randn(S, n)
    cl = -np.abs(rng.randn(S, m)) - 0.5
    cu = np.abs(rng.randn(S, m)) + 0.5
    lb = -np.ones((S, n)) * 2
    ub = np.ones((S, n)) * 2
    rho_a = np.full((1, m), 0.7)
    rho_x = np.full((1, n), 0.4)
    K = (A.T * rho_a) @ A + sigma * np.eye(n) + np.diag(rho_x[0])
    Kinv = np.linalg.inv(K)
    gamma = 0.5 + rng.rand(S, 1)
    if contract is None:
        dq2 = 0.1 * np.abs(rng.randn(S, n)) * has
    else:
        lo = rho_x.min() + sigma
        dq2 = contract * gamma * lo * rng.rand(S, n) * has
    x = rng.randn(S, n) * 0.1
    z = np.clip(rng.randn(S, m), cl, cu)
    zx = np.clip(x, lb, ub)
    y = rng.randn(S, m) * 0.1
    yx = rng.randn(S, n) * 0.1
    return dict(q=q, A=A, Kinv=Kinv, K=K, cl=cl, cu=cu, lb=lb, ub=ub,
                rho_a=rho_a, rho_x=rho_x, dq2=dq2,
                has=np.full((1, 1), float(has)), gamma=gamma, x=x, z=z,
                zx=zx, y=y, yx=yx, Ax=x @ A.T), sigma


def _shared_args(c, device="cpu", dtype=torch.float64):
    return [torch.as_tensor(c[k], dtype=dtype, device=device)
            for k in _SHARED_ORDER]


@pytest.mark.parametrize("has", [1, 0])
@pytest.mark.parametrize("S,m,n", [
    (16, 9, 5),            # tests/test_pallas.py's shape
    (8, 50, 22),           # uc_lite 3 generators, 4 hours
])
def test_shared_plain_matches_pallas_interpret(S, m, n, has):
    """The port's twin of tests/test_pallas.py::
    test_fused_sweeps_shared_matches_xla at "highest", with the extra
    refinement passes armed (has=1) and not (has=0)."""
    c, sigma = _shared_case(S, m, n, has)
    n_sweeps, n_refine, n_extra, alpha = 3, 2, 2, 1.6
    ref = pallas_kernels.fused_sweeps_shared(
        *(c[k] for k in _SHARED_ORDER), n_sweeps=n_sweeps,
        n_refine=n_refine, n_extra=n_extra, sigma=sigma, alpha=alpha, bs=8,
        precision="highest", interpret=True)
    got = cuda_kernels.fused_sweeps_shared_plain(
        *_shared_args(c), n_sweeps, n_refine, n_extra, sigma, alpha)
    for name, g, r in zip(("x", "z", "zx", "y", "yx", "Ax"), got, ref):
        assert g.shape == r.shape
        assert _max_err(g.numpy(), r) < TOL_F64, name


def test_shared_wrapper_on_cpu_runs_plain_and_launches_nothing():
    c, sigma = _shared_case(5, 7, 4, 1)
    cuda_kernels.reset_counts()
    got = cuda_kernels.fused_sweeps_shared(*_shared_args(c), 2, 2, 2, sigma,
                                           1.6)
    want = cuda_kernels.fused_sweeps_shared_plain(*_shared_args(c), 2, 2, 2,
                                                  sigma, 1.6)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert cuda_kernels.launches == {"fused_sweeps": 0,
                                     "fused_sweeps_shared": 0,
                                     "fused_sweeps_sparse": 0}
    assert cuda_kernels.plain_calls["fused_sweeps_shared"] == 2


@pytest.mark.parametrize("precision", ["high", "default", "bf16"])
def test_shared_wrapper_refuses_lowered_precision(precision):
    """The lowered modes are ported: on CPU tensors the wrapper at "high"
    or "default" runs the plain version at that mode (bitwise the same
    result, and not the exact one); a mode the reference does not have
    ("bf16") is still refused by both."""
    c, sigma = _shared_case(4, 6, 5, 1)
    if precision == "bf16":
        for fn in (cuda_kernels.fused_sweeps_shared,
                   cuda_kernels.fused_sweeps_shared_plain):
            with pytest.raises(ValueError, match="must be one of"):
                fn(*_shared_args(c), 2, 2, 2, sigma, 1.6,
                   precision=precision)
        return
    got = cuda_kernels.fused_sweeps_shared(*_shared_args(c), 2, 2, 2, sigma,
                                           1.6, precision=precision)
    want = cuda_kernels.fused_sweeps_shared_plain(
        *_shared_args(c), 2, 2, 2, sigma, 1.6, precision=precision)
    exact = cuda_kernels.fused_sweeps_shared_plain(*_shared_args(c), 2, 2, 2,
                                                   sigma, 1.6)
    for g, w, e in zip(got, want, exact):
        assert torch.equal(g, w)
    assert max(float((g - e).abs().max()) for g, e in zip(got, exact)) > 0


def test_usable_shared_takes_every_tpu_shape():
    """Every (S, m, n) the TPU kernel takes (its 1.5 MB matrix budget, a
    scenario block of at least 8 or all of S), the Hopper kernel takes in
    f32 and f64, streaming the matrices; the main path's shape too."""
    taken = 0
    for n in (1, 5, 44, 132, 300, 443):
        for m in (0, 1, 9, 242, 2000, 20000, 120000):
            for S in (1, 7, 1000):
                if pallas_kernels.usable_shared(S, m, n,
                                                platform="tpu") is None:
                    continue
                taken += 1
                for dt in (torch.float32, torch.float64):
                    assert cuda_kernels.usable_shared(S, m, n, dt), \
                        (S, m, n, dt)
    assert taken > 40
    # uc_lite's defaults: the cluster-resident mode, tiles of 8 scenarios;
    # f32: 2 CTAs of 66 columns (A, K^-1 and K: 133,584 B each, beside the
    # eight warps' partial sums of a column product); f64: the
    # slices are whole 16-column units (9 for n=132) and 4 CTAs would take
    # 48 columns each, past shared memory, so 5 CTAs of at most 32
    assert cuda_kernels.usable_shared(1000, 242, 132, torch.float32) == 8
    lay = cuda_kernels.shared_layout(242, 132, 4)
    assert (lay["mode"], lay["C"], lay["sb"], lay["ld"]) == \
        ("resident", 2, 8, 66)
    assert lay["cols"] == [(0, 66), (66, 132)]
    assert lay["rows"] == [(0, 121), (121, 242)]
    assert lay["smem"] == 212768
    lay = cuda_kernels.shared_layout(242, 132, 8)
    assert (lay["mode"], lay["C"], lay["ld"], lay["km"], lay["kn"]) == \
        ("resident", 5, 32, 256, 144)
    assert lay["smem"] == 224656
    # the streamed mode's buffers at that shape, as it would take them:
    # K^-1 and K in shared memory in f32, K^-1 alone in f64
    assert cuda_kernels.shared_smem_bytes(242, 132, 4, 8, 242) == (176224, 3)
    assert cuda_kernels.shared_smem_bytes(242, 132, 8, 8, 242) == (213056, 1)
    # wide n lowers the streamed tile and streams the matrices; huge m is
    # chunked
    assert cuda_kernels.shared_layout(242, 2000, 8)["mode"] == "streamed"
    assert cuda_kernels.shared_layout(242, 2000, 8)["sb"] == 4
    assert cuda_kernels.shared_layout(60, 3000, 8)["sb"] == 2
    assert cuda_kernels.shared_smem_bytes(60, 3000, 8, 2, 60)[1] == 0
    lay = cuda_kernels.shared_layout(100000, 132, 8)
    assert (lay["mode"], lay["sb"], lay["chunk"]) == ("streamed", 8, 2723)
    assert (lay["smem"], lay["resident"]) == (cuda_kernels.SMEM_LIMIT, 0)
    assert cuda_kernels.usable_shared(10, 5, 12000, torch.float64) is None
    assert cuda_kernels.usable_shared(10, 5, 5, torch.float16) is None
    assert cuda_kernels.usable_shared(0, 5, 5, torch.float32) is None


_F32, _F64 = (torch.float32, 1e-5), (torch.float64, 1e-12)


def _refinement_factor(c):
    """An upper bound on how much one refinement pass scales the solve's
    error: max dq2 / (gamma * lo), lo = min(rho_x) + sigma <= eig(K)."""
    lo = float(c["rho_x"].min()) + 1e-6
    return float(np.max(c["dq2"] / (c["gamma"] * lo)))


def _shared_against_f64(c, sigma, n_sweeps=4, n_refine=2, n_extra=2,
                        mode=None):
    """The f32 kernel (in ``mode``, else the one it picks) and the f32 plain
    version, each against the f64 plain version on the same (f32-rounded)
    inputs: (kernel-plain, kernel-f64, plain-f64) errors, relative as in
    ``_max_err``."""
    args = _shared_args(c, "cuda", torch.float32)
    cuda_kernels.reset_counts()
    got = cuda_kernels.fused_sweeps_shared(*args, n_sweeps, n_refine,
                                           n_extra, sigma, 1.6, mode=mode)
    torch.cuda.synchronize()
    assert cuda_kernels.launches["fused_sweeps_shared"] == 1
    if mode is not None:
        assert cuda_kernels.shared_modes[mode] == 1
    want = cuda_kernels.fused_sweeps_shared_plain(*args, n_sweeps, n_refine,
                                                  n_extra, sigma, 1.6)
    ref = cuda_kernels.fused_sweeps_shared_plain(
        *(a.double() for a in args), n_sweeps, n_refine, n_extra, sigma,
        1.6)
    errs = []
    for g, w, r in zip(got, want, ref):
        assert torch.isfinite(g).all()
        g, w, r = (t.cpu().double().numpy() for t in (g, w, r))
        errs.append((_max_err(g, w), _max_err(g, r), _max_err(w, r)))
    return tuple(max(e[i] for e in errs) for i in range(3))


@pytest.mark.cuda
@pytest.mark.parametrize("S,m,n,dtype,tol", [
    (1000, 242, 132, *_F32),   # uc_lite defaults: the main path
    (1000, 242, 132, *_F64),
    (128, 242, 132, *_F32),    # a cluster for every tile
    (128, 242, 132, *_F64),
    (1003, 50, 22, *_F32),     # a ragged last tile
    (1003, 50, 22, *_F64),
    (37, 3000, 132, *_F64),    # A' in two chunks
    (5, 0, 7, *_F64),          # no constraint rows
    (20, 60, 3000, *_F32),     # a tile of 2 scenarios; 3000-term sums
    (20, 60, 3000, *_F64),
])
@pytest.mark.parametrize("has", [1, 0])
def test_cuda_shared_kernel_matches_plain(S, m, n, dtype, tol, has):
    """The hand-written shared kernel against its plain version on the card,
    in each mode that takes the shape, with A scaled by 1/sqrt(n), rho >=
    0.4 and dq2 at most half of gamma K's smallest eigenvalue, so K is well
    conditioned and the refinement contracts, as on the engine's path (f32
    tolerance for its rounding, f64 for summation order).  In f32 both are
    also held against the f64 plain version: the kernel lies no further
    from it than the plain f32 does, within a factor of 2.  Unforced, the
    wrapper runs the mode ``shared_mode`` picks for the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    c, sigma = _shared_case(S, m, n, has, a_scale=n ** -0.5, contract=0.5)
    isz = dtype.itemsize
    modes = [md for md in ("resident", "streamed")
             if cuda_kernels.shared_layout(m, n, isz, md) is not None]
    assert modes
    for mode in modes:
        if dtype == torch.float32:
            kp, kr, pr = _shared_against_f64(c, sigma, mode=mode)
            print(f"shared f32 [{mode}] S={S} m={m} n={n} has={has} "
                  f"refinement factor <= {_refinement_factor(c):.3f}: "
                  f"kernel-plain {kp:.3e}, kernel-f64 {kr:.3e}, plain-f64 "
                  f"{pr:.3e}")
            assert kp < tol
            assert kr <= 2.0 * pr + 1e-7
            continue
        args = _shared_args(c, "cuda", dtype)
        cuda_kernels.reset_counts()
        got = cuda_kernels.fused_sweeps_shared(*args, 4, 2, 2, sigma, 1.6,
                                               mode=mode)
        torch.cuda.synchronize()
        assert cuda_kernels.launches["fused_sweeps_shared"] == 1
        assert cuda_kernels.shared_modes[mode] == 1
        want = cuda_kernels.fused_sweeps_shared_plain(*args, 4, 2, 2, sigma,
                                                      1.6)
        for g, w in zip(got, want):
            assert torch.isfinite(g).all()
            if g.numel():
                assert _max_err(g.cpu().numpy(), w.cpu().numpy()) < tol
    args = _shared_args(c, "cuda", dtype)
    cuda_kernels.reset_counts()
    cuda_kernels.fused_sweeps_shared(*args, 4, 2, 2, sigma, 1.6)
    res = cuda_kernels.shared_layout(m, n, isz, "resident")
    picked = cuda_kernels.shared_mode(
        S, m, n, isz, cuda_kernels._shared_clusters(args[1].device, dtype,
                                                    m, n)
        if res is not None and res["C"] > 1 else 0)
    assert cuda_kernels.shared_modes[picked] == 1
    if (m, n) == (242, 132):
        # uc_lite's shape: the main path's S=1000 outnumbers the clusters
        # the card holds at once, S=128 does not
        assert picked == ("streamed" if S == 1000 else "resident")


@pytest.mark.cuda
def test_cuda_shared_kernel_f32_where_refinement_expands():
    """(S=20, m=60, n=3000) with tests/test_pallas.py's dq2 ~ 0.1 |N(0, 1)|:
    K is near rho_x I, so dq2 passes gamma K for some entries and each
    refinement pass expands the f32 rounding.  Kernel and plain f32 then
    part by more than 1e-5, but both lie as far from the f64 plain version:
    the kernel within a factor of 2 of the plain f32's distance."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    c, sigma = _shared_case(20, 60, 3000, 1, a_scale=3000 ** -0.5)
    factor = _refinement_factor(c)
    kp, kr, pr = _shared_against_f64(c, sigma)
    print(f"shared f32 S=20 m=60 n=3000 has=1 refinement factor <= "
          f"{factor:.3f}: kernel-plain {kp:.3e}, kernel-f64 {kr:.3e}, "
          f"plain-f64 {pr:.3e}")
    assert factor > 1.0
    assert kr <= 2.0 * pr


@pytest.mark.cuda
def test_cuda_wrappers_raise_on_shapes_they_do_not_take():
    """No engine declines the kernel quietly: a CUDA shape a kernel does not
    take raises, from its wrapper and from the engine that calls it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from tpusppy_torch.solvers import admm as tadmm
    from tpusppy_torch.solvers import shared_admm as tshared

    dev, f64 = "cuda", torch.float64
    S, m, n = 10, 5, 12000
    assert cuda_kernels.usable_shared(S, m, n, f64) is None

    def e(*shape):
        return torch.zeros(shape, dtype=f64, device=dev)

    with pytest.raises(ValueError, match="not taken by the kernel"):
        cuda_kernels.fused_sweeps_shared(
            e(S, n), e(m, n), e(1, 1), e(1, 1), e(S, m), e(S, m), e(S, n),
            e(S, n), e(1, m), e(1, n), e(S, n), e(1, 1), e(S, 1), e(S, n),
            e(S, m), e(S, n), e(S, m), e(S, n), e(S, m), 4, 2, 2, 1e-6, 1.6)
    rng = np.random.RandomState(0)
    A = rng.randn(m, n)
    x0 = rng.rand(S, n)
    Ax = x0 @ A.T
    with pytest.raises(ValueError, match="not taken by the kernel"):
        tshared.solve_shared(rng.randn(S, n), np.zeros((S, n)), A, Ax - 1,
                             Ax + 1, np.zeros((S, n)), np.ones((S, n)),
                             tadmm.ADMMSettings(max_iter=8, restarts=1),
                             device=dev)
    # fused_sweeps takes every shape in f32 and f64 (its streamed mode);
    # what it refuses is another dtype
    c, _ = _case(2, 50, 120)
    f16 = torch.float16
    assert not cuda_kernels.usable(2, 50, 120, f16)
    with pytest.raises(ValueError, match="not taken by the kernel"):
        cuda_kernels.fused_sweeps(*_torch_args(c, dev, f16), 4, 2, 1e-6, 1.6)


@pytest.mark.cuda
def test_cuda_dense_engine_takes_a_shape_that_raised_before():
    """(S=2, m=50, n=120) in f64, which the reference's engine solves and
    the port raised on before the streamed mode: the dense engine now
    solves it through the kernel's streamed mode, to the plain path's
    answer."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from tpusppy_torch.solvers import admm as tadmm

    rng = np.random.RandomState(0)
    A = rng.randn(2, 50, 120)
    x0 = rng.rand(2, 120)
    Ax = np.einsum("smn,sn->sm", A, x0)
    arrs = (rng.randn(2, 120), np.zeros((2, 120)), A, Ax - 1, Ax + 1,
            np.zeros((2, 120)), np.ones((2, 120)))
    res = {}
    for use_kernel in (True, False):
        cuda_kernels.reset_counts()
        res[use_kernel] = tadmm.solve_batch(
            *arrs, tadmm.ADMMSettings(max_iter=200, use_kernel=use_kernel),
            device="cuda")
        if use_kernel:
            assert cuda_kernels.dense_modes["streamed"] > 0
            assert cuda_kernels.plain_calls["fused_sweeps"] == 0
    xk, xp = (res[k].x.cpu().numpy() for k in (True, False))
    assert np.isfinite(xk).all()
    assert _max_err(xk, xp) < 1e-9


@pytest.mark.parametrize("engine", ["dense", "shared"])
def test_engines_send_every_shape_to_the_wrapper(engine, monkeypatch):
    """The sweep blocks go to the kernel's wrapper whatever the shape (on the
    card the wrapper launches or raises); only ``use_kernel=False`` calls
    the plain version directly.  Here the shape gates refuse every shape
    and the wrapper's calls are counted."""
    from tpusppy_torch.solvers import admm as tadmm
    from tpusppy_torch.solvers import shared_admm as tshared

    monkeypatch.setattr(cuda_kernels, "usable", lambda *a: False)
    monkeypatch.setattr(cuda_kernels, "usable_shared", lambda *a: None)
    name = "fused_sweeps" if engine == "dense" else "fused_sweeps_shared"
    wrapper = getattr(cuda_kernels, name)
    calls = []

    def counted(*a, **k):
        calls.append(1)
        return wrapper(*a, **k)

    monkeypatch.setattr(cuda_kernels, name, counted)
    rng = np.random.RandomState(1)
    S, m, n = 3, 4, 6
    A = rng.randn(m, n)
    x0 = rng.rand(S, n)
    Ax = x0 @ A.T
    if engine == "dense":
        A, solve = np.broadcast_to(A, (S, m, n)).copy(), tadmm.solve_batch
    else:
        solve = tshared.solve_shared
    arrs = (rng.randn(S, n), np.zeros((S, n)), A, Ax - 1, Ax + 1,
            np.zeros((S, n)), np.ones((S, n)))
    for use_kernel in (True, False):
        calls.clear()
        cuda_kernels.reset_counts()
        solve(*arrs, tadmm.ADMMSettings(max_iter=16, restarts=1,
                                        use_kernel=use_kernel),
              device="cpu")
        assert bool(calls) == use_kernel
        assert cuda_kernels.plain_calls[name] > 0
        assert cuda_kernels.launches[name] == 0


# ---- fused_sweeps_sparse ---------------------------------------------------

_SPARSE_ORDER = ("q", "rowcols", "rowvals", "colrows", "colvals", "Kinv",
                 "diagK", "cl", "cu", "lb", "ub", "rho_a", "rho_x", "dq2",
                 "has", "gamma", "x", "z", "zx", "y", "yx", "Ax")


def _sparse_card_case(S, num_gens, horizon, has, seed=5):
    """fused_sweeps_sparse inputs on the uc model's sparsity pattern, with
    values of magnitude [0.5, 1] / sqrt(kr kc) (A'RA of norm at most 1),
    rho in [0.5, 1] (cond(K) below 4) and dq2 at most half of gamma K's
    smallest eigenvalue, so the refinement contracts (as chip_smoke.py's
    case)."""
    from tpusppy_torch.models import uc
    from tpusppy_torch.solvers.sparse import SparseA

    pattern = uc.scenario_creator("Scenario0", num_gens=num_gens,
                                  horizon=horizon,
                                  relax_integers=True).A != 0
    rng = np.random.RandomState(seed)
    m, n = pattern.shape
    kr, kc = int(pattern.sum(1).max()), int(pattern.sum(0).max())
    sigma = 1e-6
    A = np.where(pattern, rng.uniform(0.5, 1.0, (m, n))
                 * rng.choice([-1.0, 1.0], (m, n)), 0.0) / np.sqrt(kr * kc)
    sp = SparseA.from_dense(A, torch.float64, "cpu")
    rho_a = rng.uniform(0.5, 1.0, size=m)
    rho_x = rng.uniform(0.5, 1.0, size=n)
    K = (A.T * rho_a) @ A + np.diag(rho_x + sigma)
    cl = -np.abs(rng.randn(S, m)) - 0.5
    cu = np.abs(rng.randn(S, m)) + 0.5
    x = rng.randn(S, n) * 0.1
    gamma = rng.uniform(0.6, 1.8, size=(S, 1))
    c = dict(q=rng.randn(S, n), rowcols=sp.ell.rowcols.numpy(),
             rowvals=sp.ell.rowvals.numpy(), colrows=sp.ell.colrows.numpy(),
             colvals=sp.ell.colvals.numpy(), Kinv=np.linalg.inv(K),
             diagK=(rho_x + sigma)[None, :], cl=cl, cu=cu,
             lb=-2.0 * np.ones((S, n)), ub=2.0 * np.ones((S, n)),
             rho_a=rho_a[None, :], rho_x=rho_x[None, :],
             dq2=0.5 * gamma * (rho_x.min() + sigma)
             * rng.uniform(size=(S, n)) * has,
             has=np.full((1, 1), float(has)), gamma=gamma, x=x,
             z=np.clip(rng.randn(S, m), cl, cu), zx=np.clip(x, -2.0, 2.0),
             y=0.1 * rng.randn(S, m), yx=0.1 * rng.randn(S, n), Ax=x @ A.T)
    return c, sigma


def _sparse_card_args(c, dtype):
    return [torch.as_tensor(c[k], device="cuda",
                            dtype=(torch.int32 if k in ("rowcols", "colrows")
                                   else dtype)) for k in _SPARSE_ORDER]


@pytest.mark.cuda
@pytest.mark.parametrize("S,num_gens,horizon", [
    (37, 10, 6),       # a ragged last tile; the structured uc pattern
    (64, 30, 24),      # the main path's full-width pattern (m=4626, n=2928)
])
@pytest.mark.parametrize("has", [1, 0])
def test_cuda_sparse_kernel_matches_plain(S, num_gens, horizon, has):
    """The hand-written sparse kernel against its plain version on the card:
    f64 to 1e-12 (summation order); in f32 both are held against the f64
    plain version on the same inputs, the kernel within a factor of 2 of
    the plain f32's distance, and kernel and plain agree to 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    c, sigma = _sparse_card_case(S, num_gens, horizon, has)
    fixed = (4, 1, 2, sigma, 1.6)
    args64 = _sparse_card_args(c, torch.float64)
    cuda_kernels.reset_counts()
    got = cuda_kernels.fused_sweeps_sparse(*args64, *fixed)
    torch.cuda.synchronize()
    assert cuda_kernels.launches["fused_sweeps_sparse"] == 1
    want = cuda_kernels.fused_sweeps_sparse_plain(*args64, *fixed)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _max_err(g.cpu().numpy(), w.cpu().numpy()) < TOL_F64
    args32 = _sparse_card_args(c, torch.float32)
    got = cuda_kernels.fused_sweeps_sparse(*args32, *fixed)
    want = cuda_kernels.fused_sweeps_sparse_plain(*args32, *fixed)
    ref = cuda_kernels.fused_sweeps_sparse_plain(
        *(a.double() if a.is_floating_point() else a for a in args32),
        *fixed)
    errs = []
    for g, w, r in zip(got, want, ref):
        assert torch.isfinite(g).all()
        g, w, r = (t.cpu().double().numpy() for t in (g, w, r))
        errs.append((_max_err(g, w), _max_err(g, r), _max_err(w, r)))
    kp, kr, pr = (max(e[i] for e in errs) for i in range(3))
    print(f"sparse f32 S={S} uc {num_gens}x{horizon} has={has}: "
          f"kernel-plain {kp:.3e}, kernel-f64 {kr:.3e}, plain-f64 {pr:.3e}")
    assert kp < 1e-4
    assert kr <= 2.0 * pr + 1e-7


@pytest.mark.cuda
def test_cuda_sparse_raises_on_a_shape_it_does_not_take():
    """n = 15000 in f64: one scenario's two n-vectors and the partial sums
    pass a block's shared memory.  The wrapper raises, and so does the
    engine that sends a SparseA of that width to it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from tpusppy_torch.solvers import shared_admm as tshared
    from tpusppy_torch.solvers.admm import ADMMSettings
    from tpusppy_torch.solvers.sparse import SparseA

    S, m, n, f64 = 2, 5, 15000, torch.float64
    assert cuda_kernels.usable_sparse(S, m, n, 1, 1, f64) is None
    A = np.zeros((m, n))
    A[np.arange(n) % m, np.arange(n)] = 1.0
    sp = SparseA.from_dense(A, f64, "cuda")
    e = lambda *shape: torch.zeros(shape, dtype=f64, device="cuda")
    kr, kc = sp.ell.rowcols.shape[1], sp.ell.colrows.shape[1]
    with pytest.raises(ValueError, match="not taken by the kernel"):
        cuda_kernels.fused_sweeps_sparse(
            e(S, n), sp.ell.rowcols, e(m, kr), sp.ell.colrows, e(n, kc),
            e(n, n), e(1, n), e(S, m), e(S, m), e(S, n), e(S, n), e(1, m),
            e(1, n), e(S, n), e(1, 1), e(S, 1), e(S, n), e(S, m), e(S, n),
            e(S, m), e(S, n), e(S, m), 4, 1, 2, 1e-6, 1.6)
    rng = np.random.RandomState(0)
    x0 = rng.rand(S, n)
    Ax = x0 @ A.T
    with pytest.raises(ValueError, match="not taken by the kernel"):
        tshared.solve_shared(rng.randn(S, n), np.zeros((S, n)), sp, Ax - 1,
                             Ax + 1, np.zeros((S, n)), np.ones((S, n)),
                             ADMMSettings(max_iter=8, restarts=1),
                             device="cuda")
