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
    # (28*45 + 2*44*45 + 10*44 + 8*28) * 8 B: just under the 48 KB default,
    # so the wrapper's opt-in to more dynamic shared memory is exercised by
    # any larger shape
    assert cuda_kernels.smem_bytes(28, 44, 8) == 47072
    # n=100 f64: 2 n^2 * 8 B alone is 160 KB -> fits; n=120 does not
    assert cuda_kernels.usable(10, 50, 100, torch.float64)
    assert not cuda_kernels.usable(10, 50, 120, torch.float64)
    assert cuda_kernels.usable(10, 50, 120, torch.float32)
    assert not cuda_kernels.usable(10, 5, 5, torch.float16)
    assert not cuda_kernels.usable(0, 5, 5, torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_cuda_kernel_matches_plain(dtype, tol):
    """The hand-written kernel against its plain version on the card, at
    the main-path shape, with A scaled so cond(K) stays below ~10 (f32
    tolerance for its rounding, f64 for summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    c, sigma = _case(1000, 28, 44, seed=3, a_scale=44 ** -0.5)
    args = _torch_args(c, "cuda", dtype)
    cuda_kernels.reset_counts()
    got = cuda_kernels.fused_sweeps(*args, 4, 2, sigma, 1.6)
    torch.cuda.synchronize()
    assert cuda_kernels.launches["fused_sweeps"] == 1
    want = cuda_kernels.fused_sweeps_plain(*args, 4, 2, sigma, 1.6)
    for g, w in zip(got, want):
        assert _max_rel(g.cpu().numpy(), w.cpu().numpy()) < tol
