"""The shared-memory layouts of the port's ``fused_sweeps`` and
``fused_sweeps_shared`` kernels (tpusppy_torch/solvers/cuda_kernels.py).

The kernels run only on the card; what decides their mode, their cluster
size, how the matrices are cut into slices and where each buffer lies is
Python that mirrors the CUDA launchers, and is checked here: every buffer
fits a block's shared memory, the column and row slices partition n and m,
the tiles cover S, the main paths' shapes take the modes pinned for them,
the shared kernel's choice of mode follows the clusters the card holds,
and the packed slices hold exactly the matrices' columns, made anew when
the matrices change.
"""

import numpy as np
import pytest
import torch

from tpusppy_torch.solvers import cuda_kernels

_GRID_M = (0, 1, 9, 50, 242, 2000, 20000)
_GRID_N = (1, 5, 44, 132, 300, 443, 1000)
_DTYPES = [torch.float32, torch.float64]


def _r16(nbytes):
    return -(-nbytes // 16) * 16


@pytest.mark.parametrize("dtype", _DTYPES)
def test_shared_layout_fits_and_partitions(dtype):
    isz = dtype.itemsize
    resident = 0
    for m in _GRID_M:
        for n in _GRID_N:
            lay = cuda_kernels.shared_layout(m, n, isz)
            assert lay is not None, (m, n)
            assert lay["smem"] <= cuda_kernels.SMEM_LIMIT, (m, n)
            # the streamed mode takes every shape of the grid, in a tile as
            # large as the resident mode's where both take it
            streamed = cuda_kernels.shared_layout(m, n, isz, "streamed")
            assert streamed["mode"] == "streamed"
            assert streamed["smem"] <= cuda_kernels.SMEM_LIMIT
            assert lay["mode"] == "streamed" or streamed["sb"] == lay["sb"]
            assert cuda_kernels.shared_layout(m, n, isz, "resident") == (
                lay if lay["mode"] == "resident" else None)
            for S in (1, 7, 1000):
                sb = cuda_kernels.usable_shared(S, m, n, dtype)
                assert sb == lay["sb"]
                tiles = -(-S // sb)
                assert (tiles - 1) * sb < S <= tiles * sb
            if lay["mode"] != "resident":
                assert lay["mode"] == "streamed"
                continue
            resident += 1
            C, ld, km, kn = lay["C"], lay["ld"], lay["km"], lay["kn"]
            unit = 16 if isz == 8 else 2
            assert 1 <= C <= cuda_kernels.MAX_CLUSTER
            assert ld % unit == 0 and km >= m and kn >= n
            if isz == 8:
                assert km % 16 == 0 and kn % 16 == 0
            # the column slices partition n, in whole units, none wider than
            # ld; the row slices partition m
            cols, rows = lay["cols"], lay["rows"]
            assert len(cols) == len(rows) == C
            assert cols[0][0] == 0 and cols[-1][1] == n
            assert rows[0][0] == 0 and rows[-1][1] == m
            for (a0, a1), (b0, b1) in zip(cols, cols[1:]):
                assert a1 == b0
            for (a0, a1), (b0, b1) in zip(rows, rows[1:]):
                assert a1 == b0
            for j0, j1 in cols:
                assert j0 % unit == 0 and 0 <= j1 - j0 <= ld
            for i0, i1 in rows:
                assert 0 <= i1 - i0 <= -(-m // C)
            # the buffers lie in order, 16-byte aligned, the matrices' region
            # the size of a rank's packed slices
            off = lay["offsets"]
            names = ("bar", "gam", "mats", "v", "w", "xt", "rhs", "part",
                     "cols", "rows", "total")
            for a, b in zip(names, names[1:]):
                assert off[a] % 16 == 0 and off[a] <= off[b]
            assert off["total"] == lay["smem"]
            assert off["v"] - off["mats"] == _r16((km + 2 * kn) * ld * isz)
            assert lay["reg"] * isz == off["v"] - off["mats"]
    assert resident >= 10


@pytest.mark.parametrize("dtype", _DTYPES)
def test_dense_layout_fits(dtype):
    isz = dtype.itemsize
    modes = set()
    for m in _GRID_M:
        for n in _GRID_N:
            lay = cuda_kernels.dense_layout(m, n, isz)
            modes.add(lay["mode"])
            assert lay["smem"] <= cuda_kernels.SMEM_LIMIT, (m, n)
            if lay["mode"] == "resident":
                # two buffers of the scenario's 16 arrays, each slot 16
                # bytes past its rounded size, beside the work vectors
                lens = [m * n, n * n, n * n] + [n] * 7 + [m] * 6
                assert lay["slots"] == [_r16(L * isz) + 16 for L in lens]
                assert lay["buf"] == 16 + 4 * 16 + 3 * _r16(n * isz) \
                    + _r16(m * isz)
                assert lay["smem"] == lay["buf"] + 2 * lay["buffer"]
                continue
            assert lay["mode"] == "streamed"
            work = 4 * _r16(n * isz) + _r16(m * isz)
            assert lay["vec_smem"] == (lay["work"] + work
                                       <= cuda_kernels.SMEM_LIMIT)
            assert lay["scratch"] * isz == (0 if lay["vec_smem"] else work)
    assert modes == {"resident", "streamed"}


#: Clusters of the resident mode an H100 SXM holds at once at uc_lite's
#: shape (``cudaOccupancyMaxActiveClusters`` on the card): of 2 CTAs in
#: f32, of 5 in f64.
_H100_CLUSTERS = {4: 66, 8: 22}


def test_main_paths_take_the_resident_modes():
    """uc_lite's defaults (m=242, n=132) have a cluster-resident layout,
    with 2 CTAs in f32 and 5 in f64 (slices of whole 16-column units: 9
    units over 4 CTAs leave one 48 wide, past shared memory); on an H100
    the main path's S=1000 (125 tiles) outnumbers the clusters the card
    holds at once and takes the streamed mode, and S=128 the resident
    mode.  Farmer at crops_multiplier=4 (m=28, n=44) takes the dense
    resident mode, and at crops_multiplier=12 (m=84, n=132) in f64 the
    streamed mode."""
    for isz, C in ((4, 2), (8, 5)):
        lay = cuda_kernels.shared_layout(242, 132, isz)
        assert (lay["mode"], lay["C"], lay["sb"]) == ("resident", C, 8)
        clusters = _H100_CLUSTERS[isz]
        assert cuda_kernels.shared_mode(1000, 242, 132, isz, clusters) \
            == "streamed"
        assert cuda_kernels.shared_mode(128, 242, 132, isz, clusters) \
            == "resident"
    for isz in (4, 8):
        assert cuda_kernels.dense_layout(28, 44, isz)["mode"] == "resident"
    assert cuda_kernels.dense_layout(84, 132, 8)["mode"] == "streamed"
    # a wide shared A: the streamed mode
    assert cuda_kernels.shared_layout(242, 2000, 8)["mode"] == "streamed"


@pytest.mark.parametrize("dtype", _DTYPES)
def test_shared_pack_holds_the_slices(dtype):
    """Rank r's packed row holds columns cols[r] of A (km rows), K^-1 and
    K (kn rows each), each (rows, ld) row-major, and zeros elsewhere; the
    operand the engine hands the wrapper is that packing in the resident
    mode and A' in the streamed mode."""
    rng = np.random.RandomState(0)
    m, n = 242, 132
    A = torch.as_tensor(rng.randn(m, n), dtype=dtype)
    Ki = torch.as_tensor(rng.randn(n, n), dtype=dtype)
    K = torch.as_tensor(rng.randn(n, n), dtype=dtype)
    lay = cuda_kernels.shared_layout(m, n, dtype.itemsize)
    packed = cuda_kernels.shared_operand(A, Ki, K, lay)
    assert packed.shape == (lay["C"], lay["reg"]) and packed.dtype == dtype
    ld, km, kn = lay["ld"], lay["km"], lay["kn"]
    used = (km + 2 * kn) * ld
    for r, (j0, j1) in enumerate(lay["cols"]):
        blk = packed[r, :used].view(km + 2 * kn, ld)
        want = torch.zeros_like(blk)
        want[:m, :j1 - j0] = A[:, j0:j1]
        want[km:km + n, :j1 - j0] = Ki[:, j0:j1]
        want[km + kn:km + kn + n, :j1 - j0] = K[:, j0:j1]
        assert torch.equal(blk, want)
        assert not packed[r, used:].any()
    wide = torch.as_tensor(rng.randn(20, 2000), dtype=dtype)
    lay = cuda_kernels.shared_layout(20, 2000, dtype.itemsize)
    assert lay["mode"] == "streamed"
    op = cuda_kernels.shared_operand(wide, Ki, K, lay)
    assert torch.equal(op, wide.T) and op.is_contiguous()


@pytest.mark.parametrize("dtype", _DTYPES)
def test_shared_mode_follows_the_clusters(dtype):
    """The resident mode runs exactly where its layout fits one CTA, or
    every tile of 8 scenarios has a cluster at once, or the streamed mode
    does not take the shape; elsewhere the streamed mode, and None where
    neither takes the shape."""
    isz = dtype.itemsize
    both = spread = 0
    for m in _GRID_M:
        for n in _GRID_N + (12000,):
            res = cuda_kernels.shared_layout(m, n, isz, "resident")
            streamed = cuda_kernels.shared_layout(m, n, isz, "streamed")
            for S in (1, 8, 9, 128, 176, 177, 528, 529, 1000):
                for clusters in (1, 22, 66):
                    mode = cuda_kernels.shared_mode(S, m, n, isz, clusters)
                    if res is not None and (streamed is None
                                            or res["C"] == 1
                                            or -(-S // 8) <= clusters):
                        assert mode == "resident", (m, n, S, clusters)
                    else:
                        assert mode == (None if streamed is None
                                        else "streamed")
            both += res is not None and streamed is not None
            spread += res is not None and res["C"] > 1
    assert both >= 10 and spread >= 3
    # matrices that fit one CTA: the resident mode, at any S
    assert cuda_kernels.shared_layout(50, 22, isz)["C"] == 1
    assert cuda_kernels.shared_mode(10 ** 6, 50, 22, isz, 0) == "resident"
    # uc_lite's shape: the crossover lies at one tile a cluster
    assert cuda_kernels.shared_mode(8 * 66, 242, 132, isz, 66) == "resident"
    assert cuda_kernels.shared_mode(8 * 66 + 1, 242, 132, isz, 66) \
        == "streamed"
    assert cuda_kernels.shared_layout(5, 12000, 8) is None
    assert cuda_kernels.shared_mode(1, 5, 12000, 8, 66) is None


def test_shared_operand_is_made_anew_when_the_matrices_change():
    """The wrapper's operand is made once for the same A, K^-1 and K in the
    same mode, and anew for a new tensor, an in-place write to any of the
    three (a refactorization at a new rho that reuses the storage) or the
    other mode."""
    rng = np.random.RandomState(2)
    m, n = 242, 132
    A, Ki, K = (torch.as_tensor(rng.randn(*shape)) for shape in
                ((m, n), (n, n), (n, n)))
    res = cuda_kernels.shared_layout(m, n, 8, "resident")
    streamed = cuda_kernels.shared_layout(m, n, 8, "streamed")
    op = cuda_kernels.shared_operand(A, Ki, K, res)
    assert cuda_kernels.shared_operand(A, Ki, K, res) is op
    Ki.mul_(2.0)
    op2 = cuda_kernels.shared_operand(A, Ki, K, res)
    assert op2 is not op
    assert torch.equal(op2, cuda_kernels.shared_pack(A, Ki, K, res))
    K[0, 0] = 7.0
    op3 = cuda_kernels.shared_operand(A, Ki, K, res)
    assert op3 is not op2 and bool((op3 == 7.0).any())
    K2 = K.clone()
    assert cuda_kernels.shared_operand(A, Ki, K2, res) is not op3
    At = cuda_kernels.shared_operand(A, Ki, K2, streamed)
    assert torch.equal(At, A.T)
    A.add_(1.0)
    assert torch.equal(cuda_kernels.shared_operand(A, Ki, K2, streamed),
                       A.T)


def test_counts_by_mode_are_reset_and_untouched_on_cpu():
    """The launch counts by mode cover both kernels' modes, reset with the
    others, and a wrapper on CPU tensors (the plain version) adds to none
    of them."""
    assert set(cuda_kernels.shared_modes) == {"resident", "streamed"}
    assert set(cuda_kernels.dense_modes) == {"resident", "streamed"}
    cuda_kernels.shared_modes["resident"] = 3
    cuda_kernels.dense_modes["streamed"] = 2
    cuda_kernels.reset_counts()
    assert not any(cuda_kernels.shared_modes.values())
    assert not any(cuda_kernels.dense_modes.values())
    rng = np.random.RandomState(1)
    S, m, n = 3, 4, 5
    t = lambda *shape: torch.as_tensor(rng.rand(*shape))
    A = t(S, m, n)
    K = torch.eye(n).expand(S, n, n).double().contiguous()
    cuda_kernels.fused_sweeps(t(S, n), A, K, K, -t(S, m), t(S, m), -t(S, n),
                              t(S, n), t(S, m) + 0.5, t(S, n) + 0.5,
                              t(S, n), t(S, m), t(S, n), t(S, m), t(S, n),
                              t(S, m), 2, 1, 1e-6, 1.6)
    K1 = torch.eye(n, dtype=torch.float64)
    cuda_kernels.fused_sweeps_shared(
        t(S, n), t(m, n), K1, K1, -t(S, m), t(S, m), -t(S, n), t(S, n),
        t(1, m) + 0.5, t(1, n) + 0.5, t(S, n), torch.ones(1, 1,
                                                          dtype=torch.float64),
        t(S, 1) + 0.5, t(S, n), t(S, m), t(S, n), t(S, m), t(S, n), t(S, m),
        2, 1, 1, 1e-6, 1.6)
    assert cuda_kernels.plain_calls["fused_sweeps"] == 1
    assert cuda_kernels.plain_calls["fused_sweeps_shared"] == 1
    assert not any(cuda_kernels.shared_modes.values())
    assert not any(cuda_kernels.dense_modes.values())
