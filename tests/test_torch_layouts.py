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


#: The shapes the port's paths give ``fused_sweeps`` (S, m, n): farmer-1000's
#: main path, bundled farmer-1000's and bundled netdes-1000's buckets,
#: netdes-1000, sizes S=3, sslp 10 x 50 S=50, farmer at crops_multiplier
#: 12, a tall shape whose work vectors do not fit shared memory in f64, and
#: rows longer than a stage in f64 (chip_smoke.DENSE_SHAPES).
_DENSE_TABLE = ((1000, 28, 44), (200, 84, 108), (100, 112, 140),
                (200, 105, 100), (100, 140, 125), (1000, 35, 50),
                (3, 62, 150), (50, 60, 520), (64, 84, 132), (4, 60000, 44),
                (2, 10, 2500))


def _check_dense_layout(m, n, isz, lowered, lay):
    """One ``dense_layout``: within a block's shared memory, C a cluster
    size, the resident slots as the source lays them out; in the cluster
    modes the CTAs' row ranges cover every row of A, K^-1 and K exactly once,
    every buffer and stage starts 16-byte aligned, and every bulk copy's
    16-byte-aligned span (its source starting anywhere on an element) fits
    the slot or stage it lands in."""
    assert lay["smem"] <= cuda_kernels.SMEM_LIMIT, (m, n, isz, lowered)
    assert lay["C"] in (1, 2, 4, 8, 16)
    msz = 2 if lowered else isz
    if lay["mode"] == "resident":
        assert lay["C"] == 1 and lay["buffers"] in (1, 2)
        lens = [m * n, n * n, n * n] + [n] * 7 + [m] * 6
        sizes = [msz, msz] + [isz] * 14
        assert lay["slots"] == [_r16(L * sz) + 16
                                for L, sz in zip(lens, sizes)]
        assert lay["buf"] == 16 + 4 * 16 + 3 * _r16(n * isz) + _r16(m * isz)
        assert lay["smem"] == lay["buf"] + lay["buffers"] * lay["buffer"]
        two = lay["buf"] + 2 * lay["buffer"] <= cuda_kernels.SMEM_LIMIT
        assert lay["buffers"] == (2 if two else 1)
        return
    C, nk, mk = lay["C"], lay["nk"], lay["mk"]
    assert C > 1 and nk == -(-n // C) and mk == -(-m // C)
    for ranges, total, most in ((lay["rows"], m, mk), (lay["krows"], n, nk)):
        assert len(ranges) == C
        covered = []
        for a, b in ranges:
            assert 0 <= b - a <= most
            covered.extend(range(a, b))
        assert covered == list(range(total))
    off = lay["offsets"]
    order = ("bars", "vec", "own", "held", "stage", "total")
    for x, y in zip(order, order[1:]):
        assert off[x] % 16 == 0 and off[x] <= off[y]
    assert off["total"] == lay["smem"]
    assert off["vec"] >= 8 * (2 + 2 * lay["ns"]) + 32 * lay["ns"]
    hold = lay["hold"]
    assert len(hold) == 3 and all(s % 16 == 0 for s in off["slots"])
    assert off["stage"] == off["held"] + lay["buffers"] * sum(off["slots"])
    for h, rows, sz, slot in zip(hold, (mk, nk, nk), (msz, msz, isz),
                                 off["slots"]):
        assert 0 <= h <= rows
        assert slot == (_r16(h * n * sz) + 16 if h else 0)
        for start in range(0, 16, sz):
            assert not h or _r16(start + h * n * sz) <= slot
    if lay["vec_smem"]:
        assert off["held"] - off["own"] == 8 * _r16(nk * isz) \
            + 7 * _r16(mk * isz)
        # w, xt and the partial sums, and u in the mixed-precision mode
        assert off["own"] - off["vec"] == (4 if lowered else 3) \
            * _r16(n * isz)
        assert lay["scratch"] == 0
    else:
        assert off["held"] == off["vec"] and lay["scratch"] > 0
    if lay["mode"] == "cluster":
        assert hold == (mk, nk, nk) and lay["ns"] == 0 and lay["vec_smem"]
        return
    assert lay["mode"] == "streamed" and lay["buffers"] == 1
    # only A's streamed rows pass through the ring (K^-1's and K's are read
    # from device memory by the products): a ring of 3 to 6 stages where an
    # A row streams, none where every A row is held
    if hold[0] == mk:
        assert lay["ns"] == 0 and off["total"] == off["stage"]
        return
    assert 3 <= lay["ns"] <= 6
    # a stage's payload: whole rows of the working type (bf16 panels twice
    # as many), or, for longer rows, segments of _STAGE_BYTES that start on
    # a multiple of the block's 256 threads (each thread keeps its columns)
    sp, cap = lay["sp"], cuda_kernels._STAGE_BYTES
    if n * isz <= cap:
        assert sp % (n * isz) == 0 and cap - n * isz < sp <= cap
    else:
        assert sp == cap and (cap // isz) % 256 == 0 \
            and (cap // msz) % 256 == 0
    assert off["stage_bytes"] == _r16(sp) + 32
    assert off["total"] - off["stage"] == lay["ns"] * off["stage_bytes"]
    for sz in {msz, isz}:
        per = sp // sz
        elems = (per // n) * n if n <= per else per
        assert elems >= 1
        for start in range(0, 16, sz):
            assert _r16(start + elems * sz) <= off["stage_bytes"]


@pytest.mark.parametrize("lowered", [False, True])
@pytest.mark.parametrize("dtype", _DTYPES)
def test_dense_layout_fits(dtype, lowered):
    """Every shape of the grid and of the paths' table, with the largest
    cluster at 16 and at 8, and at the table's S on an H100's 132 SMs:
    the mode the picker gives fits and cuts the matrices as the source
    does; resident exactly where one scenario fits one block (unless too
    few scenarios for one buffer's blocks: a cluster), and all three modes
    occur."""
    isz = dtype.itemsize
    modes = set()
    shapes = [(None, m, n) for m in _GRID_M for n in _GRID_N] \
        + list(_DENSE_TABLE)
    for S, m, n in shapes:
        for mc in (16, 8):
            lay = cuda_kernels.dense_layout(m, n, isz, lowered, S, 132, mc)
            modes.add(lay["mode"])
            _check_dense_layout(m, n, isz, lowered, lay)
            assert lay["C"] <= mc
            res = cuda_kernels._dense_mode_layout(m, n, isz, lowered,
                                                  "resident")
            few = S is not None and 8 * S <= 132 and res is not None \
                and res["buffers"] == 1
            assert (lay["mode"] == "resident") == (res is not None
                                                   and not few)
            clusters = [C for C in cuda_kernels.DENSE_CLUSTERS if C <= mc]
            if lay["mode"] == "streamed":
                # it streams rows, or keeps its vectors in device memory
                assert lay["C"] == mc
                assert lay["hold"] != (lay["mk"], lay["nk"], lay["nk"]) \
                    or not lay["vec_smem"]
                assert all(cuda_kernels._dense_mode_layout(
                    m, n, isz, lowered, "cluster", C) is None
                    for C in clusters)
            # every mode and cluster size a caller may force fits too
            for other, Cs in (("cluster", clusters), ("streamed", (mc,))):
                for C in Cs:
                    alt = cuda_kernels._dense_mode_layout(m, n, isz, lowered,
                                                          other, C)
                    if alt is not None:
                        assert (alt["mode"], alt["C"]) == (other, C)
                        _check_dense_layout(m, n, isz, lowered, alt)
    assert modes == {"resident", "cluster", "streamed"}


def test_dense_layout_picks_at_the_paths_shapes():
    """The modes the paths' shapes take on an H100 (132 SMs, clusters of 16
    placed): farmer's (28, 44) and netdes-1000's (35, 50) stay resident with
    two buffers; bundled
    farmer's (84, 108) in f32 is resident with one buffer (no longer the
    one-block streamed mode); the buckets in f64 take a cluster of 2;
    sizes' S=3 a cluster of 16; sslp's (60, 520) a cluster of 16 in f32 and
    the streamed mode in f64, holding every K^-1 and A row and 15 of 33 K
    rows (no ring: the other K rows are read from device memory), or at 8
    CTAs where the card places no 16."""
    dl = cuda_kernels.dense_layout
    for isz in (4, 8):
        for lowered in (False, True):
            for m, n in ((28, 44), (35, 50)):   # farmer-1000, netdes-1000
                lay = dl(m, n, isz, lowered, 1000, 132)
                assert (lay["mode"], lay["buffers"]) == ("resident", 2)
    lay = dl(84, 108, 4, False, 200, 132)
    assert (lay["mode"], lay["buffers"]) == ("resident", 1)
    for S, m, n in ((200, 84, 108), (100, 112, 140), (200, 105, 100),
                    (100, 140, 125), (64, 84, 132)):
        lay = dl(m, n, 8, False, S, 132)
        assert (lay["mode"], lay["C"]) == ("cluster", 2), (S, m, n)
    for isz in (4, 8):
        assert dl(62, 150, isz, False, 3, 132)["C"] == 16
    lay = dl(60, 520, 4, False, 50, 132)
    assert (lay["mode"], lay["C"]) == ("cluster", 16)
    lay = dl(60, 520, 8, False, 50, 132)
    assert (lay["mode"], lay["C"], lay["hold"]) == ("streamed", 16,
                                                    (4, 33, 15))
    assert lay["vec_smem"] and lay["ns"] == 0
    lay = dl(60, 520, 8, False, 50, 132, 8)
    assert (lay["mode"], lay["C"]) == ("streamed", 8)
    assert lay["hold"][1] < lay["nk"]
    # the tall shape: in f64 its work vectors go to device-memory scratch
    lay = dl(60000, 44, 8, False, 4, 132)
    assert lay["mode"] == "streamed" and not lay["vec_smem"]


def test_dense_matrix_reads():
    """The matrices once in the resident and cluster modes; in the streamed
    mode every row it does not hold once a pass that reads it besides."""
    S, m, n, ns, nr = 50, 60, 520, 4, 2
    lay = cuda_kernels.dense_layout(m, n, 8, False, S, 132)
    once = S * (m * n + 2 * n * n) * 8
    streamed_k = sum(b - a - lay["hold"][2] for a, b in lay["krows"])
    assert cuda_kernels.dense_matrix_reads(S, m, n, 8, lay, ns, nr) == \
        once + S * streamed_k * n * 8 * (nr * ns - 1)
    for shape in ((28, 44), (84, 108)):
        lay = cuda_kernels.dense_layout(*shape, 8)
        m, n = shape
        assert cuda_kernels.dense_matrix_reads(3, m, n, 8, lay, ns, nr) == \
            3 * (m * n + 2 * n * n) * 8
    lay = cuda_kernels.dense_layout(84, 108, 8, True)
    assert cuda_kernels.dense_matrix_reads(3, 84, 108, 8, lay, ns, nr,
                                           True) == \
        3 * (84 * 108 * 2 + 108 * 108 * (2 + 8))


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
    resident mode, and at crops_multiplier=12 (m=84, n=132) in f64 a
    cluster."""
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
    assert cuda_kernels.dense_layout(84, 132, 8)["mode"] == "cluster"
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
    assert set(cuda_kernels.dense_modes) == {"resident", "cluster",
                                             "streamed"}
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
