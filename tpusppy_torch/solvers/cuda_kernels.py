"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

``fused_sweeps`` replaces the TPU Pallas kernel
``tpusppy/solvers/pallas_kernels.py:_sweeps_kernel``: ``n_sweeps`` relaxed
OSQP sweeps per scenario of the dense engine.  Two modes, by
:func:`dense_layout`: resident (a scenario's A, K^-1 and K sit in shared
memory, the next scenario's arriving by bulk copies meanwhile) and streamed
(the matrices pass through staged panels), so it takes every shape
(source, bound and design notes: ``tpusppy_torch/csrc/fused_sweeps.cu``).

``fused_sweeps_shared`` replaces ``pallas_kernels.py:_shared_sweeps_kernel``:
one ``n_sweeps`` block of the shared-A engine's sweep, with one (m, n) A and
one (n, n) K^-1 and K for the whole batch, per-scenario gamma scaling and the
dq2 refinement (``tpusppy_torch/csrc/fused_sweeps_shared.cu``).  Two modes,
by :func:`shared_mode`: cluster-resident (the matrices cut into column
slices held across a thread-block cluster, :func:`shared_pack`), taken
when every tile of the batch has a cluster at once, and streamed (a block
a tile, A and A' read from L2) otherwise.

``fused_sweeps_sparse`` replaces ``pallas_kernels.py:_sparse_sweeps_kernel``:
the same block on the sparse and structured-KKT engines, with exact
padded-ELL matvecs for A and A' and a matrix-free refinement defect
g (diagK x + A'(rho_a A x)) + dq2 x
(``tpusppy_torch/csrc/fused_sweeps_sparse.cu``).  It has two modes, by the
K^-1 operand: a dense (n, n) matrix (the unstructured regimes), or the
block/Woodbury operator in its kernel layout
(:class:`~.structured_kkt.KernelWoodbury`), applied block by block with the
blocks staged through shared memory and A's narrow and wide rows taken
apart.

Each wrapper launches its kernel for CUDA tensors and raises on anything it
cannot take; for CPU tensors it runs the plain version beside it, the batched
PyTorch transcription of the same recurrence (the CPU path, and the oracle
the kernel is held against on the card).  There is no fallback on failure.
Launches are counted per kernel and, for each kernel's modes, per mode; a
launch captured into a CUDA graph is counted by each replay of the graph
(:func:`counts`, :func:`add_counts`, used by :mod:`.device_loop`).

Every wrapper and plain version takes ``stop``, the solve loop's stop flag
(a one-element int32 tensor on the solve's device, :mod:`.device_loop`):
where it is set, the kernel returns before it does anything and leaves its
outputs unwritten, and the plain version returns its inputs.  None (the
default) is a clear flag.

Each kernel is compiled on first use with ``nvcc`` for ``sm_90a`` into its
own library under ``tpusppy_torch/_build/`` (named by the source's hash) and
bound with ``ctypes``; nothing is built or imported from CUDA when this
module loads.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .sparse import SparseA, ell_matvec, ell_slot_major
from .structured_kkt import KernelWoodbury, kinv_apply, narrow_wide_matvec

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232448

#: Kernel launches per wrapper (one per launch, nowhere else), and calls of
#: the plain versions; :func:`reset_counts` zeroes both.
launches = {"fused_sweeps": 0, "fused_sweeps_shared": 0,
            "fused_sweeps_sparse": 0}
plain_calls = {"fused_sweeps": 0, "fused_sweeps_shared": 0,
               "fused_sweeps_sparse": 0}
#: ``fused_sweeps_sparse`` launches by mode: a dense K^-1 or the structured
#: (block/Woodbury) operand.
sparse_modes = {"dense": 0, "structured": 0}
#: ``fused_sweeps_shared`` launches by mode (:func:`shared_mode`).
shared_modes = {"resident": 0, "streamed": 0}
#: ``fused_sweeps`` launches by mode (:func:`dense_layout`).
dense_modes = {"resident": 0, "streamed": 0}
_COUNTS = {"launches": launches, "plain_calls": plain_calls,
           "sparse_modes": sparse_modes, "shared_modes": shared_modes,
           "dense_modes": dense_modes}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
#: Exported C entry points of each source (f32, f64), with their ctypes
#: argument types.
_ENTRY_POINTS = {
    # (in ptrs, out ptrs, stop, S, m, n, n_sweeps, n_refine, mode, nsm,
    #  sigma, alpha, stream)
    "fused_sweeps": [(("tpusppy_fused_sweeps_f32",
                       "tpusppy_fused_sweeps_f64"),
                      [_P, _P, _P] + [_I] * 7 + [_D, _D, _P])],
    "fused_sweeps_shared": [
        # streamed: (in ptrs, out ptrs, stop, S, m, n, sb, chunk, n_sweeps,
        # n_refine, n_extra, sigma, alpha, stream)
        (("tpusppy_fused_sweeps_shared_f32",
          "tpusppy_fused_sweeps_shared_f64"),
         [_P, _P, _P] + [_I] * 8 + [_D, _D, _P]),
        # resident: (in ptrs, out ptrs, stop, S, m, n, C, ld, km, kn,
        # n_sweeps, n_refine, n_extra, sigma, alpha, stream)
        (("tpusppy_fused_sweeps_shared_res_f32",
          "tpusppy_fused_sweeps_shared_res_f64"),
         [_P, _P, _P] + [_I] * 10 + [_D, _D, _P]),
        # the resident mode's clusters held at once: (m, n, C, ld, km, kn,
        # out)
        (("tpusppy_fused_sweeps_shared_clusters_f32",
          "tpusppy_fused_sweeps_shared_clusters_f64"),
         [_I] * 6 + [ctypes.POINTER(ctypes.c_int)])],
    "fused_sweeps_sparse": [
        # dense K^-1: (in ptrs, out+scratch ptrs, stop, S, m, n, kr, kc, sb,
        # n_sweeps, n_refine, n_extra, sigma, alpha, stream)
        (("tpusppy_fused_sweeps_sparse_f32",
          "tpusppy_fused_sweeps_sparse_f64"),
         [_P, _P, _P] + [_I] * 9 + [_D, _D, _P]),
        # structured: the same, then r, kn, kw, kwc, nb, items, pd,
        # stage_elems, bmax before the stream
        (("tpusppy_fused_sweeps_sparse_wb_f32",
          "tpusppy_fused_sweeps_sparse_wb_f64"),
         [_P, _P, _P] + [_I] * 9 + [_D, _D] + [_I] * 9 + [_P])],
}

_libs: dict = {}
_lib_lock = threading.Lock()
#: The compiler's resource report (``-Xptxas -v``) of each built source.
build_log: dict = {}


def reset_counts():
    for d in _COUNTS.values():
        for k in d:
            d[k] = 0


def counts() -> dict:
    """Every launch and plain-call count, flat: ``{(table, key): n}``."""
    return {(t, k): v for t, d in _COUNTS.items() for k, v in d.items()}


def add_counts(delta: dict):
    """Add a :func:`counts`-shaped delta (what one CUDA-graph replay
    launches) to the counts."""
    for (t, k), v in delta.items():
        _COUNTS[t][k] += v


def _gate(stop, ins, outs):
    """The plain versions' side of the stop flag: each output where
    ``stop`` is clear, its input where it is set (on the device, with no
    host read)."""
    if stop is None:
        return tuple(outs)
    stopped = stop.reshape(()) != 0
    return tuple(torch.where(stopped, i, o) for i, o in zip(ins, outs))


#: A clear stop flag per device, for wrappers called without one.
_CLEAR: dict = {}


def _stop_ptr(stop, dev):
    """The stop flag's device pointer, checked: a one-element int32 tensor
    on the kernel's device (a clear one where ``stop`` is None)."""
    if stop is None:
        stop = _CLEAR.get(dev)
        if stop is None:
            stop = _CLEAR[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    if stop.numel() != 1 or stop.dtype != torch.int32 or stop.device != dev:
        raise ValueError(f"stop must be one int32 on {dev}; got "
                         f"{tuple(stop.shape)} {stop.dtype} on {stop.device}")
    return stop.data_ptr()


def matvec(M, v):
    """``M v`` per scenario: (S, n, k) @ (S, k) batched, or a shared (n, k)
    matrix (dense or :class:`~.sparse.SparseA`) against (S, k) rows."""
    if isinstance(M, SparseA):
        return M.matvec(v)
    if M.ndim == 2:
        return v @ M.T
    return torch.bmm(M, v.unsqueeze(-1)).squeeze(-1)


def rmatvec(A, y):
    """``A' y`` per scenario: (S, m, n) batched, or a shared (m, n) A
    (dense or :class:`~.sparse.SparseA`) against (S, m) rows."""
    if isinstance(A, SparseA):
        return A.rmatvec(y)
    if A.ndim == 2:
        return y @ A
    return torch.bmm(A.transpose(1, 2), y.unsqueeze(-1)).squeeze(-1)


def _r16(nbytes):
    return -(-nbytes // 16) * 16


#: Threads per block of ``fused_sweeps`` (``kThreads`` in the source).
_DENSE_THREADS = 256
#: Bytes of one stage buffer's panel in its streamed mode (``kStageBytes``).
_STAGE_BYTES = 32768


def _dense_array_lens(m, n):
    """Elements of one scenario's arrays in the resident buffer's slot
    order: A, K^-1, K, q, lb, ub, rho_x, x, zx, yx, cl, cu, rho_a, z, y,
    Ax."""
    return [m * n, n * n, n * n] + [n] * 7 + [m] * 6


@functools.lru_cache(maxsize=64)
def dense_layout(m, n, itemsize) -> dict:
    """Mode and shared memory of one ``fused_sweeps`` block (mirrors
    ``ResLayout`` and ``StreamLayout`` in the CUDA source).

    Resident when two scenario buffers fit beside the two mbarriers, the
    slots' offsets and the work vectors (rhs, xt, r of n and v of m): each
    buffer holds a scenario's 16 arrays, each
    in a slot 16 bytes longer than its 16-byte-rounded size (the span a
    bulk copy brings in may start up to 15 bytes early).  Otherwise
    streamed: two stage buffers of ``_STAGE_BYTES`` (+32) for the matrix
    panels, and the work vectors (rhs, xt, r, t and v) in shared memory
    where they fit (``vec_smem``), else ``scratch`` values a block in
    device memory.  Cached per shape: the wrapper asks at every launch,
    so callers must not change the dict."""
    slots = [_r16(L * itemsize) + 16 for L in _dense_array_lens(m, n)]
    work = 16 + 4 * len(slots)
    buf = work + 3 * _r16(n * itemsize) + _r16(m * itemsize)
    total = buf + 2 * sum(slots)
    if total <= SMEM_LIMIT:
        return {"mode": "resident", "smem": total, "buffer": sum(slots),
                "slots": slots, "work": work, "buf": buf}
    stage = _STAGE_BYTES + 32
    work = 16 + 2 * stage
    work_bytes = 4 * _r16(n * itemsize) + _r16(m * itemsize)
    vec_smem = work + work_bytes <= SMEM_LIMIT
    return {"mode": "streamed", "smem": work + work_bytes if vec_smem
            else work, "stage": stage, "work": work, "vec_smem": vec_smem,
            "scratch": 0 if vec_smem else work_bytes // itemsize}


def usable(S, m, n, dtype) -> bool:
    """Whether ``fused_sweeps`` takes this shape: f32/f64, at least one
    scenario and one variable.  No limit comes from m or n: a scenario
    that does not fit shared memory runs the streamed mode
    (:func:`dense_layout`).  Covers every shape ``pallas_kernels.usable``
    takes and those the reference sends to its XLA sweep."""
    return dtype in (torch.float32, torch.float64) and S >= 1 and n >= 1 \
        and m >= 0


def fused_sweeps_plain(q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x,
                       x, z, zx, y, yx, Ax, n_sweeps, n_refine, sigma,
                       alpha, stop=None):
    """The sweep recurrence of ``admm._admm_core`` in batched tensor form
    (``tests/test_pallas.py:_xla_sweeps`` in PyTorch).  Natural layout:
    A (S, m, n), Kinv/K (S, n, n), vectors (S, n) or (S, m).  Returns
    ``(x, z, zx, y, yx, Ax)`` after ``n_sweeps`` sweeps with the incremental
    Ax carry, or the inputs where ``stop`` is set."""
    plain_calls["fused_sweeps"] += 1
    state_in = (x, z, zx, y, yx, Ax)
    # column vectors (S, k, 1) so every matvec is one bmm
    q, cl, cu, lb, ub, rho_a, rho_x, x, z, zx, y, yx, Ax = (
        t.unsqueeze(-1) for t in (q, cl, cu, lb, ub, rho_a, rho_x, x, z, zx,
                                  y, yx, Ax))
    At = A.transpose(1, 2)
    # Python scalars, not device tensors: a tensor made from a host value
    # is a blocking copy on CUDA
    sigma, alpha, beta = float(sigma), float(alpha), 1.0 - float(alpha)
    for _ in range(n_sweeps):
        rhs = sigma * x - q + torch.bmm(At, rho_a * z - y) + (rho_x * zx - yx)
        xt = torch.bmm(Kinv, rhs)
        for _ in range(n_refine):
            r = rhs - torch.bmm(K, xt)
            xt = xt + torch.bmm(Kinv, r)
        Axt = alpha * torch.bmm(A, xt)
        xt = alpha * xt
        x_new = xt + beta * x
        Ax_new = Axt + beta * Ax
        # the relaxed points alpha*Axt + (1-alpha)*z and alpha*xt +
        # (1-alpha)*zx, each formed once and reused by the dual update
        za = Axt + beta * z
        z_new = torch.clamp(za + y / rho_a, cl, cu)
        y_new = y + rho_a * (za - z_new)
        zxa = xt + beta * zx
        zx_new = torch.clamp(zxa + yx / rho_x, lb, ub)
        yx_new = yx + rho_x * (zxa - zx_new)
        x, z, zx, y, yx, Ax = x_new, z_new, zx_new, y_new, yx_new, Ax_new
    return _gate(stop, state_in,
                 (t.squeeze(-1) for t in (x, z, zx, y, yx, Ax)))


# ---- fused_sweeps_shared ---------------------------------------------------

#: Scenario tiles (scenarios per thread block) the streamed mode is built
#: for, largest first; mirrors the ``case`` labels of the CUDA launcher.
SHARED_TILES = (8, 4, 2, 1)
#: Fewest constraint rows one chunk of the streamed mode's A' contraction
#: may hold.
_MIN_CHUNK = 32
#: Threads per block of the streamed mode (``kThreads`` in the source).
_SHARED_THREADS = 512
#: Scenarios per tile of the resident mode (``kResTile``): the n8 side of
#: the f64 tensor-core tile.
RESIDENT_TILE = 8
#: Threads per CTA of the resident mode (``kResThreads``).
_RESIDENT_THREADS = 256
#: Largest cluster the resident mode uses (the portable limit).
MAX_CLUSTER = 8
#: Output columns a lane of the resident mode's f32 column products holds
#: (``kColsPerLane``).
_COLS_PER_LANE = 3


def _split_values(itemsize):
    """Values of the resident mode's per-warp partial sums of a column
    product (``split_values`` in the CUDA source)."""
    warps = _RESIDENT_THREADS // 32
    return warps * (16 if itemsize == 8 else 32 * _COLS_PER_LANE) \
        * RESIDENT_TILE


def _resident_offsets(ld, km, kn, mcm, itemsize) -> dict:
    """Byte offsets of the resident mode's shared buffers (mirrors
    ``ResLayout`` in the CUDA source)."""
    sb, off, o = RESIDENT_TILE, {}, 0
    for name, nbytes in (
            ("bar", 16), ("gam", _r16(sb * itemsize)),
            ("mats", _r16((km + 2 * kn) * ld * itemsize)),
            ("v", _r16(km * sb * itemsize)), ("w", _r16(kn * sb * itemsize)),
            ("xt", _r16((kn + ld) * sb * itemsize)),
            ("rhs", _r16(ld * sb * itemsize)),
            ("part", _r16(max(km * sb, _split_values(itemsize))
                          * itemsize)),
            ("cols", 7 * _r16(ld * sb * itemsize)),
            ("rows", 5 * _r16(mcm * sb * itemsize))):
        off[name] = o
        o += nbytes
    off["total"] = o
    return off


def _streamed_layout(m, n, itemsize):
    """``(sb, chunk)`` of one streamed block, or None: it keeps, for its
    ``sb`` scenarios, their gammas, the rhs, K^-1 input and x-tilde
    n-vectors, one ``chunk``-row slice of the A' input and one partial sum
    per thread; A, K^-1 and K stream from device memory and L2.  The
    largest tile whose buffers fit with a chunk of at least ``min(m, 32)``
    rows wins, and the chunk then takes the rest of the budget, up to all
    m."""
    for sb in SHARED_TILES:
        cap = SMEM_LIMIT // (itemsize * sb) - 1 - 3 * n - _SHARED_THREADS
        if cap >= max(1, min(m, _MIN_CHUNK)):
            return sb, max(1, min(m, cap))
    return None


def shared_smem_bytes(m, n, itemsize, sb, chunk):
    """``(bytes, resident)``: shared memory of one streamed block, which
    also holds K^-1 (``resident`` 1) and then K (3) where they still fit;
    the rest stream from L2 (mirrors ``launch_tile`` in the CUDA
    source)."""
    smem = sb * (1 + 3 * n + chunk + _SHARED_THREADS) * itemsize
    mat = n * n * itemsize
    resident = 0
    for bit in (1, 2):
        if smem + mat > SMEM_LIMIT:
            break
        resident |= bit
        smem += mat
    return smem, resident


def _resident_layout(m, n, itemsize):
    """The cluster-resident layout (see :func:`shared_layout`), or None
    where the slices do not fit even across ``MAX_CLUSTER`` CTAs."""
    unit = 16 if itemsize == 8 else 2
    pad = (lambda k: -(-k // 16) * 16) if itemsize == 8 else (lambda k: k)
    nu = -(-n // unit)
    km, kn = pad(m), pad(n)
    for C in range(1, MAX_CLUSTER + 1):
        ld = unit * -(-nu // C)
        mcm = -(-m // C)
        off = _resident_offsets(ld, km, kn, mcm, itemsize)
        if off["total"] <= SMEM_LIMIT:
            return {"mode": "resident", "C": C, "sb": RESIDENT_TILE,
                    "ld": ld, "km": km, "kn": kn,
                    "cols": [(unit * (r * nu // C),
                              min(n, unit * ((r + 1) * nu // C)))
                             for r in range(C)],
                    "rows": [(r * m // C, (r + 1) * m // C)
                             for r in range(C)],
                    "offsets": off, "smem": off["total"],
                    "reg": (off["v"] - off["mats"]) // itemsize}
    return None


@functools.lru_cache(maxsize=128)
def shared_layout(m, n, itemsize, mode=None) -> dict | None:
    """The layout of ``fused_sweeps_shared`` in ``mode`` at this shape, or
    None if that mode does not take it; ``mode`` None gives the
    cluster-resident layout where it exists, else the streamed one.

    Cluster-resident when A, K^-1 and K, cut into C column slices, fit with
    the tile's buffers in every CTA's shared memory, for the smallest C up
    to ``MAX_CLUSTER``: slices are whole units of 16 columns in f64 (the
    tensor-core tile) and 2 in f32, rank r taking units [r NU / C,
    (r + 1) NU / C); rows of m go to the ranks as [r m / C, (r + 1) m /
    C).  In f64 the slices' rows are padded to 16 (``km``, ``kn``).  Keys:
    ``mode`` "resident", ``C``, ``sb``, ``ld`` (a slice's padded width),
    ``km``, ``kn``, ``cols`` and ``rows`` (each rank's ranges), ``offsets``
    (of its shared buffers), ``smem``, ``reg`` (elements of a rank's packed
    slices, :func:`shared_pack`).  Streamed: ``mode`` "streamed", ``sb``,
    ``chunk``, ``smem``, ``resident`` (bits: K^-1, K in shared memory).
    Which of the two a launch runs is :func:`shared_mode`'s choice.
    Cached per shape: the wrapper asks at every launch, so callers must not
    change the dict."""
    if n < 1 or m < 0 or itemsize not in (4, 8) \
            or mode not in (None, "resident", "streamed"):
        return None
    if mode != "streamed":
        lay = _resident_layout(m, n, itemsize)
        if lay is not None or mode == "resident":
            return lay
    lay = _streamed_layout(m, n, itemsize)
    if lay is None:
        return None
    smem, resident = shared_smem_bytes(m, n, itemsize, *lay)
    return {"mode": "streamed", "sb": lay[0], "chunk": lay[1], "smem": smem,
            "resident": resident}


def shared_mode(S, m, n, itemsize, clusters) -> str | None:
    """The mode ``fused_sweeps_shared`` launches for ``S`` scenarios:
    cluster-resident where its layout exists and either fits one CTA
    (C = 1) or every tile of the batch has a cluster at once (``ceil(S /
    RESIDENT_TILE) <= clusters``, the clusters of its C the card holds
    together), or where the streamed mode does not take the shape;
    streamed otherwise; None where neither mode takes it.

    With C = 1 the resident mode loads the matrices once a CTA, not once a
    tile, and pays no cluster costs.  With C >= 2 it spreads one tile over
    C SMs and pays a cluster barrier for each of its products, where the
    streamed mode gives a tile one SM: it wins while the streamed mode
    would leave SMs idle, and loses once its tiles queue for a second
    round of clusters.  Both from the crossover of
    ``scripts/port_shared_ablation.py`` on an H100 (PERF.md)."""
    res = shared_layout(m, n, itemsize, "resident")
    streamed = shared_layout(m, n, itemsize, "streamed")
    if res is not None and (streamed is None or res["C"] == 1
                            or -(-S // RESIDENT_TILE) <= clusters):
        return "resident"
    return None if streamed is None else "streamed"


def usable_shared(S, m, n, dtype) -> int | None:
    """Scenarios per tile if ``fused_sweeps_shared`` takes this shape, else
    None.  Mirrors ``pallas_kernels.usable_shared`` sized to Hopper: the
    resident mode takes the matrices that fit across a cluster of up to 8
    CTAs, and the streamed mode reads them from L2, so only a block's
    scenario vectors limit the shape (n up to ~9,600 in f64), which covers
    every shape the TPU kernel's 1.5 MB matrix budget admits."""
    if dtype not in (torch.float32, torch.float64) or S < 1:
        return None
    lay = shared_layout(m, n, 4 if dtype == torch.float32 else 8)
    return None if lay is None else lay["sb"]


def shared_pack(A, Kinv, K, lay):
    """The resident mode's matrices: (C, reg) with rank r's row holding
    columns ``lay["cols"][r]`` of A (km rows), K^-1 and K (kn rows each),
    each (rows, ld) row-major, zero-padded; the kernel brings a rank's row
    into its shared memory with one bulk copy."""
    m, n = A.shape
    C, ld, km, kn = lay["C"], lay["ld"], lay["km"], lay["kn"]
    out = torch.zeros((C, lay["reg"]), dtype=A.dtype, device=A.device)
    for r, (j0, j1) in enumerate(lay["cols"]):
        if j1 <= j0:
            continue
        blk = out[r, :(km + 2 * kn) * ld].view(km + 2 * kn, ld)
        blk[:m, :j1 - j0] = A[:, j0:j1]
        blk[km:km + n, :j1 - j0] = Kinv[:, j0:j1]
        blk[km + kn:km + kn + n, :j1 - j0] = K[:, j0:j1]
    return out


def _version(t):
    """``t``'s version counter (it moves with every in-place write), or
    None for a tensor that keeps none (one made in inference mode)."""
    try:
        return t._version
    except RuntimeError:
        return None


#: The last operand the shared wrapper made: (A, K^-1, K, mode, versions,
#: operand).  Holding the three tensors keeps their identity unique.
_operand_cache: list = []


def shared_operand(A, Kinv, K, lay):
    """What ``fused_sweeps_shared`` in ``lay``'s mode reads of the shared
    matrices: the packed slices in the resident mode (:func:`shared_pack`),
    A' contiguous in the streamed mode (it reads A along rows for A'v and
    along columns, as A', for A xt).  The last one made is kept and handed
    out again while the wrapper gets the same A, K^-1 and K tensors in the
    same mode, none written since (their version counters), so a solve's
    blocks make it once and a new factorization makes it anew.  Not inside
    a CUDA-graph capture, which would keep the operand made there and
    sweep it after new matrices were copied into the graph's buffers: a
    captured loop makes its operand before the capture
    (:func:`shared_plan`) and hands it to the wrapper as an input."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "fused_sweeps_shared inside a CUDA-graph capture takes the "
            "operand made before it (shared_plan)")
    versions = tuple(_version(t) for t in (A, Kinv, K))
    if _operand_cache and None not in versions:
        a, ki, k, mode, ver, op = _operand_cache[0]
        if a is A and ki is Kinv and k is K and mode == lay["mode"] \
                and ver == versions:
            return op
    op = shared_pack(A, Kinv, K, lay) if lay["mode"] == "resident" \
        else A.T.contiguous()
    _operand_cache[:] = [(A, Kinv, K, lay["mode"], versions, op)]
    return op


def _check_precision(name, precision):
    if precision != "highest":
        raise ValueError(
            f"{name}: precision {precision!r} is not ported; only "
            f"'highest' (full f32/f64) is (the bf16 modes wait for ROADMAP "
            f"Queue 1 item 5)")


def fused_sweeps_shared_plain(q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x,
                              dq2, has, gamma, x, z, zx, y, yx, Ax, n_sweeps,
                              n_refine, n_extra, sigma, alpha,
                              precision="highest", mode=None, stop=None):
    """One ``n_sweeps`` block of ``shared_admm._core`` in batched tensor
    form (``tests/test_pallas.py``'s XLA shared sweep in PyTorch).  Shapes:
    A (m, n), Kinv/K (n, n) and rho_a (1, m), rho_x (1, n) are shared; q,
    lb, ub, dq2, x, zx, yx are (S, n); cl, cu, z, y, Ax (S, m); gamma
    (S, 1); ``has`` (1, 1) is the batch-global ``any(dq2 != 0)`` that arms
    the ``n_extra`` refinement passes (read on the device, never on the
    host).  ``mode`` (the kernel's) is accepted and unused here.  Returns
    ``(x, z, zx, y, yx, Ax)``, or the inputs where ``stop`` is set."""
    _check_precision("fused_sweeps_shared_plain", precision)
    plain_calls["fused_sweeps_shared"] += 1
    state_in = (x, z, zx, y, yx, Ax)
    g = gamma
    sigma, alpha, beta = float(sigma), float(alpha), 1.0 - float(alpha)
    sigma_s = g * sigma
    rho_a_s = g * rho_a
    rho_x_s = g * rho_x
    extra = has > 0
    At = A.T

    def refine(xt, rhs):
        return xt + ((rhs - (g * (xt @ K) + dq2 * xt)) / g) @ Kinv

    for _ in range(n_sweeps):
        rhs = (sigma_s * x - q + (rho_a_s * z - y) @ A) + (rho_x_s * zx - yx)
        xt = (rhs / g) @ Kinv
        for _ in range(n_refine):
            xt = refine(xt, rhs)
        for _ in range(n_extra):
            xt = torch.where(extra, refine(xt, rhs), xt)
        Axt = alpha * (xt @ At)
        xt = alpha * xt
        x_new = xt + beta * x
        Ax_new = Axt + beta * Ax
        za = Axt + beta * z
        z_new = torch.clamp(za + y / rho_a_s, cl, cu)
        y_new = y + rho_a_s * (za - z_new)
        zxa = xt + beta * zx
        zx_new = torch.clamp(zxa + yx / rho_x_s, lb, ub)
        yx_new = yx + rho_x_s * (zxa - zx_new)
        x, z, zx, y, yx, Ax = x_new, z_new, zx_new, y_new, yx_new, Ax_new
    return _gate(stop, state_in, (x, z, zx, y, yx, Ax))


# ---- fused_sweeps_sparse ---------------------------------------------------

#: Scenario tiles the sparse kernel is built for, largest first; mirrors
#: the ``case`` labels of the CUDA launcher.
SPARSE_TILES = (8, 4, 2, 1)
#: Threads per block of the sparse kernel (``kThreads`` in the source).
_SPARSE_THREADS = 512
#: Largest element offset into one ELL array (32-bit ``int`` in the kernel).
_INT_MAX = 2 ** 31 - 1


def sparse_smem_bytes(n, itemsize, sb, kinv=None) -> int:
    """Shared memory of one ``fused_sweeps_sparse`` block of ``sb``
    scenarios (mirrors ``smem_dense`` and ``smem_structured`` in the CUDA
    source).  With a dense K^-1: their gammas, the K^-1 input and x-tilde
    n-vectors, and one split-k partial sum per thread.  With the structured
    operand ``kinv`` (a :class:`~.structured_kkt.KernelWoodbury`): two
    mbarriers, the gammas and x-tilde, two staging buffers of the largest
    panel, the partial sums of a block product (``max(threads, bmax)``
    columns), and four ``bmax``-row tile vectors (two of a block's input,
    u and v of the Woodbury cap), each region 16-byte aligned; the K^-1
    input and the Woodbury correction then live in device-memory
    scratch.  The rhs and the m-vectors always
    do."""
    if kinv is None:
        return itemsize * sb * (1 + 2 * n + _SPARSE_THREADS)
    pat = kinv.pattern
    stage = pat.stage_elems[itemsize]
    return (16 + _r16(itemsize * sb) + _r16(itemsize * sb * n)
            + 2 * _r16(itemsize * stage)
            + _r16(itemsize * sb * max(_SPARSE_THREADS, pat.bmax))
            + 4 * _r16(itemsize * sb * pat.bmax))


def usable_sparse(S, m, n, kr, kc, dtype, kinv=None) -> int | None:
    """Scenarios per block if ``fused_sweeps_sparse`` takes this shape, else
    None.  Mirrors ``pallas_kernels.usable_sparse`` sized to Hopper: K^-1
    and the ELL arrays stream from device memory and L2, so only a block's
    two n-vectors per scenario limit the shape (n up to ~14,000 in f64,
    ~28,000 in f32, one scenario a block).  kr and kc are run-time loop
    bounds, so there is no slot cap (the TPU kernel unrolls them and stops
    at 64); the ELL arrays must only stay within 32-bit offsets.  With the
    structured operand ``kinv`` one n-vector a scenario stays in shared
    memory beside the staged panels (n up to ~38,000 in f32 and ~18,000 in
    f64 at uc's panels, one scenario a block), and no stored block may be wider than the threads
    of a block (each thread takes one column of a block product)."""
    if dtype not in (torch.float32, torch.float64) or S < 1 or n < 1 \
            or m < 0 or kr < 1 or kc < 1:
        return None
    if m * kr > _INT_MAX or n * kc > _INT_MAX:
        return None
    if kinv is not None and (kinv.pattern.bmax > _SPARSE_THREADS
                             or kinv.mats.numel() > _INT_MAX):
        return None
    itemsize = 4 if dtype == torch.float32 else 8
    for sb in SPARSE_TILES:
        if sparse_smem_bytes(n, itemsize, sb, kinv) <= SMEM_LIMIT:
            return sb
    return None


def fused_sweeps_sparse_plain(q, rowcols, rowvals, colrows, colvals, Kinv,
                              diagK, cl, cu, lb, ub, rho_a, rho_x, dq2, has,
                              gamma, x, z, zx, y, yx, Ax, n_sweeps, n_refine,
                              n_extra, sigma, alpha, precision="highest",
                              stop=None):
    """One ``n_sweeps`` block of ``shared_admm._core`` on a sparse A in
    batched tensor form, a transcription of
    ``pallas_kernels._sparse_sweeps_kernel``: ELL arrays (m, kr)/(n, kc),
    ``Kinv`` the dense (n, n) inverse or the structured operand (a
    :class:`~.structured_kkt.KernelWoodbury`, applied with ``kinv_apply``
    as the reference's XLA sweep applies its BlockWoodbury, with A x taken
    over the narrow rows' first ``kn`` slots and the wide rows' lists, as
    the kernel takes it), ``diagK`` (1, n) = q2ref + rho_x + sigma (the
    matrix-free defect's diagonal), ``rho_a`` (1, m) unscaled, everything
    else as :func:`fused_sweeps_shared_plain`.  Returns
    ``(x, z, zx, y, yx, Ax)``, or the inputs where ``stop`` is set."""
    _check_precision("fused_sweeps_sparse_plain", precision)
    plain_calls["fused_sweeps_sparse"] += 1
    state_in = (x, z, zx, y, yx, Ax)
    rc_t, rv_t, cr_t, cv_t = ell_slot_major((rowcols, rowvals, colrows,
                                             colvals))
    if isinstance(Kinv, KernelWoodbury):
        def kinv(v):
            return kinv_apply(Kinv.bw, v)

        def mv(v):
            return narrow_wide_matvec(Kinv, v)
    else:
        def kinv(v):
            return v @ Kinv

        def mv(v):
            return ell_matvec(rc_t, rv_t, v)
    g = gamma
    sigma, alpha, beta = float(sigma), float(alpha), 1.0 - float(alpha)
    rho_a_s = g * rho_a
    rho_x_s = g * rho_x
    sigma_s = g * sigma
    extra = has > 0

    def rmv(v):
        return ell_matvec(cr_t, cv_t, v)

    def refine(xt, rhs):
        Kx = xt * diagK + rmv(mv(xt) * rho_a)
        return xt + kinv((rhs - (g * Kx + dq2 * xt)) / g)

    for _ in range(n_sweeps):
        rhs = (sigma_s * x - q + rmv(rho_a_s * z - y)) + (rho_x_s * zx - yx)
        xt = kinv(rhs / g)
        for _ in range(n_refine):
            xt = refine(xt, rhs)
        for _ in range(n_extra):
            xt = torch.where(extra, refine(xt, rhs), xt)
        Axt = alpha * mv(xt)
        xt = alpha * xt
        x_new = xt + beta * x
        Ax_new = Axt + beta * Ax
        za = Axt + beta * z
        z_new = torch.clamp(za + y / rho_a_s, cl, cu)
        y_new = y + rho_a_s * (za - z_new)
        zxa = xt + beta * zx
        zx_new = torch.clamp(zxa + yx / rho_x_s, lb, ub)
        yx_new = yx + rho_x_s * (zxa - zx_new)
        x, z, zx, y, yx, Ax = x_new, z_new, zx_new, y_new, yx_new, Ax_new
    return _gate(stop, state_in, (x, z, zx, y, yx, Ax))


# ---- build and bind --------------------------------------------------------

def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "tpusppy_torch/csrc on first use and need the "
                           "CUDA toolkit")
    return nvcc


def _lib_path(name) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(*names) -> list:
    """Compile each ``csrc/<name>.cu`` (default: every kernel) into its own
    shared library under ``_build/``, named by the source's hash, unless it
    exists; the ``nvcc`` runs start together.  Returns the libraries'
    paths.  The compiler's resource reports (``-Xptxas -v``) land in
    :data:`build_log`."""
    names = names or tuple(_ENTRY_POINTS)
    outs = [_lib_path(nm) for nm in names]
    jobs = []
    for nm, out in zip(names, outs):
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{nm}.cu")]
        jobs.append((nm, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failed = []
    for nm, out, tmp, proc in jobs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{nm}.cu:\n{err}")
            continue
        build_log[nm] = err
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def _load(name):
    with _lib_lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(build(name)[0]))
            for fns, argtypes in _ENTRY_POINTS[name]:
                for fn in fns:
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def _check_args(name, ins, shapes, dev, dt):
    for i, (t, shp) in enumerate(zip(ins, shapes)):
        if tuple(t.shape) != shp or t.dtype != dt or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: argument {i} is {tuple(t.shape)} {t.dtype} "
                f"on {t.device} (contiguous={t.is_contiguous()}); wanted "
                f"{shp} {dt} on {dev}, contiguous")


def _launch(name, dt, ins, outs, stop, *scalars, entry=0):
    lib = _load(name)
    fn = getattr(lib, _ENTRY_POINTS[name][entry][0][dt == torch.float64])
    in_ptrs = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
    out_ptrs = (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
    dev = outs[0].device
    stop = _stop_ptr(stop, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(in_ptrs, out_ptrs, stop, *scalars, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
    launches[name] += 1


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def fused_sweeps(q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x,
                 x, z, zx, y, yx, Ax, n_sweeps, n_refine, sigma, alpha,
                 stop=None):
    """Run ``n_sweeps`` fused ADMM sweeps; same arguments and result as
    :func:`fused_sweeps_plain`.  CUDA tensors launch the kernel in the mode
    of :func:`dense_layout` (or raise); CPU tensors run the plain
    version.  Where ``stop`` is set the kernel returns at once and the
    outputs are left unwritten."""
    if A.device.type == "cpu":
        return fused_sweeps_plain(q, A, Kinv, K, cl, cu, lb, ub, rho_a,
                                  rho_x, x, z, zx, y, yx, Ax, n_sweeps,
                                  n_refine, sigma, alpha, stop=stop)
    if A.device.type != "cuda":
        raise ValueError(f"fused_sweeps: unsupported device {A.device}")
    S, m, n = A.shape
    dt = A.dtype
    if not usable(S, m, n, dt):
        raise ValueError(f"fused_sweeps: shape (S={S}, m={m}, n={n}) in "
                         f"{dt} is not taken by the kernel")
    ins = (q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x, x, z, zx, y, yx, Ax)
    _check_args("fused_sweeps", ins,
                ((S, n), (S, m, n), (S, n, n), (S, n, n), (S, m), (S, m),
                 (S, n), (S, n), (S, m), (S, n), (S, n), (S, m), (S, n),
                 (S, m), (S, n), (S, m)), A.device, dt)
    lay = dense_layout(m, n, A.element_size())
    nsm = _sm_count(A.device)
    outs = tuple(torch.empty_like(t) for t in (x, z, zx, y, yx, Ax))
    mode, ptrs = 0, outs
    if lay["mode"] == "streamed":
        # its work vectors, min(S, nsm) blocks of them, where they do not
        # fit shared memory
        mode = 1
        ptrs += (torch.empty(max(1, min(S, nsm) * lay["scratch"]), dtype=dt,
                             device=A.device),)
    _launch("fused_sweeps", dt, ins, ptrs, stop, S, m, n, int(n_sweeps),
            int(n_refine), mode, nsm, float(sigma), float(alpha))
    dense_modes[lay["mode"]] += 1
    return outs


@functools.lru_cache(maxsize=64)
def _shared_clusters(dev, dt, m, n) -> int:
    """Clusters of the resident mode the card ``dev`` holds at once at this
    shape (``cudaOccupancyMaxActiveClusters`` for its C and shared
    memory)."""
    lay = shared_layout(m, n, 4 if dt == torch.float32 else 8, "resident")
    fn = getattr(_load("fused_sweeps_shared"),
                 _ENTRY_POINTS["fused_sweeps_shared"][2][0][
                     dt == torch.float64])
    out = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = fn(m, n, lay["C"], lay["ld"], lay["km"], lay["kn"],
                 ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"fused_sweeps_shared: the cluster occupancy "
                           f"query failed with error {err}")
    return out.value


def _shared_launch_layout(S, A, mode):
    """The layout ``fused_sweeps_shared`` launches in for ``S`` scenarios
    on this A: ``mode``'s, or :func:`shared_mode`'s choice; raises where
    the kernel does not take the shape."""
    (m, n), dt = A.shape, A.dtype
    isz = A.element_size()
    if mode is None and usable_shared(S, m, n, dt) is not None:
        res = shared_layout(m, n, isz, "resident")
        clusters = (_shared_clusters(A.device, dt, m, n)
                    if res is not None and res["C"] > 1 else 0)
        mode = shared_mode(S, m, n, isz, clusters)
    lay = shared_layout(m, n, isz, mode) \
        if mode and usable_shared(S, m, n, dt) else None
    if lay is None:
        raise ValueError(f"fused_sweeps_shared: shape (S={S}, m={m}, "
                         f"n={n}) in {dt} is not taken by the kernel"
                         + (f" in its {mode} mode" if mode else ""))
    return lay


def shared_plan(S, A, Kinv, K, mode=None):
    """``(mode, operand)``: the mode ``fused_sweeps_shared`` launches for
    ``S`` scenarios on these CUDA matrices and what it reads of them
    (:func:`shared_operand`), for a caller that passes both to every
    launch (a captured sweep loop, whose graph reads the operand from its
    buffers)."""
    lay = _shared_launch_layout(S, A, mode)
    return lay["mode"], shared_operand(A, Kinv, K, lay)


def fused_sweeps_shared(q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x, dq2,
                        has, gamma, x, z, zx, y, yx, Ax, n_sweeps, n_refine,
                        n_extra, sigma, alpha, precision="highest",
                        mode=None, stop=None, operand=None):
    """Run one ``n_sweeps`` block of the shared-A sweep; same arguments and
    result as :func:`fused_sweeps_shared_plain`.  CUDA tensors launch the
    kernel in the mode of :func:`shared_mode` (or raise); CPU tensors run
    the plain version.  ``mode`` ("resident" or "streamed") overrides that
    choice where the mode takes the shape, to hold or time one mode
    against the other.  ``operand``: what the kernel reads of A, K^-1 and
    K in that mode (:func:`shared_plan`), else made here.  Where ``stop``
    is set the kernel returns at once and the outputs are left
    unwritten."""
    _check_precision("fused_sweeps_shared", precision)
    if A.device.type == "cpu":
        return fused_sweeps_shared_plain(
            q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x, dq2, has, gamma,
            x, z, zx, y, yx, Ax, n_sweeps, n_refine, n_extra, sigma, alpha,
            stop=stop)
    if A.device.type != "cuda":
        raise ValueError(f"fused_sweeps_shared: unsupported device "
                         f"{A.device}")
    if A.ndim != 2 or q.ndim != 2:
        raise ValueError(f"fused_sweeps_shared: A must be (m, n) and q "
                         f"(S, n); got {tuple(A.shape)} and "
                         f"{tuple(q.shape)}")
    (m, n), S, dt = A.shape, q.shape[0], A.dtype
    lay = _shared_launch_layout(S, A, mode)
    if operand is None:
        operand = shared_operand(A, Kinv, K, lay)
    vecs = (cl, cu, lb, ub, rho_a, rho_x, dq2, has, gamma, x, z, zx, y, yx,
            Ax)
    vshapes = ((S, m), (S, m), (S, n), (S, n), (1, m), (1, n), (S, n),
               (1, 1), (S, 1), (S, n), (S, m), (S, n), (S, m), (S, n), (S, m))
    outs = tuple(torch.empty_like(t) for t in (x, z, zx, y, yx, Ax))
    fixed = (int(n_sweeps), int(n_refine), int(n_extra), float(sigma),
             float(alpha))
    if lay["mode"] == "resident":
        ins = (q, operand) + vecs
        _check_args("fused_sweeps_shared", ins,
                    ((S, n), (lay["C"], lay["reg"])) + vshapes, A.device, dt)
        _launch("fused_sweeps_shared", dt, ins, outs, stop, S, m, n,
                lay["C"], lay["ld"], lay["km"], lay["kn"], *fixed, entry=1)
    else:
        ins = (q, A, operand, Kinv, K) + vecs
        _check_args("fused_sweeps_shared", ins,
                    ((S, n), (m, n), (n, m), (n, n), (n, n)) + vshapes,
                    A.device, dt)
        _launch("fused_sweeps_shared", dt, ins, outs, stop, S, m, n,
                lay["sb"], lay["chunk"], *fixed)
    shared_modes[lay["mode"]] += 1
    return outs


def fused_sweeps_sparse(q, rowcols, rowvals, colrows, colvals, Kinv, diagK,
                        cl, cu, lb, ub, rho_a, rho_x, dq2, has, gamma, x, z,
                        zx, y, yx, Ax, n_sweeps, n_refine, n_extra, sigma,
                        alpha, precision="highest", ell_t=None, stop=None):
    """Run one ``n_sweeps`` block of the sparse shared-A sweep; same
    arguments and result as :func:`fused_sweeps_sparse_plain`.  CUDA
    tensors launch the kernel in the mode of ``Kinv`` (a dense (n, n)
    tensor, or a :class:`~.structured_kkt.KernelWoodbury`) or raise; CPU
    tensors run the plain version.  ``ell_t`` is :func:`ell_slot_major` of
    the ELL arrays, which the kernel reads; a caller that launches many
    blocks against one A passes it, else it is made here.  Where ``stop``
    is set the kernel returns at once and the outputs are left
    unwritten."""
    _check_precision("fused_sweeps_sparse", precision)
    if Kinv.device.type == "cpu":
        return fused_sweeps_sparse_plain(
            q, rowcols, rowvals, colrows, colvals, Kinv, diagK, cl, cu, lb,
            ub, rho_a, rho_x, dq2, has, gamma, x, z, zx, y, yx, Ax, n_sweeps,
            n_refine, n_extra, sigma, alpha, stop=stop)
    if Kinv.device.type != "cuda":
        raise ValueError(f"fused_sweeps_sparse: unsupported device "
                         f"{Kinv.device}")
    if q.ndim != 2 or rowcols.ndim != 2 or colrows.ndim != 2:
        raise ValueError(f"fused_sweeps_sparse: q must be (S, n) and the "
                         f"ELL arrays 2-D; got {tuple(q.shape)}, "
                         f"{tuple(rowcols.shape)}, {tuple(colrows.shape)}")
    (S, n), (m, kr), kc = q.shape, rowcols.shape, colrows.shape[1]
    dt = Kinv.dtype
    wb = Kinv if isinstance(Kinv, KernelWoodbury) else None
    sb = usable_sparse(S, m, n, kr, kc, dt, wb)
    if sb is None:
        raise ValueError(f"fused_sweeps_sparse: shape (S={S}, m={m}, n={n}, "
                         f"kr={kr}, kc={kc}) in {dt} is not taken by the "
                         f"kernel" + (" with this structured operand"
                                      if wb is not None else ""))
    dev = Kinv.device
    # the kernel reads K^-1 rows in 16-byte vector loads, and copies the
    # structured operand's panels in 16-byte-aligned bulk copies
    mats = Kinv if wb is None else wb.mats
    if mats.data_ptr() % 16:
        mats = mats.clone()
    if ell_t is None:
        ell_t = ell_slot_major((rowcols, rowvals, colrows, colvals))
    rc_t, rv_t, cr_t, cv_t = ell_t
    _check_args("fused_sweeps_sparse", (rc_t, cr_t), ((kr, m), (kc, n)),
                dev, torch.int32)
    ins = (q, rc_t, rv_t, cr_t, cv_t, mats, diagK, cl, cu, lb, ub, rho_a,
           rho_x, dq2, has, gamma, x, z, zx, y, yx, Ax)
    shapes = ((S, n), (kr, m), (kr, m), (kc, n), (kc, n),
              (n, n) if wb is None else tuple(mats.shape), (1, n),
              (S, m), (S, m), (S, n), (S, n), (1, m), (1, n), (S, n), (1, 1),
              (S, 1), (S, n), (S, m), (S, n), (S, m), (S, n), (S, m))
    floats = [i for i in range(len(ins)) if i not in (1, 3)]
    _check_args("fused_sweeps_sparse", [ins[i] for i in floats],
                [shapes[i] for i in floats], dev, dt)
    outs = tuple(torch.empty_like(t) for t in (x, z, zx, y, yx, Ax))
    # per-tile device-memory scratch: the rhs (n, sb) and an m-vector
    # (m, sb) of each tile, scenario values side by side; in the structured
    # mode also the K^-1 input and the Woodbury correction (n, sb each), by
    # position
    tiles = -(-S // sb)
    scratch = (torch.empty(tiles * sb * n, dtype=dt, device=dev),
               torch.empty(max(1, tiles * sb * m), dtype=dt, device=dev))
    fixed = (S, m, n, kr, kc, sb, int(n_sweeps), int(n_refine), int(n_extra),
             float(sigma), float(alpha))
    if wb is None:
        _launch("fused_sweeps_sparse", dt, ins, outs + scratch, stop, *fixed)
        sparse_modes["dense"] += 1
        return outs
    pat = wb.pattern
    items = pat.items[4 if dt == torch.float32 else 8]
    lay = (pat.pos, pat.order, items, pat.binfo_t, wb.dinv, pat.wcols,
           wb.wvals, pat.wpos, pat.wtrows, wb.wtvals, pat.ncols, wb.nvals,
           pat.wrows)
    kw, r = pat.wcols.shape
    kwc = pat.wtrows.shape[0]
    shapes = ((n,), (n,), tuple(items.shape), (pat.nb + 1, 4),
              (n - pat.pd,), (kw, r), (kw, r), (kw, r), (kwc, n), (kwc, n),
              (pat.kn, m), (pat.kn, m), (r,))
    vals = (4, 6, 9, 11)
    for want, idx in ((dt, vals), (torch.int32, [i for i in range(len(lay))
                                                 if i not in vals])):
        _check_args("fused_sweeps_sparse", [lay[i] for i in idx],
                    [shapes[i] for i in idx], dev, want)
    scratch += tuple(torch.empty(tiles * sb * n, dtype=dt, device=dev)
                     for _ in range(2))
    _launch("fused_sweeps_sparse", dt, ins + lay, outs + scratch, stop,
            *fixed, r, pat.kn, kw, kwc, pat.nb, items.shape[0], pat.pd,
            pat.stage_elems[4 if dt == torch.float32 else 8], pat.bmax,
            entry=1)
    sparse_modes["structured"] += 1
    return outs
