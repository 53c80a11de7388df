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
(:func:`counts`, :func:`add_counts`, used by :mod:`.device_loop`).  Each
count is kept process-wide (the module's tables) and in a view of the
calling thread (``counts(local=True)``), so the cylinders of a wheel, each
on a thread of its own, read their own launches.

Cylinders launch the kernels concurrently, each from its own CUDA stream
(every wrapper launches on the current stream).  What the wrappers keep
between calls belongs to an *owner* (:func:`owned_by`; by default the
calling thread): the operand made of a set of matrices (:func:`_cached`) is
kept per owner, and :mod:`.device_loop` keys its captured loops by owner,
so no two cylinders share buffers, graphs or operands.

Every wrapper and plain version takes ``precision``, a mode of
:mod:`.precision` (an unknown one raises ``ValueError``), at which the
kernel runs the TPU kernel's lowered branch: ``fused_sweeps`` at "default"
stores A and K^-1 in bf16 and rounds the vector operand of its A', K^-1 and
A products to bf16, the K defect exact (its "high" is the exact path, as on
the TPU: the per-scenario products have no passes to save);
``fused_sweeps_shared`` and ``fused_sweeps_sparse`` take each K^-1 product
(and the shared kernel its A and A' products) as the bf16 expansion of
``pallas_kernels._pdot`` ("default" one bf16 product, "high" three), the
K defect, the ELL products and the matrix-free defect exact.  What a
kernel reads of its matrices at a lowered mode is made once per set of
matrices and handed to the captured loop like the shared operand
(:func:`dense_operand`, :func:`shared_operand`, :func:`sparse_operand`);
the structured operand carries its lowered copies
(:func:`~.structured_kkt.lowered_layout`, made by the shared engine's
core once a solve).

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

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from .precision import bf16_parts, bf16_round, canon
from .sparse import SparseA, ell_matvec, ell_slot_major
from .structured_kkt import (KernelWoodbury, kinv_apply,
                             narrow_wide_matvec)

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
#: Launches at a lowered precision, by kernel and mode ("kernel:mode"); a
#: launch at "highest" (and ``fused_sweeps`` at "high", its exact path) is
#: counted nowhere here.
lowered_launches = {"fused_sweeps:default": 0, "fused_sweeps_shared:default": 0,
                    "fused_sweeps_shared:high": 0,
                    "fused_sweeps_sparse:default": 0,
                    "fused_sweeps_sparse:high": 0}
_COUNTS = {"launches": launches, "plain_calls": plain_calls,
           "sparse_modes": sparse_modes, "shared_modes": shared_modes,
           "dense_modes": dense_modes, "lowered_launches": lowered_launches}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
#: Exported C entry points of each source (f32, f64), with their ctypes
#: argument types.
_ENTRY_POINTS = {
    # (in ptrs, out ptrs, stop, S, m, n, n_sweeps, n_refine, mode, nsm,
    #  prec, sigma, alpha, stream)
    "fused_sweeps": [(("tpusppy_fused_sweeps_f32",
                       "tpusppy_fused_sweeps_f64"),
                      [_P, _P, _P] + [_I] * 8 + [_D, _D, _P])],
    "fused_sweeps_shared": [
        # streamed: (in ptrs, out ptrs, stop, S, m, n, sb, chunk, n_sweeps,
        # n_refine, n_extra, prec, sigma, alpha, stream)
        (("tpusppy_fused_sweeps_shared_f32",
          "tpusppy_fused_sweeps_shared_f64"),
         [_P, _P, _P] + [_I] * 9 + [_D, _D, _P]),
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
        # n_sweeps, n_refine, n_extra, prec, sigma, alpha, stream)
        (("tpusppy_fused_sweeps_sparse_f32",
          "tpusppy_fused_sweeps_sparse_f64"),
         [_P, _P, _P] + [_I] * 10 + [_D, _D, _P]),
        # structured: the same, then r, kn, kw, kwc, nb, items, pd,
        # stage_bytes, bmax before the stream
        (("tpusppy_fused_sweeps_sparse_wb_f32",
          "tpusppy_fused_sweeps_sparse_wb_f64"),
         [_P, _P, _P] + [_I] * 10 + [_D, _D] + [_I] * 9 + [_P])],
}

_libs: dict = {}
_lib_lock = threading.Lock()
#: The compiler's resource report (``-Xptxas -v``) of each built source.
build_log: dict = {}


_count_lock = threading.Lock()
_local = threading.local()
#: Every thread's view of the counts, by thread ident.
_views: dict = {}


def _view() -> dict:
    """The calling thread's count tables (made on first use)."""
    v = getattr(_local, "counts", None)
    if v is None:
        v = _local.counts = {t: dict.fromkeys(d, 0)
                             for t, d in _COUNTS.items()}
        with _count_lock:
            _views[threading.get_ident()] = v
    return v


def bump(table, key, n=1):
    """Count ``n`` in ``table`` (a name of :data:`_COUNTS`) under ``key``,
    process-wide and in the calling thread's view."""
    view = _view()
    with _count_lock:
        _COUNTS[table][key] += n
        view[table][key] += n


def reset_counts():
    """Zero every count, process-wide and in every thread's view."""
    with _count_lock:
        for tables in (_COUNTS, *_views.values()):
            for d in tables.values():
                for k in d:
                    d[k] = 0


def counts(local=False) -> dict:
    """Every launch and plain-call count, flat: ``{(table, key): n}``;
    ``local``: the calling thread's view."""
    tables = _view() if local else _COUNTS
    with _count_lock:
        return {(t, k): v for t, d in tables.items() for k, v in d.items()}


def add_counts(delta: dict):
    """Add a :func:`counts`-shaped delta (what one CUDA-graph replay
    launches) to the counts and to the calling thread's view."""
    view = _view()
    with _count_lock:
        for (t, k), v in delta.items():
            _COUNTS[t][k] += v
            view[t][k] += v


def current_owner():
    """The owner of what the wrappers and the sweep loop keep between
    calls: the token of the innermost :func:`owned_by`, else the calling
    thread."""
    tok = getattr(_local, "owner", None)
    return ("thread", threading.get_ident()) if tok is None else tok


@contextlib.contextmanager
def owned_by(token):
    """Run the body as ``token``'s (any hashable; a wheel passes each
    cylinder's opt object): its operands and captured loops are its own.
    :func:`.device_loop.release` frees them."""
    prev = getattr(_local, "owner", None)
    _local.owner = token
    try:
        yield
    finally:
        _local.owner = prev


def _gate(stop, ins, outs):
    """The plain versions' side of the stop flag: each output where
    ``stop`` is clear, its input where it is set (on the device, with no
    host read)."""
    if stop is None:
        return tuple(outs)
    stopped = stop.reshape(()) != 0
    return tuple(torch.where(stopped, i, o) for i, o in zip(ins, outs))


#: A clear stop flag per device and stream, for wrappers called without
#: one (made and first read on the same stream).
_CLEAR: dict = {}


def _stop_ptr(stop, dev):
    """The stop flag's device pointer, checked: a one-element int32 tensor
    on the kernel's device (a clear one where ``stop`` is None)."""
    if stop is None:
        key = (dev, torch.cuda.current_stream(dev).cuda_stream)
        stop = _CLEAR.get(key)
        if stop is None:
            stop = _CLEAR.setdefault(
                key, torch.zeros(1, dtype=torch.int32, device=dev))
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
def dense_layout(m, n, itemsize, lowered=False) -> dict:
    """Mode and shared memory of one ``fused_sweeps`` block (mirrors
    ``ResLayout`` and ``StreamLayout`` in the CUDA source).

    Resident when two scenario buffers fit beside the two mbarriers, the
    slots' offsets and the work vectors (rhs, xt, r of n and v of m): each
    buffer holds a scenario's 16 arrays, each
    in a slot 16 bytes longer than its 16-byte-rounded size (the span a
    bulk copy brings in may start up to 15 bytes early); ``lowered`` (the
    "default" mode) holds A and K^-1 in bf16, 2 bytes an entry.  Otherwise
    streamed: two stage buffers of ``_STAGE_BYTES`` (+32) for the matrix
    panels, and the work vectors (rhs, xt, r, t and v) in shared memory
    where they fit (``vec_smem``), else ``scratch`` values a block in
    device memory.  Cached per shape: the wrapper asks at every launch,
    so callers must not change the dict."""
    sizes = [2 if lowered and a < 2 else itemsize for a in range(16)]
    slots = [_r16(L * isz) + 16
             for L, isz in zip(_dense_array_lens(m, n), sizes)]
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


def _dense_lowered(precision) -> bool:
    """Whether ``fused_sweeps`` runs lowered at ``precision``: "default"
    only (its "high" is the exact path, as the TPU kernel's)."""
    return canon(precision) == "default"


def _prec_code(precision) -> int:
    """A mode as the kernels' ``prec`` argument: 0 exact, 1 "default",
    2 "high"."""
    return {"highest": 0, "default": 1, "high": 2}[canon(precision)]


#: The last operand each maker made for each owner, by (owner, name):
#: (its tensors, their versions, the key, the operand); holding the tensors
#: keeps their identity unique.
_operand_cache: dict = {}
_operand_lock = threading.Lock()


def _cached(name, tensors, key, make):
    """``make()``, the operand a kernel reads of ``tensors``, kept and
    handed out again while the same tensors, none written since (their
    version counters), ask with the same ``key``; one kept per ``name``,
    owner (:func:`current_owner`) and shape of the first tensor, so
    cylinders that alternate, or the buckets of one owner's bucketed
    window, do not repack each other's.  Refused inside a CUDA-graph capture: a captured
    loop makes its operand before the capture and hands it to the
    wrapper."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            f"{name} inside a CUDA-graph capture takes the operand made "
            "before it")
    slot = (current_owner(), name, tuple(tensors[0].shape))
    versions = tuple(_version(t) for t in tensors)
    with _operand_lock:
        hit = _operand_cache.get(slot)
    if hit is not None and None not in versions:
        ts, ver, k, op = hit
        if k == key and ver == versions and all(
                a is b for a, b in zip(ts, tensors)):
            return op
    op = make()
    with _operand_lock:
        _operand_cache[slot] = (tuple(tensors), versions, key, op)
    return op


def release_operands(token):
    """Drop every operand kept for the owner ``token``."""
    with _operand_lock:
        for slot in [k for k in _operand_cache if k[0] == token]:
            del _operand_cache[slot]


def dense_operand(A, Kinv, precision="default"):
    """What ``fused_sweeps`` reads of A (S, m, n) and K^-1 (S, n, n) at
    ``precision``: None at an exact mode, else ``(A1, Kinv1)``, their bf16
    roundings (through float32, as the TPU caller casts them), made once
    for each set of matrices (:func:`_cached`); a captured loop makes it
    before the capture and hands it to every launch."""
    if not _dense_lowered(precision):
        return None
    return _cached("dense", (A, Kinv), "default", lambda: (
        A.float().to(torch.bfloat16).contiguous(),
        Kinv.float().to(torch.bfloat16).contiguous()))


def fused_sweeps_plain(q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x,
                       x, z, zx, y, yx, Ax, n_sweeps, n_refine, sigma,
                       alpha, precision="highest", operand=None, stop=None):
    """The sweep recurrence of ``admm._admm_core`` in batched tensor form
    (``tests/test_pallas.py:_xla_sweeps`` in PyTorch).  Natural layout:
    A (S, m, n), Kinv/K (S, n, n), vectors (S, n) or (S, m).  Returns
    ``(x, z, zx, y, yx, Ax)`` after ``n_sweeps`` sweeps with the incremental
    Ax carry, or the inputs where ``stop`` is set.

    At ``precision`` "default" it is ``pallas_kernels._sweeps_kernel``'s
    lowered branch: A and K^-1 taken from their bf16 roundings (``operand``,
    else :func:`dense_operand`) and the vector operand of each A', K^-1 and
    A product rounded to bf16 (through float32), the products and sums in
    the working dtype, the defect ``rhs - K xt`` exact; "high" is the exact
    path, as the TPU kernel's."""
    lowered = _dense_lowered(precision)
    bump("plain_calls", "fused_sweeps")
    state_in = (x, z, zx, y, yx, Ax)
    dt = A.dtype
    Km = Kinv
    rnd = (lambda v: v)
    if lowered:
        A1, K1 = operand if operand is not None else dense_operand(
            A, Kinv, precision)
        A, Km, rnd = A1.to(dt), K1.to(dt), bf16_round
    # column vectors (S, k, 1) so every matvec is one bmm
    q, cl, cu, lb, ub, rho_a, rho_x, x, z, zx, y, yx, Ax = (
        t.unsqueeze(-1) for t in (q, cl, cu, lb, ub, rho_a, rho_x, x, z, zx,
                                  y, yx, Ax))
    At = A.transpose(1, 2)
    # Python scalars, not device tensors: a tensor made from a host value
    # is a blocking copy on CUDA
    sigma, alpha, beta = float(sigma), float(alpha), 1.0 - float(alpha)
    for _ in range(n_sweeps):
        rhs = sigma * x - q + torch.bmm(At, rnd(rho_a * z - y)) + (
            rho_x * zx - yx)
        xt = torch.bmm(Km, rnd(rhs))
        for _ in range(n_refine):
            r = rhs - torch.bmm(K, xt)
            xt = xt + torch.bmm(Km, rnd(r))
        Axt = alpha * torch.bmm(A, rnd(xt))
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


def _streamed_layout(m, n, itemsize, lowered=False):
    """``(sb, chunk)`` of one streamed block, or None: it keeps, for its
    ``sb`` scenarios, their gammas, the rhs, K^-1 input and x-tilde
    n-vectors, one ``chunk``-row slice of the A' input and one partial sum
    per thread; A, K^-1 and K stream from device memory and L2.  The
    largest tile whose buffers fit with a chunk of at least ``min(m, 32)``
    rows wins, and the chunk then takes the rest of the budget, up to all
    m.  ``lowered`` (a bf16 mode) keeps each product's operand as its two
    bf16 parts: one more n-vector, and two chunk rows a row; its kernels
    are built for tiles of 8, 4 and 2 only."""
    for sb in SHARED_TILES[:3] if lowered else SHARED_TILES:
        cap = SMEM_LIMIT // (itemsize * sb) - 1 - 3 * n - _SHARED_THREADS
        if lowered:
            cap = (cap - n) // 2
        if cap >= max(1, min(m, _MIN_CHUNK)):
            return sb, max(1, min(m, cap))
    return None


def shared_smem_bytes(m, n, itemsize, sb, chunk, lowered=False, parts=1):
    """``(bytes, resident)``: shared memory of one streamed block, which
    also holds K^-1 (``resident`` 1) and then K (3) where they still fit;
    the rest stream from L2 (mirrors ``launch_tile`` in the CUDA
    source).  ``lowered``: the bf16 modes' buffers (:func:`_streamed_layout`)
    and K^-1 as its ``parts`` bf16 parts, 2 bytes an entry each."""
    if lowered:
        smem = sb * (1 + 4 * n + 2 * chunk + _SHARED_THREADS) * itemsize
        kinv = 2 * parts * n * n
    else:
        smem = sb * (1 + 3 * n + chunk + _SHARED_THREADS) * itemsize
        kinv = n * n * itemsize
    resident = 0
    for bit, mat in ((1, kinv), (2, n * n * itemsize)):
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
def shared_layout(m, n, itemsize, mode=None,
                  precision="highest") -> dict | None:
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
    Which of the two a launch runs is :func:`shared_mode`'s choice.  At a
    lowered ``precision`` ("default" or "high") only the streamed mode
    takes the shape, with the bf16 buffers of :func:`_streamed_layout`, and
    the layout carries ``precision``.  Cached per shape: the wrapper asks
    at every launch, so callers must not change the dict."""
    prec = canon(precision)
    if n < 1 or m < 0 or itemsize not in (4, 8) \
            or mode not in (None, "resident", "streamed"):
        return None
    if prec != "highest":
        lay = _streamed_layout(m, n, itemsize, lowered=True)
        if lay is None or mode == "resident":
            return None
        smem, resident = shared_smem_bytes(
            m, n, itemsize, *lay, lowered=True,
            parts=2 if prec == "high" else 1)
        return {"mode": "streamed", "sb": lay[0], "chunk": lay[1],
                "smem": smem, "resident": resident, "precision": prec}
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


def shared_mode(S, m, n, itemsize, clusters,
                precision="highest") -> str | None:
    """The mode ``fused_sweeps_shared`` launches for ``S`` scenarios:
    cluster-resident where its layout exists and either fits one CTA
    (C = 1) or every tile of the batch has a cluster at once (``ceil(S /
    RESIDENT_TILE) <= clusters``, the clusters of its C the card holds
    together), or where the streamed mode does not take the shape;
    streamed otherwise; None where neither mode takes it.  A lowered
    ``precision`` goes to the streamed mode, the one that runs it.

    With C = 1 the resident mode loads the matrices once a CTA, not once a
    tile, and pays no cluster costs.  With C >= 2 it spreads one tile over
    C SMs and pays a cluster barrier for each of its products, where the
    streamed mode gives a tile one SM: it wins while the streamed mode
    would leave SMs idle, and loses once its tiles queue for a second
    round of clusters.  Both from the crossover of
    ``scripts/port_shared_ablation.py`` on an H100 (PERF.md)."""
    if canon(precision) != "highest":
        lay = shared_layout(m, n, itemsize, "streamed", canon(precision))
        return None if lay is None else "streamed"
    res = shared_layout(m, n, itemsize, "resident")
    streamed = shared_layout(m, n, itemsize, "streamed")
    if res is not None and (streamed is None or res["C"] == 1
                            or -(-S // RESIDENT_TILE) <= clusters):
        return "resident"
    return None if streamed is None else "streamed"


def usable_shared(S, m, n, dtype, precision="highest") -> int | None:
    """Scenarios per tile if ``fused_sweeps_shared`` takes this shape, else
    None.  Mirrors ``pallas_kernels.usable_shared`` sized to Hopper: the
    resident mode takes the matrices that fit across a cluster of up to 8
    CTAs, and the streamed mode reads them from L2, so only a block's
    scenario vectors limit the shape (n up to ~9,600 in f64), which covers
    every shape the TPU kernel's 1.5 MB matrix budget admits.  A lowered
    ``precision`` asks the streamed mode's bf16 layout."""
    if dtype not in (torch.float32, torch.float64) or S < 1:
        return None
    lay = shared_layout(m, n, 4 if dtype == torch.float32 else 8, None,
                        canon(precision))
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


def shared_operand(A, Kinv, K, lay):
    """What ``fused_sweeps_shared`` in ``lay``'s mode reads of the shared
    matrices: the packed slices in the resident mode (:func:`shared_pack`),
    A' contiguous in the streamed mode (it reads A along rows for A'v and
    along columns, as A', for A xt), and at a lowered ``lay["precision"]``
    the bf16 parts of A, A' and K^-1 (:func:`shared_lowered`).  Made once
    for each set of matrices and layout (:func:`_cached`), so a solve's
    blocks make it once and a new factorization makes it anew.  Not inside
    a CUDA-graph capture, which would keep the operand made there and
    sweep it after new matrices were copied into the graph's buffers: a
    captured loop makes its operand before the capture
    (:func:`shared_plan`) and hands it to the wrapper as an input."""
    key = (lay["mode"], lay.get("precision", "highest"))

    def make():
        if key[1] != "highest":
            return shared_lowered(A, Kinv, key[1])
        if lay["mode"] == "resident":
            return shared_pack(A, Kinv, K, lay)
        return A.T.contiguous()

    return _cached("fused_sweeps_shared", (A, Kinv, K), key, make)


def shared_lowered(A, Kinv, precision):
    """The streamed mode's operand at a lowered ``precision``: (P, 2 m n +
    n n) bf16, row p holding part p of A (m, n), of A' (n, m) and of K^-1
    (n, n), each row-major (P = 1 at "default", 2 at "high": the bf16
    expansion of ``pallas_kernels._prep_mat``, through float32)."""
    out = []
    for M in (A, A.T, Kinv):
        p1, p2 = bf16_parts(M.contiguous(), precision)
        out.append([p.reshape(-1) for p in (p1, p2) if p is not None])
    return torch.stack([torch.cat(row) for row in zip(*out)])


def _pdot(u, parts, precision, transpose=False, spec=None):
    """``u @ M`` (``u @ M.T``, or ``torch.einsum(spec, u, M)``) at
    ``precision`` with M given as its ``parts``
    (:func:`~.precision.bf16_parts`, or ``(M, None)`` exact): u split at
    every call, the bf16 products exact and summed in u's dtype
    (``pallas_kernels._pdot``'s ``preferred_element_type=dt``)."""
    dt = u.dtype
    M1, M2 = parts
    if transpose:
        M1 = M1.T
        M2 = None if M2 is None else M2.T

    def dot(a, b):
        return a @ b if spec is None else torch.einsum(spec, a, b)

    if canon(precision) == "highest":
        return dot(u, M1)
    u1, u2 = bf16_parts(u, precision)
    out = dot(u1.to(dt), M1.to(dt))
    if M2 is None:
        return out
    return out + dot(u1.to(dt), M2.to(dt)) + dot(u2.to(dt), M1.to(dt))


def _parts(M, precision):
    return (M, None) if canon(precision) == "highest" \
        else bf16_parts(M, precision)


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
    ``(x, z, zx, y, yx, Ax)``, or the inputs where ``stop`` is set.

    At a lowered ``precision`` the A', K^-1 and A products are
    ``pallas_kernels._pdot``'s (:func:`_pdot`: A and K^-1 split once a
    call through float32, the operand at every product, the products summed
    in the working dtype); the defect against K stays exact."""
    prec = canon(precision)
    bump("plain_calls", "fused_sweeps_shared")
    state_in = (x, z, zx, y, yx, Ax)
    g = gamma
    sigma, alpha, beta = float(sigma), float(alpha), 1.0 - float(alpha)
    sigma_s = g * sigma
    rho_a_s = g * rho_a
    rho_x_s = g * rho_x
    extra = has > 0
    Ap, Kp = _parts(A, prec), _parts(Kinv, prec)

    def refine(xt, rhs):
        return xt + _pdot((rhs - (g * (xt @ K) + dq2 * xt)) / g, Kp, prec)

    for _ in range(n_sweeps):
        rhs = (sigma_s * x - q + _pdot(rho_a_s * z - y, Ap, prec)) + (
            rho_x_s * zx - yx)
        xt = _pdot(rhs / g, Kp, prec)
        for _ in range(n_refine):
            xt = refine(xt, rhs)
        for _ in range(n_extra):
            xt = torch.where(extra, refine(xt, rhs), xt)
        Axt = alpha * _pdot(xt, Ap, prec, transpose=True)
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


def _wb_stage(kinv, itemsize, precision="highest"):
    """``(items, stage_bytes)`` of the structured operand's panel
    pipeline: the panels cut for ``itemsize`` at "highest"; at a lowered
    mode the panels of 4-byte entries, holding bf16 entries ("default", 2
    bytes) or bf16 pairs ("high", 4 bytes)."""
    pat = kinv.pattern
    prec = canon(precision)
    if prec == "highest":
        return pat.items[itemsize], pat.stage_elems[itemsize] * itemsize
    return pat.items[4], pat.stage_elems[4] * (2 if prec == "default" else 4)


def sparse_smem_bytes(n, itemsize, sb, kinv=None,
                      precision="highest") -> int:
    """Shared memory of one ``fused_sweeps_sparse`` block of ``sb``
    scenarios (mirrors ``smem_bytes`` in the CUDA source).  With a dense
    K^-1: their gammas, the K^-1 input and x-tilde n-vectors, and one
    split-k partial sum per thread; at a lowered ``precision`` the K^-1
    input as its two bf16 parts (one more n-vector).  With the structured
    operand ``kinv`` (a :class:`~.structured_kkt.KernelWoodbury`): two
    mbarriers, the gammas and x-tilde, two staging buffers of the largest
    panel (:func:`_wb_stage`), the partial sums of a block product
    (``max(threads, bmax)`` columns), and four ``bmax``-row tile vectors
    (two of a block's input, u and v of the Woodbury cap), each region
    16-byte aligned, and at a lowered ``precision`` three more (the second
    bf16 part of a block's input, two buffers, and of u); the K^-1 input
    and the Woodbury correction then live in device-memory scratch.  The
    rhs and the m-vectors always do."""
    low = canon(precision) != "highest"
    if kinv is None:
        return itemsize * sb * (1 + (3 if low else 2) * n + _SPARSE_THREADS)
    pat = kinv.pattern
    _, stage = _wb_stage(kinv, itemsize, precision)
    return (16 + _r16(itemsize * sb) + _r16(itemsize * sb * n)
            + 2 * _r16(stage)
            + _r16(itemsize * sb * max(_SPARSE_THREADS, pat.bmax))
            + (7 if low else 4) * _r16(itemsize * sb * pat.bmax))


def usable_sparse(S, m, n, kr, kc, dtype, kinv=None,
                  precision="highest") -> int | None:
    """Scenarios per block if ``fused_sweeps_sparse`` takes this shape, else
    None.  Mirrors ``pallas_kernels.usable_sparse`` sized to Hopper: K^-1
    and the ELL arrays stream from device memory and L2, so only a block's
    two n-vectors per scenario limit the shape (n up to ~14,000 in f64,
    ~28,000 in f32, one scenario a block).  kr and kc are run-time loop
    bounds, so there is no slot cap (the TPU kernel unrolls them and stops
    at 64); the ELL arrays must only stay within 32-bit offsets.  With the
    structured operand ``kinv`` one n-vector a scenario stays in shared
    memory beside the staged panels (n up to ~38,000 in f32 and ~18,000 in
    f64 at uc's panels, one scenario a block), and no stored block may be
    wider than the threads of a block (each thread takes one column of a
    block product).  A lowered ``precision`` asks its layout
    (:func:`sparse_smem_bytes`), in tiles of 8, 4 or 2 scenarios."""
    if dtype not in (torch.float32, torch.float64) or S < 1 or n < 1 \
            or m < 0 or kr < 1 or kc < 1:
        return None
    if m * kr > _INT_MAX or n * kc > _INT_MAX:
        return None
    pairs = 2 if canon(precision) == "high" else 1
    if kinv is not None and (kinv.pattern.bmax > _SPARSE_THREADS
                             or pairs * kinv.mats.numel() > _INT_MAX):
        return None
    itemsize = 4 if dtype == torch.float32 else 8
    # the lowered modes' kernels are built for tiles of 8, 4 and 2 only
    for sb in SPARSE_TILES if canon(precision) == "highest" \
            else SPARSE_TILES[:3]:
        if sparse_smem_bytes(n, itemsize, sb, kinv,
                             precision) <= SMEM_LIMIT:
            return sb
    return None


def sparse_operand(Kinv, precision):
    """What ``fused_sweeps_sparse`` reads of a dense (n, n) K^-1 at a
    lowered ``precision``: its bf16 parts stacked, (P, n, n) bf16 (P = 1 at
    "default", 2 at "high"); None at "highest".  Made once for each K^-1
    (:func:`_cached`); a captured loop makes it before the capture.  The
    structured operand carries its lowered copies itself
    (:func:`~.structured_kkt.lowered_layout`)."""
    prec = canon(precision)
    if prec == "highest":
        return None
    return _cached("sparse", (Kinv,), prec, lambda: torch.stack(
        [p for p in bf16_parts(Kinv, prec) if p is not None]))


def _kernel_dot(spec, u, M, precision):
    """One contraction of the structured K^-1 apply as the kernel makes
    it: :func:`_pdot` on M's parts, the bf16 products summed in the
    working dtype (where ``precision.contract`` sums them in float32)."""
    return _pdot(u, _parts(M, precision), precision, spec=spec)


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
    ``(x, z, zx, y, yx, Ax)``, or the inputs where ``stop`` is set.

    At a lowered ``precision`` only the K^-1 applies are lowered, each
    product as ``pallas_kernels._pdot`` makes it (:func:`_pdot`: the bf16
    products summed in the working dtype): a dense K^-1, or the structured
    operand through ``kinv_apply(bw, v, precision)`` with its block,
    one-variable and Woodbury contractions lowered so (the reference's XLA
    sweep sums them in float32; in float32 the two agree) and the final
    ``t - B^-1 w`` exact; the ELL products and the matrix-free defect stay
    exact."""
    prec = canon(precision)
    bump("plain_calls", "fused_sweeps_sparse")
    state_in = (x, z, zx, y, yx, Ax)
    rc_t, rv_t, cr_t, cv_t = ell_slot_major((rowcols, rowvals, colrows,
                                             colvals))
    if isinstance(Kinv, KernelWoodbury):
        def kinv(v):
            return kinv_apply(Kinv.bw, v, prec, _kernel_dot)

        def mv(v):
            return narrow_wide_matvec(Kinv, v)
    else:
        Kp = _parts(Kinv, prec)

        def kinv(v):
            return _pdot(v, Kp, prec)

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
    bump("launches", name)


@functools.lru_cache(maxsize=None)
def _sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def fused_sweeps(q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x,
                 x, z, zx, y, yx, Ax, n_sweeps, n_refine, sigma, alpha,
                 precision="highest", operand=None, stop=None):
    """Run ``n_sweeps`` fused ADMM sweeps; same arguments and result as
    :func:`fused_sweeps_plain`.  CUDA tensors launch the kernel in the mode
    of :func:`dense_layout` (or raise); CPU tensors run the plain
    version.  At "default" the kernel reads ``operand`` (:func:
    `dense_operand`, made here if not given).  Where ``stop`` is set the
    kernel returns at once and the outputs are left unwritten."""
    lowered = _dense_lowered(precision)
    if A.device.type == "cpu":
        return fused_sweeps_plain(q, A, Kinv, K, cl, cu, lb, ub, rho_a,
                                  rho_x, x, z, zx, y, yx, Ax, n_sweeps,
                                  n_refine, sigma, alpha, precision,
                                  operand=operand, stop=stop)
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
    if lowered:
        if operand is None:
            operand = dense_operand(A, Kinv, precision)
        _check_args("fused_sweeps", operand, ((S, m, n), (S, n, n)),
                    A.device, torch.bfloat16)
        ins = (q,) + tuple(operand) + ins[3:]
    lay = dense_layout(m, n, A.element_size(), lowered)
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
            int(n_refine), mode, nsm, int(lowered), float(sigma),
            float(alpha))
    bump("dense_modes", lay["mode"])
    if lowered:
        bump("lowered_launches", "fused_sweeps:default")
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


def _shared_launch_layout(S, A, mode, precision="highest"):
    """The layout ``fused_sweeps_shared`` launches in for ``S`` scenarios
    on this A at ``precision``: ``mode``'s, or :func:`shared_mode`'s
    choice; raises where the kernel does not take the shape."""
    (m, n), dt = A.shape, A.dtype
    isz = A.element_size()
    prec = canon(precision)
    if mode is None and usable_shared(S, m, n, dt, prec) is not None:
        res = shared_layout(m, n, isz, "resident")
        clusters = (_shared_clusters(A.device, dt, m, n)
                    if prec == "highest" and res is not None and res["C"] > 1
                    else 0)
        mode = shared_mode(S, m, n, isz, clusters, prec)
    lay = shared_layout(m, n, isz, mode, prec) \
        if mode and usable_shared(S, m, n, dt, prec) else None
    if lay is None:
        raise ValueError(f"fused_sweeps_shared: shape (S={S}, m={m}, "
                         f"n={n}) in {dt} at precision {prec!r} is not "
                         f"taken by the kernel"
                         + (f" in its {mode} mode" if mode else ""))
    return lay


def shared_plan(S, A, Kinv, K, mode=None, precision="highest"):
    """``(mode, operand)``: the mode ``fused_sweeps_shared`` launches for
    ``S`` scenarios on these CUDA matrices at ``precision`` and what it
    reads of them (:func:`shared_operand`), for a caller that passes both
    to every launch (a captured sweep loop, whose graph reads the operand
    from its buffers)."""
    lay = _shared_launch_layout(S, A, mode, precision)
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
    against the other; a lowered ``precision`` runs in the streamed mode.
    ``operand``: what the kernel reads of A, K^-1 and K in that mode and
    precision (:func:`shared_plan`), else made here.  Where ``stop`` is set
    the kernel returns at once and the outputs are left unwritten."""
    prec = canon(precision)
    if A.device.type == "cpu":
        return fused_sweeps_shared_plain(
            q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x, dq2, has, gamma,
            x, z, zx, y, yx, Ax, n_sweeps, n_refine, n_extra, sigma, alpha,
            prec, stop=stop)
    if A.device.type != "cuda":
        raise ValueError(f"fused_sweeps_shared: unsupported device "
                         f"{A.device}")
    if A.ndim != 2 or q.ndim != 2:
        raise ValueError(f"fused_sweeps_shared: A must be (m, n) and q "
                         f"(S, n); got {tuple(A.shape)} and "
                         f"{tuple(q.shape)}")
    (m, n), S, dt = A.shape, q.shape[0], A.dtype
    lay = _shared_launch_layout(S, A, mode, prec)
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
        _check_args("fused_sweeps_shared", ins[:2] + ins[3:],
                    ((S, n), (m, n), (n, n), (n, n)) + vshapes,
                    A.device, dt)
        if prec == "highest":
            _check_args("fused_sweeps_shared", (operand,), ((n, m),),
                        A.device, dt)
        else:
            _check_args("fused_sweeps_shared", (operand,),
                        ((2 if prec == "high" else 1, 2 * m * n + n * n),),
                        A.device, torch.bfloat16)
        _launch("fused_sweeps_shared", dt, ins, outs, stop, S, m, n,
                lay["sb"], lay["chunk"], *fixed[:3], _prec_code(prec),
                *fixed[3:])
    bump("shared_modes", lay["mode"])
    if prec != "highest":
        bump("lowered_launches", f"fused_sweeps_shared:{prec}")
    return outs


def fused_sweeps_sparse(q, rowcols, rowvals, colrows, colvals, Kinv, diagK,
                        cl, cu, lb, ub, rho_a, rho_x, dq2, has, gamma, x, z,
                        zx, y, yx, Ax, n_sweeps, n_refine, n_extra, sigma,
                        alpha, precision="highest", ell_t=None, stop=None,
                        operand=None):
    """Run one ``n_sweeps`` block of the sparse shared-A sweep; same
    arguments and result as :func:`fused_sweeps_sparse_plain`.  CUDA
    tensors launch the kernel in the mode of ``Kinv`` (a dense (n, n)
    tensor, or a :class:`~.structured_kkt.KernelWoodbury`) or raise; CPU
    tensors run the plain version.  ``ell_t`` is :func:`ell_slot_major` of
    the ELL arrays, which the kernel reads; a caller that launches many
    blocks against one A passes it, else it is made here.  At a lowered
    ``precision`` the kernel reads, of a dense K^-1, ``operand``
    (:func:`sparse_operand`, made here if not given), and of a structured
    ``Kinv`` the lowered copies it must carry
    (:func:`~.structured_kkt.lowered_layout`).  Where ``stop`` is set the
    kernel returns at once and the outputs are left unwritten."""
    prec = canon(precision)
    if Kinv.device.type == "cpu":
        return fused_sweeps_sparse_plain(
            q, rowcols, rowvals, colrows, colvals, Kinv, diagK, cl, cu, lb,
            ub, rho_a, rho_x, dq2, has, gamma, x, z, zx, y, yx, Ax, n_sweeps,
            n_refine, n_extra, sigma, alpha, prec, stop=stop)
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
    sb = usable_sparse(S, m, n, kr, kc, dt, wb, prec)
    if sb is None:
        raise ValueError(f"fused_sweeps_sparse: shape (S={S}, m={m}, n={n}, "
                         f"kr={kr}, kc={kc}) in {dt} at precision {prec!r} "
                         f"is not taken by the kernel"
                         + (" with this structured operand"
                            if wb is not None else ""))
    dev = Kinv.device
    parts = _prec_code(prec)
    if wb is not None and parts and (not wb.lo
                                     or wb.lo[1].shape[0] != parts):
        raise ValueError(f"fused_sweeps_sparse: at precision {prec!r} the "
                         "structured operand must carry its lowered copies "
                         "at that mode (structured_kkt.lowered_layout)")
    if wb is None and parts and operand is None:
        operand = sparse_operand(Kinv, prec)
    # the kernel reads K^-1 rows in vector loads, and copies the structured
    # operand's panels in 16-byte-aligned bulk copies
    if wb is None:
        mats = operand if parts else Kinv
    else:
        mats = wb.lo[0] if parts else wb.mats
    if mats.data_ptr() % 16:
        mats = mats.clone()
    if ell_t is None:
        ell_t = ell_slot_major((rowcols, rowvals, colrows, colvals))
    rc_t, rv_t, cr_t, cv_t = ell_t
    _check_args("fused_sweeps_sparse", (rc_t, cr_t), ((kr, m), (kc, n)),
                dev, torch.int32)
    ins = (q, rc_t, rv_t, cr_t, cv_t, mats, diagK, cl, cu, lb, ub, rho_a,
           rho_x, dq2, has, gamma, x, z, zx, y, yx, Ax)
    shapes = ((S, n), (kr, m), (kr, m), (kc, n), (kc, n), None, (1, n),
              (S, m), (S, m), (S, n), (S, n), (1, m), (1, n), (S, n), (1, 1),
              (S, 1), (S, n), (S, m), (S, n), (S, m), (S, n), (S, m))
    floats = [i for i in range(len(ins)) if i not in (1, 3, 5)]
    _check_args("fused_sweeps_sparse", [ins[i] for i in floats],
                [shapes[i] for i in floats], dev, dt)
    if wb is None:
        _check_args("fused_sweeps_sparse", (mats,),
                    ((parts, n, n) if parts else (n, n),), dev,
                    torch.bfloat16 if parts else dt)
    else:
        _check_args("fused_sweeps_sparse", (mats,),
                    ((max(parts, 1) * wb.mats.numel(),),), dev,
                    torch.bfloat16 if parts else dt)
    outs = tuple(torch.empty_like(t) for t in (x, z, zx, y, yx, Ax))
    # per-tile device-memory scratch: the rhs (n, sb) and an m-vector
    # (m, sb) of each tile, scenario values side by side; in the structured
    # mode also the K^-1 input and the Woodbury correction (n, sb each), by
    # position
    tiles = -(-S // sb)
    scratch = (torch.empty(tiles * sb * n, dtype=dt, device=dev),
               torch.empty(max(1, tiles * sb * m), dtype=dt, device=dev))
    fixed = (S, m, n, kr, kc, sb, int(n_sweeps), int(n_refine), int(n_extra),
             parts, float(sigma), float(alpha))
    if wb is None:
        _launch("fused_sweeps_sparse", dt, ins, outs + scratch, stop, *fixed)
        bump("sparse_modes", "dense")
    else:
        pat = wb.pattern
        items, stage = _wb_stage(wb, 4 if dt == torch.float32 else 8, prec)
        # at a lowered mode the one-variable inverses and the wide rows'
        # values of the Woodbury products come as their bf16 parts; A xt
        # reads the exact wide rows (wvals)
        dinv, wvals_lo, wtvals = wb.lo[1:] if parts else (
            wb.dinv, wb.wvals, wb.wtvals)
        lay = (pat.pos, pat.order, items, pat.binfo_t, dinv, pat.wcols,
               wb.wvals, pat.wpos, pat.wtrows, wtvals, pat.ncols, wb.nvals,
               pat.wrows, wvals_lo)
        kw, r = pat.wcols.shape
        kwc = pat.wtrows.shape[0]
        P = (max(parts, 1),) if parts else ()
        shapes = ((n,), (n,), tuple(items.shape), (pat.nb + 1, 4),
                  P + (n - pat.pd,), (kw, r), (kw, r), (kw, r), (kwc, n),
                  P + (kwc, n), (pat.kn, m), (pat.kn, m), (r,),
                  P + (kw, r))
        vals = (4, 6, 9, 11, 13)
        for want, idx in ((dt, vals),
                          (torch.int32, [i for i in range(len(lay))
                                         if i not in vals])):
            _check_args("fused_sweeps_sparse", [lay[i] for i in idx],
                        [shapes[i] for i in idx], dev, want)
        scratch += tuple(torch.empty(tiles * sb * n, dtype=dt, device=dev)
                         for _ in range(2))
        _launch("fused_sweeps_sparse", dt, ins + lay, outs + scratch, stop,
                *fixed, r, pat.kn, kw, kwc, pat.nb, items.shape[0], pat.pd,
                stage, pat.bmax, entry=1)
        bump("sparse_modes", "structured")
    if parts:
        bump("lowered_launches", f"fused_sweeps_sparse:{prec}")
    return outs
