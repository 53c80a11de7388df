"""Hand-written CUDA kernels of the port, their wrappers and plain versions.

``fused_sweeps`` replaces the TPU Pallas kernel
``tpusppy/solvers/pallas_kernels.py:_sweeps_kernel``: ``n_sweeps`` relaxed
OSQP sweeps per scenario with the scenario's A, K^-1 and K held in shared
memory (source, bound and design notes: ``tpusppy_torch/csrc/fused_sweeps.cu``).

The wrapper launches the kernel for CUDA tensors and raises on anything it
cannot take; for CPU tensors it runs :func:`fused_sweeps_plain`, the batched
PyTorch transcription of the same recurrence (the CPU path, and the oracle the
kernel is held against on the card).  There is no fallback on failure.

The kernel is compiled on first use with ``nvcc`` for ``sm_90a`` into
``tpusppy_torch/_build/`` (named by the source's hash) and bound with
``ctypes``; nothing is built or imported from CUDA when this module loads.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

#: Dynamic shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232448

#: Kernel launches per wrapper (one per launch, nowhere else), and calls of
#: the plain versions; :func:`reset_counts` zeroes both.
launches = {"fused_sweeps": 0}
plain_calls = {"fused_sweeps": 0}

_lib = None
_lib_lock = threading.Lock()
build_log = ""


def reset_counts():
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0


def matvec(M, v):
    """Batched ``einsum("snk,sk->sn", M, v)``."""
    return torch.bmm(M, v.unsqueeze(-1)).squeeze(-1)


def rmatvec(A, y):
    """Batched ``einsum("smn,sm->sn", A, y)`` (A' y per scenario)."""
    return torch.bmm(A.transpose(1, 2), y.unsqueeze(-1)).squeeze(-1)


def smem_bytes(m, n, itemsize) -> int:
    """Shared memory of one ``fused_sweeps`` block: A, K^-1, K with rows
    padded to an odd stride, ten n-vectors and eight m-vectors (mirrors
    ``smem_elems`` in the CUDA source)."""
    ld = n | 1
    return itemsize * (m * ld + 2 * n * ld + 10 * n + 8 * m)


def usable(S, m, n, dtype) -> bool:
    """Whether ``fused_sweeps`` takes this shape: f32/f64, and one
    scenario's matrices and vectors fit the shared memory of a block.
    Mirrors ``pallas_kernels.usable`` sized to Hopper shared memory instead
    of TPU VMEM; a shape that fails takes the batched tensor path."""
    if dtype not in (torch.float32, torch.float64) or S < 1 or n < 1:
        return False
    itemsize = 4 if dtype == torch.float32 else 8
    return smem_bytes(m, n, itemsize) <= SMEM_LIMIT


def fused_sweeps_plain(q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x,
                       x, z, zx, y, yx, Ax, n_sweeps, n_refine, sigma,
                       alpha):
    """The sweep recurrence of ``admm._admm_core`` in batched tensor form
    (``tests/test_pallas.py:_xla_sweeps`` in PyTorch).  Natural layout:
    A (S, m, n), Kinv/K (S, n, n), vectors (S, n) or (S, m).  Returns
    ``(x, z, zx, y, yx, Ax)`` after ``n_sweeps`` sweeps with the incremental
    Ax carry."""
    plain_calls["fused_sweeps"] += 1
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
    return tuple(t.squeeze(-1) for t in (x, z, zx, y, yx, Ax))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "tpusppy_torch/csrc on first use and need the "
                           "CUDA toolkit")
    return nvcc


def build(name="fused_sweeps") -> Path:
    """Compile ``csrc/<name>.cu`` into a shared library under ``_build/``
    unless a library of the same source hash exists; returns its path.
    The compiler's resource report (``-Xptxas -v``) lands in
    :data:`build_log`."""
    global build_log
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    build_log = res.stderr
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build("fused_sweeps")))
            for fn in (lib.tpusppy_fused_sweeps_f32,
                       lib.tpusppy_fused_sweeps_f64):
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_double,
                               ctypes.c_double, ctypes.c_void_p]
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def fused_sweeps(q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x,
                 x, z, zx, y, yx, Ax, n_sweeps, n_refine, sigma, alpha):
    """Run ``n_sweeps`` fused ADMM sweeps; same arguments and result as
    :func:`fused_sweeps_plain`.  CUDA tensors launch the kernel (or raise);
    CPU tensors run the plain version."""
    if A.device.type == "cpu":
        return fused_sweeps_plain(q, A, Kinv, K, cl, cu, lb, ub, rho_a,
                                  rho_x, x, z, zx, y, yx, Ax, n_sweeps,
                                  n_refine, sigma, alpha)
    if A.device.type != "cuda":
        raise ValueError(f"fused_sweeps: unsupported device {A.device}")
    S, m, n = A.shape
    dt = A.dtype
    if not usable(S, m, n, dt):
        raise ValueError(f"fused_sweeps: shape (S={S}, m={m}, n={n}) in "
                         f"{dt} does not fit one block's shared memory")
    ins = (q, A, Kinv, K, cl, cu, lb, ub, rho_a, rho_x, x, z, zx, y, yx, Ax)
    shapes = ((S, n), (S, m, n), (S, n, n), (S, n, n), (S, m), (S, m),
              (S, n), (S, n), (S, m), (S, n), (S, n), (S, m), (S, n),
              (S, m), (S, n), (S, m))
    for i, (t, shp) in enumerate(zip(ins, shapes)):
        if tuple(t.shape) != shp or t.dtype != dt or t.device != A.device \
                or not t.is_contiguous():
            raise ValueError(
                f"fused_sweeps: argument {i} is {tuple(t.shape)} {t.dtype} "
                f"on {t.device} (contiguous={t.is_contiguous()}); wanted "
                f"{shp} {dt} on {A.device}, contiguous")
    outs = tuple(torch.empty_like(t) for t in (x, z, zx, y, yx, Ax))
    lib = _load()
    fn = (lib.tpusppy_fused_sweeps_f32 if dt == torch.float32
          else lib.tpusppy_fused_sweeps_f64)
    in_ptrs = (ctypes.c_void_p * len(ins))(*[t.data_ptr() for t in ins])
    out_ptrs = (ctypes.c_void_p * len(outs))(*[t.data_ptr() for t in outs])
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = fn(in_ptrs, out_ptrs, S, m, n, int(n_sweeps), int(n_refine),
                 float(sigma), float(alpha), stream)
    if err != 0:
        raise RuntimeError(f"fused_sweeps: CUDA launch failed with error "
                           f"{err}")
    launches["fused_sweeps"] += 1
    return outs
