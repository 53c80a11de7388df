"""Block/Woodbury factorization of the shared-A KKT system.

Port of ``tpusppy/solvers/structured_kkt.py``.  The shared x-update system
K = diag(d) + A' R A separates for block-structured families (UC above all:
generator-local logic, min-up/down, capacity and ramp rows, plus a few wide
balance and reserve rows) into

    K = B + A_w' R_w A_w,     B block-diagonal over variable components,

so each variable block factors on its own (batched per size bucket) and the
wide-row coupling is applied through the Woodbury identity

    K^-1 = B^-1 - B^-1 A_w' C^-1 A_w B^-1,
    C    = R_w^-1 + A_w B^-1 A_w'            (r x r, SPD).

The structure (components, bucket padding, wide-row set) is detected on the
host once per family by :func:`.sparse.detect_structure`.

Difference from the JAX package: the port's sweeps run in the
``fused_sweeps_sparse`` kernel, which applies K^-1 as one dense (n, n)
matrix.  The shared-A engine builds that matrix, ``kinv_apply(bw, I)``, once
per factorization and carries it in its factors beside the
:class:`BlockWoodbury` (the JAX package rebuilds it inside every kernel
dispatch).  The restart loop is a Python loop, so ``zero_factors`` (the
reference's ``lax.scan`` carry placeholder) has no twin.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .sparse import KKTStructure, SparseA


class StructureArrays(NamedTuple):
    """Device-resident index arrays of a :class:`KKTStructure`.

    ``bvars[k]`` is (nb, bs) int64 (dummy slot = n), ``brows[k]`` is
    (nb, mb) int64 (dummy slot = m); ``wide_rows`` is (r,) int64."""

    bvars: tuple
    brows: tuple
    wide_rows: torch.Tensor

    @classmethod
    def from_structure(cls, st: KKTStructure, device=None):
        def t(v):
            return torch.as_tensor(v, dtype=torch.int64, device=device)

        return cls(bvars=tuple(t(bv) for bv, _ in st.buckets),
                   brows=tuple(t(br) for _, br in st.buckets),
                   wide_rows=t(st.wide_rows))


class BlockWoodbury(NamedTuple):
    """Factored K^-1 operator (the structured stand-in for the dense
    ``Kinv`` inside :class:`~.shared_admm.SharedFactors`)."""

    binv: tuple          # per bucket (nb, bs, bs) explicit block inverses
    bvars: tuple         # per bucket (nb, bs) variable ids (dummy = n)
    Aw: torch.Tensor     # (r, n) dense scaled wide rows
    Cinv: torch.Tensor   # (r, r) inverse Woodbury cap


def _bapply(binv: tuple, bvars: tuple, b):
    """B^-1 b for b (..., n): gather per bucket, batched block product,
    scatter back.  Blocks partition the variables, so the scatters never
    collide (the dummy slot n collides only with itself and is dropped)."""
    n = b.shape[-1]
    b_pad = torch.cat([b, torch.zeros(b.shape[:-1] + (1,), dtype=b.dtype,
                                      device=b.device)], dim=-1)
    out = torch.zeros_like(b_pad)
    for inv_k, bv_k in zip(binv, bvars):
        g = b_pad[..., bv_k]                        # (..., nb, bs)
        r = torch.einsum("...kb,kbt->...kt", g, inv_k)
        out[..., bv_k.reshape(-1)] = r.reshape(r.shape[:-2]
                                               + (bv_k.numel(),))
    return out[..., :n]


def factor_structured(A: SparseA, struct: StructureArrays, dvec, rho_a,
                      sigma) -> BlockWoodbury:
    """Factor K = diag(dvec) + sigma I + A' diag(rho_a) A given the
    block/Woodbury split.  ``A`` must already be Ruiz-scaled.  The dense
    (m+1, n+1) scatter of A lives only while the blocks are cut out."""
    from .admm import _explicit_inverse

    m, n = A.shape
    dt, dev = A.dtype, A.device
    A_pad = torch.zeros((m + 1, n + 1), dtype=dt, device=dev).index_put_(
        (A.rows, A.cols), A.vals, accumulate=True)
    one = torch.ones((1,), dtype=dt, device=dev)
    d_pad = torch.cat([dvec + sigma, one])
    rho_pad = torch.cat([rho_a, torch.zeros_like(one)])

    binv = []
    for bv_k, br_k in zip(struct.bvars, struct.brows):
        Ablk = A_pad[br_k[:, :, None], bv_k[:, None, :]]    # (nb, mb, bs)
        Bb = torch.einsum("kms,kmt,km->kst", Ablk, Ablk, rho_pad[br_k])
        Bb = Bb + torch.diag_embed(d_pad[bv_k])
        binv.append(_explicit_inverse(Bb))
    binv = tuple(binv)

    Aw = A_pad[struct.wide_rows, :n]                         # (r, n)
    rho_w = rho_a[struct.wide_rows]
    T = _bapply(binv, struct.bvars, Aw)                      # (r, n)
    C = Aw @ T.T
    C = 0.5 * (C + C.T) + torch.diag(1.0 / rho_w)
    Cinv = _explicit_inverse(C[None])[0]
    return BlockWoodbury(binv=binv, bvars=struct.bvars, Aw=Aw, Cinv=Cinv)


def kinv_apply(bw: BlockWoodbury, b):
    """K^-1 b for b (..., n) via the Woodbury identity."""
    t = _bapply(bw.binv, bw.bvars, b)
    u = t @ bw.Aw.T
    v = u @ bw.Cinv
    w = v @ bw.Aw
    return t - _bapply(bw.binv, bw.bvars, w)


def densify(Kinv):
    """The dense (n, n) K^-1 the sweep kernel applies: ``Kinv`` itself, or
    ``kinv_apply(bw, I)`` for a BlockWoodbury (its rows are K^-1 e_i, so
    ``b @ densify(bw)`` is ``kinv_apply(bw, b)`` by linearity)."""
    if not isinstance(Kinv, BlockWoodbury):
        return Kinv
    n = Kinv.Aw.shape[1]
    eye = torch.eye(n, dtype=Kinv.Aw.dtype, device=Kinv.Aw.device)
    return kinv_apply(Kinv, eye).contiguous()
