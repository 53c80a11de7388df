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

Difference from the JAX package: the reference's Pallas kernel applies a
densified (n, n) K^-1 (``kinv_apply(bw, I)``, rebuilt in every dispatch)
because its matrices had to fit VMEM; on the H100 the ``fused_sweeps_sparse``
kernel applies the operator itself.  :class:`KernelWoodbury` is its layout:
each component's real-size block inverse and C^-1 in one flat array cut into
row panels the kernel stages through shared memory, the variables in block
order, and the wide rows as index/value lists taken from the scaled A's ELL
twin.  The index part (:class:`WoodburyPattern`) depends only on the
sparsity pattern and is made once per matrix; :func:`woodbury_layout` fills
the values once per factorization, on the device, with no host sync.  The
restart loop is a Python loop, so ``zero_factors`` (the reference's
``lax.scan`` carry placeholder) has no twin.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .precision import bf16_parts, canon, contract
from .sparse import KKTStructure, SparseA, ell_matvec


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


def _bapply(binv: tuple, bvars: tuple, b, prec=None, dot=contract):
    """B^-1 b for b (..., n): gather per bucket, batched block product,
    scatter back.  Blocks partition the variables, so the scatters never
    collide (the dummy slot n collides only with itself and is dropped).
    ``prec``: the block products' precision mode (:mod:`.precision`; the
    one-variable blocks' too); None or "highest" is exact.  ``dot(spec, a,
    b, prec)`` makes each product (:func:`~.precision.contract`, or the
    kernel's own rule in its plain version)."""
    n = b.shape[-1]
    b_pad = torch.cat([b, torch.zeros(b.shape[:-1] + (1,), dtype=b.dtype,
                                      device=b.device)], dim=-1)
    out = torch.zeros_like(b_pad)
    for inv_k, bv_k in zip(binv, bvars):
        g = b_pad[..., bv_k]                        # (..., nb, bs)
        r = dot("...kb,kbt->...kt", g, inv_k, prec)
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


def kinv_apply(bw: BlockWoodbury, b, prec=None, dot=contract):
    """K^-1 b for b (..., n) via the Woodbury identity.  ``prec`` lowers
    the apply's contractions (the block products and the three Woodbury
    products, each made by ``dot``: :func:`~.precision.contract`, the
    reference's, by default); the final ``t - B^-1 w`` stays exact, and
    the defect against the exact system is the caller's
    (``shared_admm._solve_shared_K``)."""
    t = _bapply(bw.binv, bw.bvars, b, prec, dot)
    if canon(prec) == "highest":
        u = t @ bw.Aw.T
        v = u @ bw.Cinv
        w = v @ bw.Aw
    else:
        u = dot("...n,rn->...r", t, bw.Aw, prec)
        v = dot("...r,rq->...q", u, bw.Cinv, prec)
        w = dot("...r,rn->...n", v, bw.Aw, prec)
    return t - _bapply(bw.binv, bw.bvars, w, prec, dot)


def apply_kinv_like(Kinv, b, prec=None):
    """Uniform K^-1 application: a dense (n, n) tensor or a
    :class:`BlockWoodbury`, at ``prec``."""
    if isinstance(Kinv, BlockWoodbury):
        return kinv_apply(Kinv, b, prec)
    if canon(prec) == "highest":
        return b @ Kinv
    return contract("...n,nk->...k", b, Kinv, prec)



# ---- the kernel layout -----------------------------------------------------

#: Largest panel the kernel stages: a stored block (or C^-1) is cut into
#: row panels of at most this many bytes, double-buffered in shared memory
#: (a uc block of 96 variables is one panel in f32, two in f64).
STAGE_BYTES = 36864
#: Stored blocks are padded to a multiple of this many rows and columns:
#: the f64 tensor-core tile (m16n8k16), and 16-byte rows for the bulk
#: copies.
ROW_PAD = 16


def _round_up(v, k):
    return -(-v // k) * k


class WoodburyPattern(NamedTuple):
    """The index part of a :class:`KernelWoodbury`: a function of the
    sparsity pattern and the structure alone, made once per matrix by
    :func:`woodbury_pattern`.  Device arrays are int32 unless noted.

    Positions put the variables in block order: ``order[p]`` is the
    variable at position p and ``pos`` its inverse; the dense components
    (two or more variables) come first, each contiguous, then the
    one-variable components from position ``pd``.  ``binfo`` (host tuple,
    and ``binfo_t`` on the device, (nb + 1, 4)) holds per dense block, then
    for C^-1 as the last entry, (offset in ``mats``, real size, row stride
    ld = size rounded up to :data:`ROW_PAD`, first position); each is
    stored (ld, ld) row-major, zero-padded.  ``items[itemsize]`` (P + C, 3):
    the staged panels (block, first row, rows), every dense block's in
    order, then C^-1's; ``stage_elems[itemsize]`` the largest.

    The wide rows are the structure's coupling rows, ``wide`` (r,) int64
    ids (``wrows`` as int32); a narrow row's non-zeros all sit in its first
    ``kn`` ELL slots.  ``ncols`` (kn, m): those first slots' columns,
    slot-major, with -1 in slot 0 of a wide row (whose slots there are all
    padding).
    ``wcols``/``wpos`` (kw, r): the wide rows' entries slot-major, columns
    as variables and as positions (padding: column 0 with value 0).
    ``wtrows`` (kwc, n): per position, the wide rows holding it, slot-major
    in row order (padding row 0 with value 0).

    The int64 ``*_src`` arrays say where the values come from:
    ``mats_src``/``dinv_src`` index the flat B^-1 buckets followed by C^-1
    and one zero, ``wval_src`` (kw, r) and ``nval_src`` (kn, m) the flat
    ELL row values followed by one zero, ``wt_src`` (kwc, n) the flat
    ``wvals`` followed by one zero."""

    order: torch.Tensor
    pos: torch.Tensor
    pd: int
    binfo: tuple
    binfo_t: torch.Tensor
    items: dict
    stage_elems: dict
    bmax: int
    wide: torch.Tensor
    wrows: torch.Tensor
    ncols: torch.Tensor
    wcols: torch.Tensor
    wpos: torch.Tensor
    wtrows: torch.Tensor
    kn: int
    mats_src: torch.Tensor
    dinv_src: torch.Tensor
    wval_src: torch.Tensor
    nval_src: torch.Tensor
    wt_src: torch.Tensor

    @property
    def nb(self):
        """Dense blocks (C^-1 not counted)."""
        return len(self.binfo) - 1

    @property
    def r(self):
        return int(self.wide.numel())


def _panels(binfo, itemsize):
    """Row panels of every stored block, each at most STAGE_BYTES (or
    ROW_PAD rows) and a whole number of ROW_PAD rows."""
    out = []
    for b, (_, _, ld, _) in enumerate(binfo):
        cap = max(ROW_PAD,
                  STAGE_BYTES // (ld * itemsize) // ROW_PAD * ROW_PAD)
        out += [(b, r0, min(cap, ld - r0)) for r0 in range(0, ld, cap)]
    return out


def woodbury_pattern(A: SparseA) -> WoodburyPattern:
    """The :class:`WoodburyPattern` of a structured SparseA, made on the host
    once (one copy of the index arrays off the device) and cached for A
    and every scaled or cast copy of it."""
    if "pattern" in A._wb_cache:
        return A._wb_cache["pattern"]
    st = A.structure
    if st is None:
        raise ValueError("woodbury_pattern: the SparseA has no structure")
    m, n = A.shape
    dev = A.device
    rowcols = A.ell.rowcols.cpu().numpy()
    kr = rowcols.shape[1]
    counts = np.bincount(A.rows.cpu().numpy(), minlength=m)
    wide = st.wide_rows.cpu().numpy().astype(np.int64)
    r = wide.size

    # components in bucket order; dense ones (2+ variables) first
    dense, diag, base = [], [], 0
    for bv in st.bvars:
        bv = bv.cpu().numpy()
        nbk, bsk = bv.shape
        for j in range(nbk):
            vs = bv[j][bv[j] < n]
            (dense if vs.size > 1 else diag).append(
                (vs, base + j * bsk * bsk, bsk))
        base += nbk * bsk * bsk
    order = np.concatenate([v for v, _, _ in dense + diag]
                           + [np.zeros(0, np.int64)]).astype(np.int64)
    if not np.array_equal(np.sort(order), np.arange(n)):
        raise ValueError("woodbury_pattern: the structure's components do "
                         "not partition the variables")
    pos = np.empty(n, np.int64)
    pos[order] = np.arange(n)

    zero = base + r * r       # the trailing zero of the flat sources
    binfo, mats_src, off, p0 = [], [], 0, 0
    for vs, src0, bsk in dense + [(np.arange(r), base, r)]:
        s = vs.size
        ld = _round_up(max(s, 1), ROW_PAD)
        idx = np.full((ld, ld), zero, np.int64)
        a = np.arange(s)
        idx[:s, :s] = src0 + a[:, None] * bsk + a[None, :]
        binfo.append((off, s, ld, p0 if len(binfo) < len(dense) else 0))
        mats_src.append(idx.ravel())
        off += ld * ld
        p0 += s
    pd = sum(v.size for v, _, _ in dense)
    dinv_src = np.array([src0 for _, src0, _ in diag], np.int64)

    kw = max(1, int(counts[wide].max(initial=0)))
    wcols = rowcols[wide, :kw].astype(np.int64)                 # (r, kw)
    wval_src = wide[:, None] * kr + np.arange(kw)[None, :]
    narrow = np.ones(m, bool)
    narrow[wide] = False
    kn = max(1, int(counts[narrow].max(initial=0)))
    ncols = np.zeros((m, kn), np.int64)
    ncols[narrow] = rowcols[narrow, :kn]
    ncols[wide, 0] = -1
    nval_src = np.full((m, kn), m * kr, np.int64)
    nval_src[narrow] = (np.flatnonzero(narrow)[:, None] * kr
                        + np.arange(kn)[None, :])

    # per position, the wide rows holding it, in row order
    q, sl = np.nonzero(np.arange(kw)[None, :] < counts[wide][:, None])
    p = pos[wcols[q, sl]]
    srt = np.lexsort((q, p))
    q, sl, p = q[srt], sl[srt], p[srt]
    pc = np.bincount(p, minlength=n)
    kwc = max(1, int(pc.max(initial=0)))
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(pc, out=starts[1:])
    slot = np.arange(p.size) - starts[p]
    wtrows = np.zeros((kwc, n), np.int64)
    wt_src = np.full((kwc, n), kw * r, np.int64)
    wtrows[slot, p] = q
    wt_src[slot, p] = sl * r + q          # into the (kw, r) wvals, flat

    def i32(v):
        return torch.as_tensor(np.ascontiguousarray(v), dtype=torch.int32,
                               device=dev)

    def i64(v):
        return torch.as_tensor(np.ascontiguousarray(v), dtype=torch.int64,
                               device=dev)

    items, stage = {}, {}
    for isz in (4, 8):
        pan = _panels(binfo, isz)
        items[isz] = i32(np.array(pan, np.int64).reshape(-1, 3))
        stage[isz] = max(rows * binfo[b][2] for b, _, rows in pan)
    pat = WoodburyPattern(
        order=i32(order), pos=i32(pos), pd=pd, binfo=tuple(binfo),
        binfo_t=i32(np.array(binfo, np.int64)), items=items,
        stage_elems=stage, bmax=max(ld for _, _, ld, _ in binfo),
        wide=i64(wide), wrows=i32(wide), ncols=i32(ncols.T),
        wcols=i32(wcols.T),
        wpos=i32(pos[wcols].T), wtrows=i32(wtrows), kn=kn,
        mats_src=i64(np.concatenate(mats_src)), dinv_src=i64(dinv_src),
        wval_src=i64(wval_src.T), nval_src=i64(nval_src.T),
        wt_src=i64(wt_src))
    A._wb_cache["pattern"] = pat
    return pat


class KernelWoodbury(NamedTuple):
    """The block/Woodbury K^-1 as the ``fused_sweeps_sparse`` kernel applies
    it (:func:`woodbury_layout`): the :class:`BlockWoodbury` it was made
    from (the plain version applies that with :func:`kinv_apply`), its
    :class:`WoodburyPattern`, and the values: ``mats`` (every dense block's
    inverse at its real size, then C^-1, as ``pattern.binfo`` places them),
    ``dinv`` (the one-variable components' inverses, by position from
    ``pattern.pd``), ``wvals`` (kw, r) and ``wtvals`` (kwc, n), the wide
    rows' values in the slot orders of ``pattern.wcols`` and
    ``pattern.wtrows``, and ``nvals`` (kn, m), the narrow rows' first
    slots (zero in a wide row).  ``lo``: empty, or the copies the kernel
    reads at a lowered precision (:func:`lowered_layout`)."""

    bw: BlockWoodbury
    pattern: WoodburyPattern
    mats: torch.Tensor
    dinv: torch.Tensor
    wvals: torch.Tensor
    wtvals: torch.Tensor
    nvals: torch.Tensor
    lo: tuple = ()

    @property
    def dtype(self):
        return self.mats.dtype

    @property
    def device(self):
        return self.mats.device

    def astype(self, dt):
        bw = self.bw
        return KernelWoodbury(
            bw=bw._replace(binv=tuple(b.to(dt) for b in bw.binv),
                           Aw=bw.Aw.to(dt), Cinv=bw.Cinv.to(dt)),
            pattern=self.pattern, mats=self.mats.to(dt),
            dinv=self.dinv.to(dt), wvals=self.wvals.to(dt),
            wtvals=self.wtvals.to(dt), nvals=self.nvals.to(dt))


def lowered_layout(kw: KernelWoodbury, precision) -> KernelWoodbury:
    """``kw`` with the copies ``fused_sweeps_sparse`` reads at a lowered
    ``precision`` in ``lo``: ``mats`` as bf16 (at "default") or as bf16
    pairs, each entry's two parts side by side (at "high": 2 numel values,
    one bulk copy bringing both parts of a panel), and ``dinv``, ``wvals``
    and ``wtvals`` as their P bf16 parts (P = 1 or 2), stacked and held in
    the working dtype (exact: a bf16 value is a float32 and a float64
    one).  The parts go through float32 (:func:`~.precision.bf16_parts`).
    Made outside any CUDA-graph capture, once a solve, by the shared
    engine's core (``shared_admm._core``)."""
    prec = canon(precision)
    if prec == "highest":
        return kw._replace(lo=())
    m1, m2 = bf16_parts(kw.mats, prec)
    mats = m1 if m2 is None else torch.stack([m1, m2], dim=-1).reshape(-1)

    def parts(v):
        return torch.stack([p.to(v.dtype) for p in bf16_parts(v, prec)
                            if p is not None])

    return kw._replace(lo=(mats.contiguous(), parts(kw.dinv),
                           parts(kw.wvals), parts(kw.wtvals)))


def woodbury_layout(bw: BlockWoodbury, A: SparseA) -> KernelWoodbury:
    """The :class:`KernelWoodbury` of ``bw``, factored from the Ruiz-scaled
    ``A`` (whose ELL row values give the wide rows' values): gathers on the
    device, no host sync once ``A``'s pattern is made."""
    pat = woodbury_pattern(A)
    zero = torch.zeros((1,), dtype=A.dtype, device=A.device)
    src = torch.cat([b.reshape(-1) for b in bw.binv]
                    + [bw.Cinv.reshape(-1), zero])
    rowvals = torch.cat([A.ell.rowvals.reshape(-1), zero])
    wvals = rowvals[pat.wval_src]
    return KernelWoodbury(
        bw=bw, pattern=pat, mats=src[pat.mats_src],
        dinv=src[pat.dinv_src], wvals=wvals,
        wtvals=torch.cat([wvals.reshape(-1), zero])[pat.wt_src],
        nvals=rowvals[pat.nval_src])


def narrow_wide_matvec(kw: KernelWoodbury, x):
    """A x for x (S, n) as the kernel takes it with the structured operand:
    the narrow rows from their first ``kn`` ELL slots (``pattern.ncols``,
    ``nvals``), the wide rows from their own lists."""
    pat = kw.pattern
    out = ell_matvec(pat.ncols.clamp(min=0), kw.nvals, x)
    if pat.r:
        out.index_copy_(1, pat.wide, ell_matvec(pat.wcols, kw.wvals, x))
    return out


def layout_apply(kw: KernelWoodbury, w):
    """K^-1 w for w (S, n) read from the layout alone, step by step as the
    kernel takes it: t = B^-1 w block by block in position order (the
    one-variable components scaled), u = A_w t over the wide rows' lists,
    v = C^-1 u, w' = A_w' v per position, y = t - B^-1 w'."""
    pat = kw.pattern
    wp = w.index_select(1, pat.order)

    def bapply(v):
        out = torch.empty_like(v)
        for off, s, ld, p0 in pat.binfo[:-1]:
            M = kw.mats[off:off + ld * ld].view(ld, ld)[:s, :s]
            out[:, p0:p0 + s] = v[:, p0:p0 + s] @ M
        out[:, pat.pd:] = v[:, pat.pd:] * kw.dinv
        return out

    t = bapply(wp)
    u = ell_matvec(pat.wpos, kw.wvals, t)
    off, r, ld, _ = pat.binfo[-1]
    v = u @ kw.mats[off:off + ld * ld].view(ld, ld)[:r, :r]
    y = t - bapply(ell_matvec(pat.wtrows, kw.wtvals, v))
    return y.index_select(1, pat.pos)
