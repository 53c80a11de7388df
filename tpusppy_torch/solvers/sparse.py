"""Sparse shared constraint matrices and the block/Woodbury KKT structure.

Port of ``tpusppy/solvers/sparse.py``.  Reference-scale stochastic families
have extremely sparse shared constraint matrices: the full-width UC
(``models/uc.py``, 30 generators x 24 hours) is (4626, 2928) with 18,937
non-zeros (0.14%).  This module holds the two pieces the shared-A engine
(:mod:`.shared_admm`) takes from that sparsity:

- :class:`SparseA`: COO triplets in CSR order, as torch tensors on one
  device, with its padded-ELL twin (:class:`EllA`).  The
  ``fused_sweeps_sparse`` CUDA kernel runs every sweep block of the engine
  on the twin (the JAX package builds it only under its TPU opt-in).  The
  batched products outside the kernel are the sums of the reference's
  gather and sorted segment sum, made with no atomics, so they give the
  same bits on every run: A' y walks the column slots in order; A x walks
  only the first ``NARROW_K`` row slots, and the few wide rows (uc's
  balance and reserve rows, up to 61 entries) come from one dense product.
- :func:`detect_structure`: the block/Woodbury split of the KKT system
  K = diag(d) + A' R A into generator-local blocks plus the few wide
  coupling rows, factored by :mod:`.structured_kkt`.

The host-side pieces (:func:`_build_ell`, :func:`detect_structure`,
:func:`should_sparsify`) are numpy copies of the reference's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: Rows with more non-zeros than this are wide: :meth:`SparseA.matvec` takes
#: them from a dense product, and :func:`detect_structure` puts them in the
#: Woodbury coupling by default.
NARROW_K = 8


class EllA(NamedTuple):
    """Padded-ELL twin of a :class:`SparseA`.

    Row form (the forward matvec): ``rowcols``/``rowvals`` are (m, kr), each
    row's non-zero column ids and values left-packed; padding slots carry
    column 0 with value 0 (inert in the multiply-add).  Column form (the
    transpose matvec): ``colrows``/``colvals`` are (n, kc) likewise.  kr/kc
    are the largest per-row/per-column non-zero counts.  Indices are int32,
    the layout ``fused_sweeps_sparse`` reads."""

    rowcols: torch.Tensor   # (m, kr) int32
    rowvals: torch.Tensor   # (m, kr)
    colrows: torch.Tensor   # (n, kc) int32
    colvals: torch.Tensor   # (n, kc)


def _build_ell(rows, cols, vals, m, n, max_k=None):
    """Host-side ELL construction from COO as numpy arrays ``(rowcols,
    rowvals, colrows, colvals)``, or None when a row or column has more
    than ``max_k`` non-zeros.  The port builds it with no cap (``max_k``
    None): its kernel loops kr and kc at run time, where the TPU kernel
    unrolls them (the reference caps them at 64)."""
    row_counts = np.bincount(rows, minlength=m)
    col_counts = np.bincount(cols, minlength=n)
    kr = int(row_counts.max()) if rows.size else 1
    kc = int(col_counts.max()) if cols.size else 1
    if max_k is not None and (kr > max_k or kc > max_k):
        return None
    kr, kc = max(kr, 1), max(kc, 1)

    def pack(keys, others, vals_, counts, rows_out, k):
        """Left-pack (keys -> slots) via a stable sort: slot index =
        position within the key's sorted run."""
        order = np.argsort(keys, kind="stable")
        ks, os_, vs = keys[order], others[order], vals_[order]
        starts = np.zeros(counts.size + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        slot = np.arange(ks.size) - starts[ks]
        idx_out = np.zeros((rows_out, k), np.int32)
        val_out = np.zeros((rows_out, k))
        idx_out[ks, slot] = os_
        val_out[ks, slot] = vs
        return idx_out, val_out

    rowcols, rowvals = pack(np.asarray(rows), np.asarray(cols),
                            np.asarray(vals), row_counts, m, kr)
    colrows, colvals = pack(np.asarray(cols), np.asarray(rows),
                            np.asarray(vals), col_counts, n, kc)
    return rowcols, rowvals, colrows, colvals


def dense_ell(A: torch.Tensor) -> EllA:
    """The ELL form of a dense (m, n) tensor, made on its device: every row
    holds all n columns and every column all m rows, so the ELL matvecs are
    the dense products.  The engine's matrix-free refinement on a dense A
    (factors without K) goes through it."""
    m, n = A.shape
    dev = A.device
    return EllA(
        torch.arange(n, dtype=torch.int32, device=dev).expand(m, n)
        .contiguous(),
        A.contiguous(),
        torch.arange(m, dtype=torch.int32, device=dev).expand(n, m)
        .contiguous(),
        A.T.contiguous())


def ell_slot_major(ell: EllA):
    """The ELL arrays transposed to (kr, m) and (kc, n), contiguous: one
    slot's indices and values side by side, the layout the sparse kernel
    reads and :func:`ell_matvec` walks."""
    return tuple(t.T.contiguous() for t in ell)


def ell_matvec(cols_t, vals_t, v):
    """An ELL product slot by slot (``pallas_kernels._ell_mv``):
    ``out[:, i] = sum_j vals[i, j] * v[:, cols[i, j]]`` with the slots
    summed in order, so no (S, rows, k) gather is ever made.  ``cols_t``
    and ``vals_t`` are the (k, rows) slot-major arrays."""
    acc = v.index_select(1, cols_t[0]) * vals_t[0][None, :]
    for j in range(1, cols_t.shape[0]):
        acc = acc + v.index_select(1, cols_t[j]) * vals_t[j][None, :]
    return acc


class SparseA:
    """Shared (m, n) sparse matrix with batched matvecs, on one device.

    ``rows``/``cols``/``vals``: COO triplets sorted in CSR order;
    ``structure``: optional :class:`~.structured_kkt.StructureArrays` (the
    block/Woodbury split of this matrix's KKT system); ``ell``: the
    :class:`EllA` twin the products run on; ``wide``: the (r,) ids of the
    rows with more than :data:`NARROW_K` non-zeros and ``Aw`` their dense
    (r, n) values; ``kn``: the most non-zeros of any other row."""

    def __init__(self, rows, cols, vals, shape, ell, wide, Aw, kn,
                 structure=None):
        self.rows = rows
        self.cols = cols
        self.vals = vals
        self.shape = tuple(shape)
        self.ell = ell
        self.wide = wide
        self.Aw = Aw
        self.kn = kn
        self.structure = structure
        self._ell_t = None
        # structured_kkt.woodbury_pattern's cache: the pattern depends on
        # the sparsity and structure only, so scaled and cast copies share
        # this one dict
        self._wb_cache = {}

    # -- construction -----------------------------------------------------
    @classmethod
    def from_coo(cls, rows, cols, vals, shape, dtype=None, device=None,
                 structure=None):
        """From numpy COO triplets in CSR order; ``structure`` is a host
        :class:`KKTStructure` or None."""
        m, n = shape
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        vals = np.asarray(vals)
        dtype = torch.float64 if dtype is None else dtype

        def idx(v):
            return torch.as_tensor(v, dtype=torch.int64, device=device)

        def val(v):
            return torch.as_tensor(np.array(v, dtype=np.float64),
                                   dtype=dtype, device=device)

        struct_arrays = None
        if structure is not None:
            from .structured_kkt import StructureArrays
            struct_arrays = StructureArrays.from_structure(structure, device)
        rc, rv, cr, cv = _build_ell(rows, cols, vals, m, n)
        ell = EllA(torch.as_tensor(rc, device=device), val(rv),
                   torch.as_tensor(cr, device=device), val(cv))
        counts = np.bincount(rows, minlength=m)
        wide = np.flatnonzero(counts > NARROW_K)
        Aw = np.zeros((wide.size, n))
        in_wide = np.isin(rows, wide)
        Aw[np.searchsorted(wide, rows[in_wide]), cols[in_wide]] = \
            vals[in_wide]
        kn = max(1, int(counts[counts <= NARROW_K].max(initial=0)))
        return cls(idx(rows), idx(cols), val(vals), (m, n), ell, idx(wide),
                   val(Aw), kn, struct_arrays)

    @classmethod
    def from_dense(cls, A, dtype=None, device=None, structure=False,
                   **detect_kw):
        """From a dense ndarray; ``structure=True`` also runs
        :func:`detect_structure` and attaches its index arrays when a usable
        block/Woodbury split exists."""
        A = np.asarray(A)
        rows, cols = np.nonzero(A)
        vals = A[rows, cols]
        order = np.lexsort((cols, rows))          # CSR order
        rows, cols, vals = rows[order], cols[order], vals[order]
        st = detect_structure(A, **detect_kw) if structure else None
        return cls.from_coo(rows, cols, vals, A.shape, dtype, device, st)

    @property
    def nnz(self):
        return self.vals.shape[0]

    @property
    def ndim(self):
        """2: dispatch sites treat a SparseA like a shared (m, n) matrix."""
        return 2

    @property
    def dtype(self):
        return self.vals.dtype

    @property
    def device(self):
        return self.vals.device

    def _with(self, vals, ell, Aw):
        out = SparseA(self.rows, self.cols, vals, self.shape, ell,
                      self.wide, Aw, self.kn, self.structure)
        out._wb_cache = self._wb_cache
        return out

    def astype(self, dt):
        return self._with(self.vals.to(dt), self.ell._replace(
            rowvals=self.ell.rowvals.to(dt), colvals=self.ell.colvals.to(dt)),
            self.Aw.to(dt))

    def scale(self, E, D):
        """diag(E) @ A @ diag(D), the Ruiz application: the index arrays
        and the structure (a sparsity pattern) are shared; the ELL twin
        and the wide rows scale their values, where padding stays zero."""
        e = self.ell
        return self._with(
            self.vals * E[self.rows] * D[self.cols],
            e._replace(rowvals=e.rowvals * E[:, None] * D[e.rowcols.long()],
                       colvals=e.colvals * E[e.colrows.long()] * D[:, None]),
            self.Aw * E[self.wide][:, None] * D[None, :])

    def ell_t(self):
        """:func:`ell_slot_major` of the twin, made once."""
        if self._ell_t is None:
            self._ell_t = ell_slot_major(self.ell)
        return self._ell_t

    def values(self) -> tuple:
        """The value tensors (A's, its ELL twin's, the wide rows', the
        slot-major twin's), in the order :meth:`with_values` takes them;
        the index arrays and the structure are the rest."""
        _, rv_t, _, cv_t = self.ell_t()
        return (self.vals, self.ell.rowvals, self.ell.colvals, self.Aw,
                rv_t, cv_t)

    def with_values(self, vals, rowvals, colvals, Aw, rv_t, cv_t):
        """This matrix's structure holding other values (a captured CUDA
        graph's buffers, :mod:`.device_loop`)."""
        out = self._with(vals, self.ell._replace(rowvals=rowvals,
                                                 colvals=colvals), Aw)
        rc_t, _, cr_t, _ = self.ell_t()
        out._ell_t = (rc_t, rv_t, cr_t, cv_t)
        return out

    # -- matvecs ----------------------------------------------------------
    def matvec(self, x):
        """A x for x (S, n) -> (S, m): the first ``kn`` ELL slots of every
        row, which hold all of a narrow row, then the wide rows replaced by
        one dense product."""
        rc, rv, _, _ = self.ell_t()
        out = ell_matvec(rc[:self.kn], rv[:self.kn], x)
        if self.wide.numel():
            out.index_copy_(1, self.wide, x @ self.Aw.T)
        return out

    def rmatvec(self, y):
        """A' y for y (S, m) -> (S, n), over the ELL columns."""
        _, _, cr, cv = self.ell_t()
        return ell_matvec(cr, cv, y)

    def row_absmax(self):
        """(m,) per-row max |a_ij| (Ruiz row norms); empty rows give 0."""
        out = torch.zeros(self.shape[0], dtype=self.dtype, device=self.device)
        return out.scatter_reduce_(0, self.rows, self.vals.abs(), "amax")

    def col_absmax(self):
        """(n,) per-column max |a_ij|; empty columns give 0."""
        out = torch.zeros(self.shape[1], dtype=self.dtype, device=self.device)
        return out.scatter_reduce_(0, self.cols, self.vals.abs(), "amax")

    def todense(self):
        """Dense (m, n) tensor (for factorization and consumers that need
        the full matrix)."""
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return out.index_put_((self.rows, self.cols), self.vals,
                              accumulate=True)


def should_sparsify(A_np) -> bool:
    """The policy for uploading a shared A as :class:`SparseA`: large AND
    very sparse, where small matrices ride dense products better."""
    return A_np.size >= 4e6 and (A_np != 0).mean() < 0.01


def _as_numpy_coo(A):
    """(rows, cols, vals, m, n) from a dense ndarray or a SparseA."""
    if isinstance(A, SparseA):
        return (A.rows.cpu().numpy(), A.cols.cpu().numpy(),
                A.vals.cpu().numpy(), A.shape[0], A.shape[1])
    A = np.asarray(A)
    rows, cols = np.nonzero(A)
    return rows, cols, A[rows, cols], A.shape[0], A.shape[1]


class KKTStructure(NamedTuple):
    """Host-side (static) description of the block/Woodbury split of
    K = diag + A' R A.  All members are numpy; moved to the device by
    :meth:`~.structured_kkt.StructureArrays.from_structure`.

    Variables are grouped into components connected by NARROW rows; wide
    rows form the low-rank coupling.  Components are padded into size
    buckets so each bucket factors as one batched (nb, bs, bs) program.
    """

    narrow_rows: np.ndarray   # (mn,) row ids whose support stays in-block
    wide_rows: np.ndarray     # (r,) row ids in the coupling term
    # per bucket: (block_vars (nb, bs) padded with n [dummy var],
    #             block_rows (nb, mb) padded with m [dummy row])
    buckets: tuple
    n: int
    m: int

    @property
    def r(self):
        return int(self.wide_rows.size)


def detect_structure(A, narrow_k: int = NARROW_K, max_block: int = 1024,
                     max_coupling: int = 4096,
                     min_blocks: int = 4) -> KKTStructure | None:
    """Find the block/Woodbury split, or None when the family has no usable
    structure (the engine then keeps a dense explicit inverse).

    ``narrow_k``: rows with more non-zeros than this are coupling rows
    (each contributes a rank-1 term, handled through Woodbury).  Union-find
    over narrow-row supports yields variable components; the split is
    usable when the largest component stays small (batched block
    factorization) and the coupling rank r is moderate (dense (r, r) cap
    solve)."""
    rows, cols, vals, m, n = _as_numpy_coo(A)
    if rows.size == 0:
        return None
    counts = np.bincount(rows, minlength=m)
    wide_mask = counts > narrow_k
    wide_rows = np.flatnonzero(wide_mask)
    if wide_rows.size > max_coupling:
        return None
    narrow_sel = ~wide_mask[rows]
    nr, nc = rows[narrow_sel], cols[narrow_sel]

    # union-find over narrow-row supports
    parent = np.arange(n)

    def find(a):
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    # link all columns of a narrow row to its first column
    order = np.argsort(nr, kind="stable")
    nr_s, nc_s = nr[order], nc[order]
    starts = np.searchsorted(nr_s, np.unique(nr_s))
    bounds = np.append(starts, nr_s.size)
    for i in range(len(starts)):
        seg = nc_s[bounds[i]:bounds[i + 1]]
        r0 = find(seg[0])
        for c in seg[1:]:
            rc = find(c)
            if rc != r0:
                parent[rc] = r0
    roots = np.array([find(v) for v in range(n)])
    _, comp = np.unique(roots, return_inverse=True)
    n_comp = comp.max() + 1
    sizes = np.bincount(comp, minlength=n_comp)
    if sizes.max() > max_block or n_comp < min_blocks:
        return None

    # narrow-row -> component (all its columns share one, by construction)
    row_comp = np.full(m, -1)
    row_comp[nr] = comp[nc]
    narrow_rows = np.flatnonzero(row_comp >= 0)

    # bucket components by padded size (next power of two, min 8)
    pad = np.maximum(
        8, 2 ** np.ceil(np.log2(np.maximum(sizes, 1))).astype(int))
    buckets = []
    for bs in np.unique(pad):
        comp_ids = np.flatnonzero(pad == bs)
        nb = comp_ids.size
        bvars = np.full((nb, bs), n, np.int32)        # n = dummy var slot
        rows_per = []
        for j, cid in enumerate(comp_ids):
            vs = np.flatnonzero(comp == cid)
            bvars[j, :vs.size] = vs
            rows_per.append(np.flatnonzero(row_comp == cid))
        mb = max(1, max(r.size for r in rows_per))
        brows = np.full((nb, mb), m, np.int32)        # m = dummy row slot
        for j, rws in enumerate(rows_per):
            brows[j, :rws.size] = rws
        buckets.append((bvars, brows))
    return KKTStructure(narrow_rows=narrow_rows, wide_rows=wide_rows,
                        buckets=tuple(buckets), n=n, m=m)
