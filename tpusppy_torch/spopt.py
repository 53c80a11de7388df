"""SPOpt: batched subproblem solving and expectation reductions.

Port of the host path of ``tpusppy/spopt.py``: the whole local batch is ONE
batched ADMM call on the device, warm-started between calls, with the
factorization amortized over ``solver_refresh_every`` calls (frozen solves in
between) and a host-exact rescue of the scenarios a refresh leaves
unconverged.  A batch with a shared constraint matrix (``A_shared``) runs the
shared-A engine (:mod:`.solvers.shared_admm`) on the single (m, n) matrix,
dense or, when large and very sparse, as a :class:`~.solvers.sparse.SparseA`
(the sparse and structured-KKT engines).  A shape-bucketed batch
(:class:`~.ir.BucketedBatch`) solves bucket by bucket, each bucket on its
own amortization slot and engine (:func:`bucket_shared`), scattered back
into the padded bookkeeping layout.

Big constraint matrices go up through a content-keyed device cache
(:func:`_device_A`): the cylinders of a wheel that build the same matrix
hold one device copy of it, which nothing writes (factors and kernel
operands derived from it stay per owner).

Expectations are probability-weighted contractions on the host.
Fixing (:meth:`SPOpt.fix_nonants`) clamps the nonant columns' bounds for the
solves and the certified bounds that follow, and
:meth:`SPOpt.dual_donor_bounds` certifies outer bounds from a few
host-exact donor duals.  :meth:`SPOpt._megastep_solve` runs one PH megastep
window (:mod:`.parallel.sharded`) on the frozen-amortization slot, with
its one packed fetch; :meth:`SPOpt._megastep_solve_bucketed` runs one over
every bucket's slot.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import itertools
import threading
import time

import numpy as np
import scipy.sparse as sp
import torch

from . import global_toc
from .ir import BucketedBatch, batch_parts
from .obs import metrics as _metrics
from .obs import trace as _trace
from .parallel import sharded
from .spbase import SPBase
from .solvers import (admm, cuda_kernels, hostsync, integer, segmented,
                      shared_admm)
from .solvers.sparse import SparseA, should_sparsify

_BATCH_TOKENS = itertools.count(1)


def _batch_token(b):
    """Monotone identity token for cache keys (never reused, unlike id())."""
    tok = getattr(b, "_sig_token", None)
    if tok is None:
        tok = next(_BATCH_TOKENS)
        b._sig_token = tok
    return tok


# The content-keyed device cache of big constraint matrices: keyed by the
# sha1 of their bytes, the newest prior entry of a (shape, dtype, kind) kept
# beside the current one, at most four in all.  Cylinder threads reach their
# first solve together, and hashing and uploading drop the interpreter
# lock: the lock keeps them from each uploading a copy.
_DEV_A_CACHE: dict = collections.OrderedDict()
_DEV_A_LOCK = threading.Lock()

#: Below this many bytes a matrix is uploaded as it is, not hashed.
DEV_A_CACHE_MIN_BYTES = 16 << 20


def _cached_dev_A(A_np, tag_key, build):
    """The device matrix of ``A_np`` from the content-keyed cache, built by
    ``build()`` on a miss (``tpusppy/spopt.py:56``): a new digest at the
    same (shape, dtype, kind) drops all but the newest prior entry, and
    the cache holds at most four."""
    with _DEV_A_LOCK:
        digest = hashlib.sha1(
            memoryview(np.ascontiguousarray(A_np))).hexdigest()
        key = (digest,) + tag_key
        dev = _DEV_A_CACHE.pop(key, None)
        if dev is None:
            same = [k for k in _DEV_A_CACHE if k[1:] == key[1:]]
            for k in same[:-1]:
                del _DEV_A_CACHE[k]
            dev = build()
        _DEV_A_CACHE[key] = dev         # re-insert: the LRU touch
        while len(_DEV_A_CACHE) > 4:
            _DEV_A_CACHE.popitem(last=False)
        return dev


def _device_A(A_src, dt, device, sparse="auto"):
    """``A_src`` on ``device`` in ``dt``: a 2-D matrix that is large and
    very sparse (or any, with ``sparse=True``) as a :class:`SparseA` with
    its block/Woodbury structure, else a dense tensor; either through the
    content-keyed cache, apart from dense matrices under
    :data:`DEV_A_CACHE_MIN_BYTES`.  What comes out of the cache is shared
    by every caller and is only read."""
    A_np = np.asarray(A_src)
    dev = torch.device(device)
    if A_np.ndim == 2 and (sparse is True or
                           (sparse == "auto" and should_sparsify(A_np))):
        return _cached_dev_A(
            A_np, (A_np.shape, str(dt), str(dev), "sparse"),
            lambda: SparseA.from_dense(A_np, dtype=dt, device=dev,
                                       structure=True))

    def build():
        return admm._tensor(np.ascontiguousarray(A_np), dt, dev)

    if A_np.nbytes < DEV_A_CACHE_MIN_BYTES:
        return build()
    return _cached_dev_A(A_np, (A_np.shape, str(dt), str(dev)), build)


def clear_device_caches():
    """Release the content-keyed device-A cache."""
    with _DEV_A_LOCK:
        _DEV_A_CACHE.clear()


def batch_solve_dispatch(b, q, q2, cl, cu, lb, ub, settings, warm=None,
                         rows=None, tile=1, device=None):
    """One batched solve of the ScenarioBatch ``b``'s constraint matrix with
    the caller's objective and bound arrays: the shared-A engine on the
    one (m, n) ``A_shared`` where there is one (never the (S, m, n)
    view), else the dense per-scenario tensor, sliced by ``rows`` and
    repeated ``tile`` times to match the arrays' leading axis."""
    if getattr(b, "A_shared", None) is not None:
        return shared_admm.solve_shared(q, q2, b.A_shared, cl, cu, lb, ub,
                                        settings=settings, warm=warm,
                                        device=device)
    A = b.A if rows is None else b.A[rows]
    if tile > 1:
        A = np.repeat(A, tile, axis=0)
    return admm.solve_batch(q, q2, A, cl, cu, lb, ub, settings=settings,
                            warm=warm, device=device)


def dispatch_A(b):
    """The A device code takes of ``b``: its one (m, n) shared matrix where
    it has one, else the (S, m, n) per-scenario tensor."""
    A_shared = getattr(b, "A_shared", None)
    return b.A if A_shared is None else A_shared


def mega_arrays_for_batch(b, dt, device, sparse="auto"):
    """The device :class:`~.parallel.sharded.PHArrays` of one homogeneous
    ScenarioBatch without an opt object (its own tree's probabilities and
    node one-hot), its A through the content-keyed cache."""
    A_shared = getattr(b, "A_shared", None)
    if A_shared is None:
        sparse = False            # per-scenario A: the dense engine

    def t(v):
        return admm._tensor(np.ascontiguousarray(v), dt, device)

    S = b.num_scenarios
    tree = b.tree
    return sharded.PHArrays(
        c=t(b.c), q2=t(b.q2), A=_device_A(dispatch_A(b), dt, device, sparse),
        cl=t(b.cl), cu=t(b.cu), lb=t(b.lb), ub=t(b.ub),
        const=t(np.broadcast_to(b.const, (S,))), probs=t(tree.scen_prob),
        onehot=t(tree.onehot_sk_n()),
        nid_sk=admm._tensor(tree.nid_sk(), torch.int64, device))


def bucket_shared(sub) -> bool:
    """Whether a bucket's sub-batch runs the shared-A engine: it has a
    shared A and more than one member (a singleton detects identity-shared
    A trivially; the dense engine is as cheap there, and the shared
    engine's batch-level rho adaptation converges differently on some
    bundles)."""
    return getattr(sub, "A_shared", None) is not None \
        and sub.num_scenarios > 1


def _np_dual_objective(q, A, cl, cu, lb, ub, y, x_hint, margin_scale=100.0):
    """Single-scenario numpy twin of :func:`admm.dual_objective` (LP case),
    used by the straggler rescue to validate host duals."""
    base, _ = _np_dual_cut(q, A, cl, cu, lb, ub, y, x_hint,
                           np.zeros(q.shape[0], dtype=bool), margin_scale)
    return base


def _np_dual_cut(q, A, cl, cu, lb, ub, y, x_hint, clamp_mask,
                 margin_scale=100.0):
    """Single-scenario numpy twin of :func:`admm.dual_cut` (LP case)."""
    big = admm.BIG
    cl = np.clip(np.nan_to_num(cl, nan=-big), -big, big)
    cu = np.clip(np.nan_to_num(cu, nan=big), -big, big)
    fin_cl, fin_cu = cl > -big / 2, cu < big / 2
    fin_lb, fin_ub = lb > -big / 2, ub < big / 2
    y = np.where(~fin_cu & (y > 0), 0.0, y)
    y = np.where(~fin_cl & (y < 0), 0.0, y)
    row = (-np.maximum(y, 0) * np.where(fin_cu, cu, 0.0)
           - np.minimum(y, 0) * np.where(fin_cl, cl, 0.0)).sum()
    X = margin_scale * (1.0 + np.abs(x_hint).max())
    L = np.where(fin_lb, np.maximum(lb, -big), -X)
    U = np.where(fin_ub, np.minimum(ub, big), X)
    g = q + A.T @ y
    term = g * np.where(g >= 0, L, U)
    base = float(row + np.where(clamp_mask, 0.0, term).sum())
    return base, g


def _certified_dual_eval(args):
    """(dvals, margin): the weak-duality bound with its X-cap margin, as ONE
    device evaluation and ONE fetch."""
    packed = np.asarray(
        hostsync.fetch(admm.dual_objective_with_margin(*args)), dtype=float)
    return packed[0], packed[1]


def _pick_dual_sign(q, A, cl, cu, lb, ub, duals, x, obj):
    """scipy's marginal sign convention is opposite ours and varies by
    constraint shape: pick the sign whose dual objective is closest to the
    primal optimum.  Returns y."""
    best = None
    for sign in (-1.0, 1.0):
        ys = sign * duals
        dval = _np_dual_objective(q, A, cl, cu, lb, ub, ys, x)
        if best is None or abs(obj - dval) < abs(best[0]):
            best = (obj - dval, ys)
    return best[1]


class SPOpt(SPBase):
    """Adds solving to SPBase."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._warm = None            # (x, z, y, yx) of the last solve
        self.local_x = None          # (S, n) last solution (host)
        self.pri_res = None
        self.dua_res = None
        self._factors = None         # admm.Factors of the last refresh solve
        self._factors_sig = None
        self._factors_age = 0
        self._factors_ref_worst = None   # worst residual of the last refresh
        self._n_div_prev = 0
        self._fixed_lb = None        # nonant fixing overlay (S, n) or None
        self._fixed_ub = None
        self.solves = 0              # solve_loop calls
        self.rescued_scenarios = 0   # host-exact straggler re-solves
        self._dev_state = None       # lean megastep windows' device state
        #: what the megastep windows launched, between each window's first
        #: step and its fetch: ``{(table, kernel): n}`` as
        #: :func:`.solvers.cuda_kernels.counts`
        self.window_launches = {}
        #: the same, one dict a bucket, from a bucketed batch's windows
        #: (each bucket's frozen solves)
        self.bucket_window_launches = []
        #: the integer bound passes' launches, one dict an evaluation: each
        #: candidate's, then the reduced-cost re-certification's; on a
        #: bucketed batch one such list a bucket, for the plain pass too
        #: (its one evaluation)
        self.bound_pass_launches = []

    def _device_consts(self, dt):
        """Device-resident (A, cl, cu), cached on batch identity/version:
        the constraint tensor never changes between solves.  A shared-A
        batch uploads its single (m, n) matrix, never the (S, m, n)
        broadcast view; a large, very sparse one (or any, with option
        ``sparse_device_A=True``) goes up as a :class:`SparseA` with its
        block/Woodbury structure and ELL twin (``"auto"``, the default,
        asks :func:`~.solvers.sparse.should_sparsify`; False keeps it
        dense).  A goes through :func:`_device_A`'s content-keyed cache,
        so objects that build the same matrix share one device copy."""
        b = self.batch
        key = (_batch_token(b), getattr(b, "version", 0), dt)
        cached = getattr(self, "_dev_consts", None)
        if cached is None or cached[0] != key:
            def t(v):
                return admm._tensor(np.ascontiguousarray(v), dt, self.device)
            sparse = (False if b.A_shared is None
                      else self.options.get("sparse_device_A", "auto"))
            A_dev = _device_A(dispatch_A(b), dt, self.device, sparse)
            cached = (key, (A_dev, t(b.cl), t(b.cu)))
            self._dev_consts = cached
        return cached[1]

    def _solve_sig(self, q2, lb, ub):
        """Validity signature of cached Factors: (A, q2, rho patterns); rho
        patterns depend only on which rows/columns are equalities, clamped
        or finite — not on bound values."""
        lb = np.asarray(lb)
        ub = np.asarray(ub)
        patt = ((np.abs(ub - lb) < 1e-10).astype(np.uint8)
                + 2 * (lb > -admm.BIG / 2).astype(np.uint8)
                + 4 * (ub < admm.BIG / 2).astype(np.uint8))
        return (float(np.sum(np.asarray(q2))), hash(patt.tobytes()),
                _batch_token(self.batch),
                getattr(self.batch, "version", 0), self.admm_settings)

    # ---- the hot loop -------------------------------------------------------
    def solve_loop(self, q=None, q2=None, warm=True, dis_W=None,
                   dis_prox=None):
        """Solve the whole local batch; returns (S, n) solutions (host).

        ``q``/``q2`` override the objective (PH passes its augmented one);
        ``dis_W``/``dis_prox`` are the reference's API and are ignored (the
        caller's ``q`` carries W and prox).
        Factorization-amortized: an adaptive "refresh" solve every
        ``solver_refresh_every`` calls (and whenever the problem structure
        changes) caches the factors; calls in between are sweep-only frozen
        solves, accepted only when they converged (or sit inside the rescue
        tolerance ladder), else re-solved adaptively."""
        ext = getattr(self, "extobject", None)
        if ext is not None:
            ext.pre_solve()
        self.solves += 1
        # a host-path solve supersedes the device-resident window state
        # (the caller synced the host mirrors first)
        self._dev_state = None
        b = self.batch
        q = b.c if q is None else q
        q2 = b.q2 if q2 is None else q2
        lb, ub = self._bounds()
        if isinstance(b, BucketedBatch):
            x = self._solve_loop_bucketed(b, q, q2, lb, ub, warm)
            if ext is not None:
                ext.post_solve()
            return x
        A_d, cl_d, cu_d = self._device_consts(self.admm_settings.tdtype())
        slot = {"warm": self._warm, "factors": self._factors,
                "sig": self._factors_sig, "age": self._factors_age,
                "ref_worst": self._factors_ref_worst,
                "n_div_prev": self._n_div_prev}
        sol, meas = self._solve_amortized(
            (q, q2, A_d, cl_d, cu_d, lb, ub), slot, warm,
            shared=b.A_shared is not None)
        self._warm = slot["warm"]
        self._factors = slot["factors"]
        self._factors_sig = slot["sig"]
        self._factors_age = slot["age"]
        self._factors_ref_worst = slot.get("ref_worst")
        self._n_div_prev = slot["n_div_prev"]
        # everything the iteration reads came back in ONE packed fetch
        self.local_x = meas["x"]
        self.pri_res = meas["pri"]
        self.dua_res = meas["dua"]
        self._last_all_done = bool(meas["all_done"])
        if ext is not None:
            ext.post_solve()
        return self.local_x

    def _solve_loop_bucketed(self, b, q, q2, lb, ub, warm):
        """Bucket-by-bucket solves of a ragged family, each on its compact
        shapes, its device (A, cl, cu) (:meth:`_bucket_device_consts`) and
        its own amortization slot (warm state, factors, age), the shared-A
        engine for a bucket with a real shared A (:func:`bucket_shared`);
        the results scattered into the (S, n_max) bookkeeping layout.  The
        homogeneous slot (``_warm``, ``_factors``) does not apply."""
        S, n_max = b.c.shape
        x_out = np.zeros((S, n_max))
        pri = np.zeros(S)
        dua = np.zeros(S)
        all_done = True
        slots = getattr(self, "_bucket_slots", None)
        if slots is None or len(slots) != len(b.buckets):
            slots = self._bucket_slots = [dict() for _ in b.buckets]
        consts = self._bucket_device_consts(self.admm_settings.tdtype())
        for k, (idx, sub) in enumerate(b.buckets):
            n = sub.num_vars
            A_d, cl_d, cu_d = consts[k]
            args = (np.asarray(q)[idx, :n], np.asarray(q2)[idx, :n],
                    A_d, cl_d, cu_d,
                    np.asarray(lb)[idx, :n], np.asarray(ub)[idx, :n])
            _, meas = self._solve_amortized(
                args, slots[k], warm, shared=bucket_shared(sub),
                rescue_batch=sub)
            x_out[idx, :n] = meas["x"]
            pri[idx] = meas["pri"]
            dua[idx] = meas["dua"]
            all_done = all_done and bool(meas["all_done"])
        self._warm = None
        self._factors = None
        self._last_all_done = all_done
        self.local_x = x_out
        self.pri_res = pri
        self.dua_res = dua
        return x_out

    def _bucket_device_consts(self, dt):
        """Per-bucket device (A, cl, cu), cached on batch identity and
        version: a bucket with a real shared A (:func:`bucket_shared`)
        uploads its one (m, n) matrix, dense, never the broadcast view;
        A goes through the content-keyed cache (:func:`_device_A`)."""
        b = self.batch
        key = (_batch_token(b), getattr(b, "version", 0), dt,
               len(b.buckets))
        cached = getattr(self, "_bucket_dev_consts", None)
        if cached is None or cached[0] != key:
            def t(v):
                return admm._tensor(np.ascontiguousarray(v), dt, self.device)

            consts = [
                (_device_A(sub.A_shared if bucket_shared(sub) else sub.A,
                           dt, self.device, sparse=False),
                 t(sub.cl), t(sub.cu)) for _, sub in b.buckets]
            cached = (key, consts)
            self._bucket_dev_consts = cached
        return cached[1]

    def _fetch_measure(self, sol):
        """ONE device fetch of everything the host reads from a solve."""
        S, n = sol.x.shape
        return admm.measure_unpack(
            hostsync.fetch(admm.measure_pack(sol)), S, n)

    def _solve_amortized(self, args, slot: dict, warm: bool, shared=False,
                         rescue_batch=None):
        """Frozen attempt under a validity signature, else an adaptive
        factored solve + straggler rescue.  ``slot`` carries
        warm/factors/sig/age and ``ref_worst``; ``args`` is (q, q2, A, cl,
        cu, lb, ub), with A (m, n) when ``shared`` (the shared-A engine).
        A lowered frozen attempt (``sweep_precision``) that the guard
        (:func:`~.solvers.admm.precision_guard_trips`) finds parked far
        above the last refresh's full-precision floor (``ref_worst``) is
        re-run at "highest" on the same factors, counted in
        ``precision.guard_trips``; ``precision.lowered_solves`` counts the
        lowered frozen attempts and ``precision.lowered_accepted`` those
        whose lowered result the solve took.  The refresh always runs at
        "highest".  ``rescue_batch``: the batch whose rows the straggler
        rescue reads (a bucket's sub-batch; default the opt's).  Returns
        ``(sol, meas)``."""
        if shared:
            frozen_fn = shared_admm.solve_shared_frozen
            factored_fn = shared_admm.solve_shared_factored
        else:
            frozen_fn = admm.solve_batch_frozen
            factored_fn = admm.solve_batch_factored
        refresh_every = self._refresh_every()
        sig = (self._solve_sig(args[1], args[5], args[6])
               if refresh_every > 1 else None)
        sol = meas = None
        if (refresh_every > 1 and warm and slot.get("warm") is not None
                and slot.get("factors") is not None
                and slot.get("sig") == sig
                and slot.get("age", 0) < refresh_every):
            # want_converged=False: the convergence vote rides the packed
            # measurement below instead of a separate done fetch
            with _trace.span(None, "solve.frozen") as _sp:
                cand, _ = segmented.solve_frozen_segmented(
                    frozen_fn, args, slot["factors"], self.admm_settings,
                    warm=slot["warm"], want_converged=False)
                meas_c = self._fetch_measure(cand)
                _metrics.inc("solve.sweeps", meas_c["iters"])
                if _trace.enabled():
                    _sp.add(iters=meas_c["iters"],
                            all_done=meas_c["all_done"])
            worst_c = float(max(np.max(meas_c["pri"]),
                                np.max(meas_c["dua"])))
            lowered = self.admm_settings.sweep_mode() != "highest"
            if lowered:
                _metrics.inc("precision.lowered_solves")
            if admm.precision_guard_trips(
                    cand, self.admm_settings, slot.get("ref_worst"),
                    stats=(worst_c, meas_c["all_done"])):
                lowered = False     # what follows is the re-run's result
                # the lowered frozen solve parked far above the family's
                # full-precision floor: re-run it at "highest" on the same
                # factors (no refactorization)
                _metrics.inc("precision.guard_trips")
                if _trace.enabled():
                    _trace.instant(None, "precision_guard_trip",
                                   worst=worst_c,
                                   ref_worst=slot.get("ref_worst"))
                st_full = dataclasses.replace(self.admm_settings,
                                              sweep_precision="highest")
                with _trace.span(None, "solve.frozen_full_precision"):
                    cand, _ = segmented.solve_frozen_segmented(
                        frozen_fn, args, slot["factors"], st_full,
                        warm=slot["warm"], want_converged=False)
                    meas_c = self._fetch_measure(cand)
                    _metrics.inc("solve.sweeps", meas_c["iters"])
            # accept when converged, or when every scenario already sits
            # inside the rescue-tolerance ladder
            tol_lp, tol_qp = self._straggler_tols()
            tol_s = np.where(
                np.any(np.asarray(args[1]) != 0.0, axis=-1), tol_qp, tol_lp)
            if (meas_c["all_done"]
                    or bool(np.all((meas_c["pri"] <= tol_s)
                                   & (meas_c["dua"] <= tol_s)))):
                sol, meas = cand, meas_c
                slot["age"] = slot.get("age", 0) + 1
                if lowered:
                    _metrics.inc("precision.lowered_accepted")
            else:
                _metrics.inc("solve.frozen_rejected")
        if sol is None:
            # the refresh runs at full precision end to end (doc/
            # precision.md: refresh solves are never lowered), so ref_worst
            # below is a full-precision floor for the guard to anchor on
            st_adpt = self.admm_settings
            if st_adpt.sweep_precision not in (None, "highest"):
                st_adpt = dataclasses.replace(st_adpt,
                                              sweep_precision="highest")
            with _trace.span(None, "solve.refresh"):
                sol, factors, _ = segmented.solve_factored_segmented(
                    frozen_fn, factored_fn, args, st_adpt,
                    warm=slot.get("warm") if warm else None, shared=shared,
                    want_converged=False)
                slot["factors"] = factors
                slot["sig"] = sig
                slot["age"] = 1
                meas = self._fetch_measure(sol)
                _metrics.inc("solve.sweeps", meas["iters"])
            # the full-precision residual floor of this family at this
            # operating point: the guard's reference
            slot["ref_worst"] = float(max(np.max(meas["pri"]),
                                          np.max(meas["dua"])))
            sol, meas = self._rescue_stragglers(
                sol, args[0], args[1], args[5], args[6], batch=rescue_batch,
                meas=meas)
        # divergence observability: billed on the increase only
        n_div = int(np.count_nonzero(~np.isfinite(meas["pri"])))
        new_div = n_div - slot.get("n_div_prev", 0)
        slot["n_div_prev"] = n_div
        if new_div > 0:
            _metrics.inc("solve.divergence_freezes", new_div)
        slot["warm"] = (sol.x, sol.z, sol.y, sol.yx)
        return sol, meas

    def _refresh_every(self) -> int:
        """Frozen-factor refresh cadence."""
        return int(self.options.get("solver_refresh_every", 16) or 0)

    def _straggler_tols(self):
        """(tol_lp, tol_qp) rescue-tolerance ladder: LP scenarios rescue at
        ``straggler_tol`` (default 1e-4); QP (prox-on PH) scenarios only
        past ``straggler_tol_qp`` (default 1e-2)."""
        tol_lp = max(float(self.options.get("straggler_tol", 1e-4)),
                     10.0 * self.admm_settings.eps_rel)
        if "straggler_tol_qp" in self.options:
            tol_qp = max(float(self.options["straggler_tol_qp"]),
                         10.0 * self.admm_settings.eps_rel)
        elif "straggler_tol" in self.options:
            tol_qp = tol_lp
        else:
            tol_qp = max(1e-2, tol_lp)
        return tol_lp, tol_qp

    def _rescue_stragglers(self, sol, q, q2, lb, ub, batch=None, meas=None):
        """Host-exact re-solve of the scenarios batched ADMM left
        unconverged: LPs through HiGHS (duals sign-voted), QPs through the
        batched host IPM.  The aux state (z, y, yx, done) is fetched only
        when stragglers exist.  ``batch``: whose rows (default the opt's).
        Returns ``(sol, meas)``."""
        if meas is None:
            meas = self._fetch_measure(sol)
        if not self.options.get("straggler_rescue", True):
            return sol, meas
        tol_lp, tol_qp = self._straggler_tols()
        pri = meas["pri"]
        dua = meas["dua"]
        q2_np = np.asarray(q2)
        is_qp = np.any(q2_np != 0.0, axis=-1)
        tol_s = np.where(is_qp, tol_qp, tol_lp)
        # negated <= so NaN residuals (diverged solves) are selected too
        bad = np.flatnonzero(~(pri <= tol_s) | ~(dua <= tol_s))
        if bad.size == 0:
            return sol, meas
        from .solvers import scipy_backend

        b = self.batch if batch is None else batch
        q = np.asarray(q, dtype=float)
        q2 = np.asarray(q2, dtype=float)
        lb = np.asarray(lb, dtype=float)
        ub = np.asarray(ub, dtype=float)
        x = np.array(meas["x"], copy=True)
        z, y, yx = hostsync.fetch((sol.z, sol.y, sol.yx))
        pri = pri.copy()
        dua = dua.copy()
        done = hostsync.fetch(sol.done)
        n_resc = 0
        qp_bad = bad[is_qp[bad]]
        if qp_bad.size:
            max_n = int(self.options.get("straggler_qp_max_n", 2000))
            if b.num_vars > max_n:
                if not getattr(self, "_qp_rescue_size_warned", False):
                    self._qp_rescue_size_warned = True
                    global_toc(
                        f"straggler rescue: {qp_bad.size} stalled QP "
                        f"scenario(s) left at batch accuracy (n="
                        f"{b.num_vars} > straggler_qp_max_n={max_n})",
                        True)
                qp_bad = np.empty(0, dtype=int)
            chunk = max(1, int(self.options.get("straggler_qp_chunk", 16)))
            for lo in range(0, qp_bad.size, chunk):
                sl = qp_bad[lo:lo + chunk]
                # a shared-A family passes its one (m, n) matrix
                A_arg = b.A[sl] if b.A_shared is None else b.A_shared
                xb, yb, feas = scipy_backend.solve_qp_batch_with_duals(
                    q[sl], q2[sl], A_arg, b.cl[sl], b.cu[sl], lb[sl],
                    ub[sl])
                for j, s in enumerate(sl):
                    if not feas[j]:
                        continue    # genuine infeasibility: leave residuals
                    xs, ys = xb[j], yb[j]
                    yx[s] = -(q[s] + q2[s] * xs + b.A[s].T @ ys)
                    x[s], y[s] = xs, ys
                    z[s] = b.A[s] @ xs
                    pri[s] = 0.0
                    dua[s] = 0.0
                    done[s] = True
                    n_resc += 1
        lp_bad = bad[~is_qp[bad]]
        max_lp = int(self.options.get("straggler_lp_max", 64))
        if lp_bad.size > max_lp:
            worst = np.argsort(-np.maximum(pri[lp_bad], dua[lp_bad]))
            lp_bad = lp_bad[worst[:max_lp]]
        # a shared-A family converts its one matrix to CSR once per round
        A_csr = (sp.csr_matrix(b.A_shared)
                 if lp_bad.size and b.A_shared is not None else None)
        for s in lp_bad:
            res = scipy_backend.solve_lp_with_duals(
                q[s], b.A[s] if A_csr is None else A_csr, b.cl[s], b.cu[s],
                lb[s], ub[s])
            if not res.feasible or res.duals is None:
                continue        # genuine infeasibility: leave residuals
            xs = res.x
            obj_s = float(q[s] @ xs)
            ys = _pick_dual_sign(q[s], b.A[s], b.cl[s], b.cu[s],
                                 lb[s], ub[s], res.duals, xs, obj_s)
            yxs = -(q[s] + q2[s] * xs + b.A[s].T @ ys)
            x[s], y[s], yx[s] = xs, ys, yxs
            z[s] = b.A[s] @ xs
            pri[s] = 0.0
            dua[s] = 0.0
            done[s] = True
            n_resc += 1
        if n_resc:
            self.rescued_scenarios += n_resc
            _metrics.inc("solve.rescued_scenarios", n_resc)
            global_toc(
                f"straggler rescue: {n_resc}/{b.num_scenarios} scenarios "
                "re-solved host-exact", self.options.get("verbose", False))
        meas = dict(meas, x=x, pri=pri, dua=dua, all_done=bool(done.all()))
        return (sol._replace(x=x, z=z, y=y, yx=yx, pri_res=pri, dua_res=dua,
                             done=done, raw=(x, z, y, yx)), meas)

    # ---- the wheel megastep (N frozen PH iterations a window) ---------------
    def _mega_arrays(self, dt):
        """The window's :class:`~.parallel.sharded.PHArrays` on the device,
        cached on batch identity and version; A, cl and cu are
        :meth:`_device_consts`' (PHBase callers only: it reads the node
        one-hot)."""
        b = self.batch
        key = (_batch_token(b), getattr(b, "version", 0), dt)
        cached = getattr(self, "_mega_arr_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        A_d, cl_d, cu_d = self._device_consts(dt)
        S = b.num_scenarios

        def t(v):
            return admm._tensor(np.ascontiguousarray(v), dt, self.device)

        arr = sharded.PHArrays(
            c=t(b.c), q2=t(b.q2), A=A_d, cl=cl_d, cu=cu_d, lb=t(b.lb),
            ub=t(b.ub), const=t(np.broadcast_to(b.const, (S,))),
            probs=t(self.probs), onehot=t(self._onehot),
            nid_sk=admm._tensor(self.nid_sk, torch.int64, self.device))
        self._mega_arr_cache = (key, arr)
        return arr

    def _device_state_on(self) -> bool:
        """The device-resident posture (option ``ph_device_state``):
        windows fetch the lean measurement, and the host mirrors of x, W
        and xbars are fetched only at the boundaries that read them
        (:meth:`~.phbase.PHBase._sync_host_state`)."""
        return bool(self.options.get("ph_device_state", False))

    def _inwheel_int_mask(self, batch=None):
        """(K,) integer mask of the nonant slots for the in-wheel
        candidate's rounding, or None without integer nonants; ``batch``: a
        bucket's sub-batch (default the opt's)."""
        b = self.batch if batch is None else batch
        mask = np.asarray(b.is_int, bool)[b.tree.nonant_indices]
        return mask if mask.any() else None

    def _inwheel_threshold(self) -> float:
        """Rounding threshold of the in-wheel candidate's integer slots
        (option ``in_wheel_xhat_threshold``)."""
        return float(self.options.get("in_wheel_xhat_threshold", 0.5))

    def _inwheel_int_thresholds(self):
        """The batched integer sweep's rounding ladder, or None where the
        sweep is off: no integer nonants, or option ``in_wheel_int_sweep``
        False.  The option ``in_wheel_int_thresholds``, else
        :data:`.solvers.integer.DEFAULT_THRESHOLDS` (the reference's
        resolution with an empty tune cache: the autotuned ladder,
        ``in_wheel_int_autotune``, is not ported)."""
        if all(self._inwheel_int_mask(batch=sub) is None
               for _, sub in batch_parts(self.batch)):
            return None
        if not self.options.get("in_wheel_int_sweep", True):
            return None
        th = self.options.get("in_wheel_int_thresholds")
        return tuple(float(t) for t in (th or integer.DEFAULT_THRESHOLDS))

    def _inwheel_int_sweep_on(self) -> bool:
        """Whether a bound-pass window runs the batched integer sweep (and
        packs its longer tail)."""
        return self._inwheel_int_thresholds() is not None

    def _inwheel_pass_evals(self) -> int:
        """Frozen evaluations of ONE in-wheel bound pass (the window cap's
        reservation and the billing unit): 1 for the plain pass; the
        ladder, the two slams (not on a bucketed batch, whose pass drops
        them) and, where fixing is safe for the family
        (:meth:`~.phbase.PHBase._inwheel_inner_ok`), the re-certification
        for the integer sweep."""
        th = self._inwheel_int_thresholds()
        if th is None:
            return 1
        c = (len(th) if isinstance(self.batch, BucketedBatch)
             else integer.n_candidates(th))
        return c + (1 if self._inwheel_inner_ok() else 0)

    def _megastep_fn(self, n_req: int, pack: str = "full",
                     bounds: bool = False):
        """The window function at width ``n_req`` (one per (N, pack,
        bounds); ``n_live`` and ``bound_live`` are call arguments).  With
        ``bounds`` on a family with integer nonants the window runs the
        integer pass, its fixing off where the family carries second-stage
        integers."""
        cache = getattr(self, "_mega_fn_cache", None)
        if cache is None:
            cache = self._mega_fn_cache = {}
        fn = cache.get((n_req, pack, bounds))
        if fn is None:
            int_rounding = (self._inwheel_int_thresholds() if bounds
                            else None)
            fn = cache[(n_req, pack, bounds)] = sharded.make_wheel_megastep(
                self.tree.nonant_indices, self.admm_settings,
                n_iters=n_req, pack=pack, bounds=bounds,
                int_nonants=self._inwheel_int_mask() if bounds else None,
                xhat_threshold=(self._inwheel_threshold() if bounds
                                else 0.5),
                int_rounding=int_rounding,
                int_cols=(np.asarray(self.batch.is_int, bool)
                          if int_rounding else None),
                # fixing is certificate-safe only where the candidate's
                # evaluation is at an integer-feasible point: every integer
                # column a nonant slot
                int_rcfix=(self._inwheel_inner_ok() if int_rounding
                           else True))
        return fn

    def _megastep_solve(self, n_req: int, n_live: int, convthresh: float,
                        W, xbars, rho, bound_live=None):
        """Run ONE megastep window and fetch its packed measurement: the
        twin of ``n_live`` frozen :meth:`_solve_amortized` iterations on the
        same amortization slot.  The warm slot becomes the window's final
        state (rebound before the fetch), the factors' age advances by
        the executed count, and the window is billed
        (:func:`.solvers.segmented.bill_megastep`).  The precision guard
        reads the packed per-iteration residuals; an iterate the window
        rejected, or a guard trip, maxes the factors' age so the next
        iteration refreshes.  ``bound_live`` (None: no bound pass in the
        window) runs the in-wheel bound pass where True.  Returns the
        unpacked measurement."""
        st = self.admm_settings
        dt = st.tdtype()
        arr = self._mega_arrays(dt)
        b = self.batch
        S, n, m = b.num_scenarios, b.num_vars, b.num_rows
        K = self.nonant_length
        pack = "lean" if self._device_state_on() else "full"
        state = self._dev_state
        if state is None:
            def t(v):
                return admm._tensor(v, dt, self.device)

            warm = self._warm
            state = sharded.PHState(
                W=t(W), xbars=t(xbars), rho=t(rho), x=t(warm[0]),
                z=t(warm[1]), y=t(warm[2]), yx=t(warm[3]))
        # the window solves the PH prox objective: every scenario is a QP
        _, tol_qp = self._straggler_tols()
        bounds = bound_live is not None
        int_sweep = bounds and self._inwheel_int_sweep_on()
        extra = {}
        if bounds:
            extra = dict(bound_live=bool(bound_live),
                         feas_tol=self._inwheel_feas_tol())
        if int_sweep:
            n_ev = integer.n_candidates(self._inwheel_int_thresholds()) + 1
            if len(self.bound_pass_launches) != n_ev:
                self.bound_pass_launches = [{} for _ in range(n_ev)]
            extra["bound_launches"] = self.bound_pass_launches
        with _trace.span(None, "solve.megastep") as _sp:
            fn = self._megastep_fn(n_req, pack, bounds=bounds)
            before = cuda_kernels.counts(local=True)
            state, packed = fn(state, arr, 1.0, self._factors, convthresh,
                               n_live, tol_qp, **extra)
            # the warm slot first: a failed fetch must not leave it on the
            # previous window's state
            self._warm = (state.x, state.z, state.y, state.yx)
            self._dev_state = state if pack == "lean" else None
            for k, v in cuda_kernels.counts(local=True).items():
                if v != before[k]:
                    self.window_launches[k] = (self.window_launches.get(k, 0)
                                               + v - before[k])
            meas = sharded.megastep_unpack(hostsync.fetch(packed), n_req, S,
                                           n, K, pack=pack, bounds=bounds,
                                           int_sweep=int_sweep)
            if _trace.enabled():
                _sp.add(n_live=n_live, executed=meas["executed"],
                        refresh_hit=meas["refresh_hit"],
                        bound_pass=bool(meas.get("bound_computed")))
        executed = meas["executed"]
        self._factors_age += executed
        sf = (segmented.SPARSE_DISPATCH_FACTOR
              if isinstance(arr.A, SparseA) else 1.0)
        iters = meas["iters"]
        sweeps = float(np.mean(iters[:executed])) if executed else 0.0
        # a rejected iterate is swept and discarded work: its stats sit at
        # index ``executed``
        rej = (float(iters[executed])
               if meas["refresh_hit"] and executed < n_req else None)
        segmented.bill_megastep(S, n, m, executed, sweeps, sparse_factor=sf,
                                rejected_sweeps=rej)
        _metrics.inc("solve.sweeps", float(np.sum(iters[:executed]))
                     + (rej or 0.0))
        if meas.get("bound_computed"):
            segmented.bill_bound_pass(S, n, m, meas["bound_sweeps"],
                                      sparse_factor=sf,
                                      n_evals=self._inwheel_pass_evals())
        guard = False
        if executed:
            # the guard on EVERY accepted iterate, from the packed worst
            # residuals; a window cannot re-run at full precision, so a
            # trip sends the next iteration to the (full-precision) refresh
            ref = self._factors_ref_worst
            worsts = np.maximum(meas["pri_max"][:executed],
                                meas["dua_max"][:executed])
            guard = any(
                admm.precision_guard_trips(
                    None, st, ref,
                    stats=(float(worsts[i]), bool(meas["all_done"][i])))
                for i in range(executed))
            if guard:
                _metrics.inc("precision.guard_trips")
        if meas["refresh_hit"] or guard:
            self._factors_age = max(self._factors_age, self._refresh_every())
            _metrics.inc("megastep.refresh_hits")
        return meas

    def _mega_arrays_bucketed(self, dt):
        """Per-bucket :class:`~.parallel.sharded.PHArrays` of the bucketed
        window, cached on batch identity and version: each bucket's
        compact problem data (A, cl and cu from
        :meth:`_bucket_device_consts`) with its rows of the GLOBAL tree's
        probabilities, node one-hot and node ids, through which the window's
        PH update couples the buckets (the bucket-local probabilities never
        enter it)."""
        b = self.batch
        key = (_batch_token(b), getattr(b, "version", 0), dt)
        cached = getattr(self, "_mega_arr_bucket_cache", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        consts = self._bucket_device_consts(dt)

        def t(v):
            return admm._tensor(np.ascontiguousarray(v), dt, self.device)

        arrs = []
        for (idx, sub), (A_d, cl_d, cu_d) in zip(b.buckets, consts):
            arrs.append(sharded.PHArrays(
                c=t(sub.c), q2=t(sub.q2), A=A_d, cl=cl_d, cu=cu_d,
                lb=t(sub.lb), ub=t(sub.ub),
                const=t(np.broadcast_to(sub.const, (idx.size,))),
                probs=t(self.probs[idx]), onehot=t(self._onehot[idx]),
                nid_sk=admm._tensor(self.nid_sk[idx], torch.int64,
                                    self.device)))
        arrs = tuple(arrs)
        self._mega_arr_bucket_cache = (key, arrs)
        return arrs

    def _bucketed_megastep_fn(self, n_req: int, bounds: bool = False):
        """The bucketed window function at width ``n_req``; with
        ``bounds``, each bucket's integer nonant mask (bucketing keys on
        the integer pattern) and, for the integer sweep, its integer
        columns, the fixing off where the family carries second-stage
        integers."""
        cache = getattr(self, "_mega_fn_cache", None)
        if cache is None:
            cache = self._mega_fn_cache = {}
        keyb = ("bucketed", n_req, bounds)
        fn = cache.get(keyb)
        if fn is None:
            subs = [sub for _, sub in self.batch.buckets]
            int_rounding = (self._inwheel_int_thresholds() if bounds
                            else None)
            fn = cache[keyb] = sharded.make_bucketed_wheel_megastep(
                self.tree.nonant_indices, self.admm_settings,
                n_iters=n_req, bounds=bounds,
                int_nonants=(tuple(self._inwheel_int_mask(batch=sub)
                                   for sub in subs) if bounds else None),
                xhat_threshold=(self._inwheel_threshold() if bounds
                                else 0.5),
                int_rounding=int_rounding,
                int_cols=(tuple(np.asarray(sub.is_int, bool)
                                for sub in subs) if int_rounding else None),
                int_rcfix=(self._inwheel_inner_ok() if int_rounding
                           else True))
        return fn

    def _megastep_solve_bucketed(self, n_req: int, n_live: int,
                                 convthresh: float, W, xbars, rho,
                                 bound_live=None):
        """The bucketed twin of :meth:`_megastep_solve`: one window of
        ``n_live`` PH iterations over every bucket's compact shapes and
        amortization slot, its packed per-bucket blocks scattered through
        each bucket's scenario indices into the global layout.  Each
        bucket's slot advances as its frozen host solves would have (warm
        state rebound before the fetch, age += executed, a rejected iterate
        or guard trip maxing the age), and each bucket is billed on its own
        shapes, the window counted once.  Windows fetch the full pack (the
        lean posture of ``ph_device_state`` is the homogeneous path's).
        ``bound_live`` (None: no bound pass) runs the bucketed bound pass
        where True; its measurement keys are the homogeneous path's, and
        :attr:`bound_pass_launches` receives its launches by bucket, then
        by evaluation (the integer pass's C candidates and the
        re-certification; the plain pass's one).  Returns the global
        measurement."""
        st = self.admm_settings
        dt = st.tdtype()
        if self._device_state_on() and \
                not getattr(self, "_bucketed_lean_warned", False):
            self._bucketed_lean_warned = True
            global_toc(
                "ph_device_state: bucketed families run full-pack windows "
                "(the lean posture is the homogeneous path's)", True)
        arrs = self._mega_arrays_bucketed(dt)
        b = self.batch
        slots = self._bucket_slots
        K = self.nonant_length
        W = np.asarray(W)
        xbars = np.asarray(xbars)
        rho = np.asarray(rho)

        def t(v):
            return admm._tensor(v, dt, self.device)

        states = []
        for (idx, sub), slot in zip(b.buckets, slots):
            warm = slot["warm"]
            states.append(sharded.PHState(
                W=t(W[idx]), xbars=t(xbars[idx]), rho=t(rho[idx]),
                x=t(warm[0]), z=t(warm[1]), y=t(warm[2]), yx=t(warm[3])))
        factors = tuple(slot["factors"] for slot in slots)
        _, tol_qp = self._straggler_tols()
        shapes = [(idx.size, sub.num_vars) for idx, sub in b.buckets]
        bounds = bound_live is not None
        int_sweep = bounds and self._inwheel_int_sweep_on()
        extra = {}
        if bounds:
            extra = dict(bound_live=bool(bound_live),
                         feas_tol=self._inwheel_feas_tol())
            n_ev = (len(self._inwheel_int_thresholds()) + 1 if int_sweep
                    else 1)
            if [len(r) if isinstance(r, list) else -1
                    for r in self.bound_pass_launches] != [n_ev] * len(arrs):
                self.bound_pass_launches = [[{} for _ in range(n_ev)]
                                            for _ in arrs]
            extra["bound_launches"] = self.bound_pass_launches
        with _trace.span(None, "solve.megastep") as _sp:
            fn = self._bucketed_megastep_fn(n_req, bounds=bounds)
            before = cuda_kernels.counts(local=True)
            if len(self.bucket_window_launches) != len(arrs):
                self.bucket_window_launches = [{} for _ in arrs]
            states, packed = fn(tuple(states), arrs, 1.0, factors,
                                convthresh, n_live, tol_qp,
                                bucket_launches=self.bucket_window_launches,
                                **extra)
            for slot, stb in zip(slots, states):
                slot["warm"] = (stb.x, stb.z, stb.y, stb.yx)
            for k, v in cuda_kernels.counts(local=True).items():
                if v != before[k]:
                    self.window_launches[k] = (self.window_launches.get(k, 0)
                                               + v - before[k])
            bmeas = sharded.bucketed_megastep_unpack(
                hostsync.fetch(packed), n_req, shapes, K, bounds=bounds,
                int_sweep=int_sweep)
            if _trace.enabled():
                _sp.add(n_live=n_live, executed=bmeas["executed"],
                        refresh_hit=bmeas["refresh_hit"], buckets=len(arrs))
        executed = bmeas["executed"]
        S, n_max = b.num_scenarios, b.num_vars
        meas = {k: bmeas[k] for k in (
            "conv", "eobj", "pri_max", "dua_max", "iters", "all_done",
            "executed", "refresh_hit")}
        if bounds:
            meas.update({k: bmeas[k] for k in (
                "bound_computed", "bound_outer", "bound_inner_obj",
                "bound_inner_feas", "bound_sweeps")})
            for k in ("int_feas_cands", "int_best_idx", "int_rcfix_slots",
                      "bound_outer_base"):
                if k in bmeas:
                    meas[k] = bmeas[k]
        pri = np.zeros(S)
        dua = np.zeros(S)
        done = np.zeros(S, dtype=bool)
        x = np.zeros((S, n_max))
        Wg = np.zeros((S, K))
        xbg = np.zeros((S, K))
        for bi, (idx, sub) in enumerate(b.buckets):
            pri[idx] = bmeas["pri"][bi]
            dua[idx] = bmeas["dua"][bi]
            done[idx] = bmeas["done"][bi]
            x[idx, :sub.num_vars] = bmeas["x"][bi]
            Wg[idx] = bmeas["W"][bi]
            xbg[idx] = bmeas["xbars"][bi]
        meas.update(pri=pri, dua=dua, done=done, x=x, W=Wg, xbars=xbg)
        guard = False
        if executed:
            refs = [slot.get("ref_worst") for slot in slots]
            ref = (max(r or 0.0 for r in refs)
                   if any(r is not None for r in refs) else None)
            worsts = np.maximum(meas["pri_max"][:executed],
                                meas["dua_max"][:executed])
            guard = any(
                admm.precision_guard_trips(
                    None, st, ref,
                    stats=(float(worsts[i]), bool(meas["all_done"][i])))
                for i in range(executed))
            if guard:
                _metrics.inc("precision.guard_trips")
        iters = meas["iters"]
        sweeps = float(np.mean(iters[:executed])) if executed else 0.0
        rej = (float(iters[executed])
               if meas["refresh_hit"] and executed < n_req else None)
        _metrics.inc("solve.sweeps", float(np.sum(iters[:executed]))
                     + (rej or 0.0))
        refresh_every = self._refresh_every()
        pass_evals = (self._inwheel_pass_evals()
                      if meas.get("bound_computed") else 1)
        for bi, (slot, (idx, sub)) in enumerate(zip(slots, b.buckets)):
            # the packed sweep count is the buckets' max: each bucket is
            # billed at it on its own shapes, the window and its pass
            # counted once
            segmented.bill_megastep(idx.size, sub.num_vars, sub.num_rows,
                                    executed, sweeps, rejected_sweeps=rej,
                                    count_dispatch=bi == 0)
            if meas.get("bound_computed"):
                segmented.bill_bound_pass(
                    idx.size, sub.num_vars, sub.num_rows,
                    meas["bound_sweeps"], count_pass=bi == 0,
                    n_evals=pass_evals)
            slot["age"] = slot.get("age", 0) + executed
            if meas["refresh_hit"] or guard:
                slot["age"] = max(slot["age"], refresh_every)
        if meas["refresh_hit"] or guard:
            _metrics.inc("megastep.refresh_hits")
        return meas

    # ---- expectations -------------------------------------------------------
    def Eobjective(self, x=None) -> float:
        """Probability-weighted expected objective (spopt.py:310-345)."""
        x = self.local_x if x is None else np.asarray(x)
        return float(self.probs @ self.batch.objective(x))

    def Ebound(self, x=None, extra_obj=None) -> float:
        """Expected bound from current subproblem objectives
        (spopt.py:346-393); ``extra_obj``: (S,) additive per-scenario
        terms (W.x, say)."""
        x = self.local_x if x is None else np.asarray(x)
        vals = self.batch.objective(x)
        if extra_obj is not None:
            vals = vals + np.asarray(extra_obj)
        return float(self.probs @ vals)

    def Edualbound(self, q=None, q2=None) -> float:
        """Expectation of :meth:`Edualbound_perscen`."""
        return float(self.probs @ self.Edualbound_perscen(q, q2))

    def Edualbound_perscen(self, q=None, q2=None) -> np.ndarray:
        """CERTIFIED per-scenario outer bounds ((S,)) from the last solve's
        row duals (weak duality: solver tolerance can only weaken the
        bound, never invalidate it); per bucket on a bucketed batch."""
        if isinstance(self.batch, BucketedBatch):
            return self._Edualbound_bucketed_perscen(q, q2)
        if self._warm is None:
            raise RuntimeError("Edualbound requires a prior solve_loop")
        b = self.batch
        q = b.c if q is None else q
        q2 = b.q2 if q2 is None else q2
        lb, ub = self._bounds()
        x, _, y, _ = self._warm
        dt = self.admm_settings.tdtype()
        A_d, cl_d, cu_d = self._device_consts(dt)

        def t(v):
            return admm._tensor(v, dt, self.device)

        args = (t(q), t(q2), A_d, cl_d, cu_d, t(lb), t(ub), t(y), t(x))
        dvals, margin = _certified_dual_eval(args)
        self.last_bound_margin = margin
        return dvals - margin + b.const

    def _Edualbound_bucketed_perscen(self, q=None, q2=None) -> np.ndarray:
        """The certified per-scenario bounds of a bucketed batch: the
        weak-duality assembly on each bucket's compact shapes with its
        slot's last duals, scattered back."""
        b = self.batch
        slots = getattr(self, "_bucket_slots", None)
        if (not slots or len(slots) != len(b.buckets)
                or any(s.get("warm") is None for s in slots)):
            raise RuntimeError("Edualbound requires a prior solve_loop")
        q = np.asarray(b.c if q is None else q)
        q2 = np.asarray(b.q2 if q2 is None else q2)
        lb, ub = (np.asarray(v) for v in self._bounds())
        dt = self.admm_settings.tdtype()
        consts = self._bucket_device_consts(dt)

        def t(v):
            return admm._tensor(v, dt, self.device)

        vals = np.zeros(b.num_scenarios)
        margin_out = np.zeros(b.num_scenarios)
        for (idx, sub), slot, (A_d, cl_d, cu_d) in zip(b.buckets, slots,
                                                      consts):
            n = sub.num_vars
            x, _, y, _ = slot["warm"]
            args = (t(q[idx, :n]), t(q2[idx, :n]), A_d, cl_d, cu_d,
                    t(lb[idx, :n]), t(ub[idx, :n]), t(y), t(x))
            dv, mg = _certified_dual_eval(args)
            vals[idx] = dv
            margin_out[idx] = mg
        self.last_bound_margin = margin_out
        return vals - margin_out + b.const

    def dual_donor_bounds(self, q=None, q2=None, k=16, budget_s=90.0,
                          time_limit=30.0,
                          refresh_every=4) -> np.ndarray | None:
        """(S,) certified bounds from exact donor duals, transferred batch
        wide (``tpusppy/spopt.py:1291-1406``).  Weak duality accepts any y
        for any scenario: ``k`` donor scenarios are solved host-exact
        (HiGHS, with their own objective rows of ``q``), and each donor's
        dual is evaluated against every scenario on the device
        (:func:`_certified_dual_eval` on the engine's device constants, a
        :class:`SparseA` where the batch went up as one), keeping the
        per-scenario best.  The duals are cached: a y found for an earlier
        W certifies any later q, so the host LPs run again only every
        ``refresh_every``-th call.  ``time_limit`` caps each donor LP,
        ``budget_s`` all of a refresh's.  Returns None when no donor dual
        is available (every LP failed, or the batch is bucketed: it has no
        homogeneous warm state)."""
        from .solvers import scipy_backend

        b = self.batch
        if isinstance(b, BucketedBatch):
            return None       # no homogeneous warm state to bound from
        q = np.asarray(b.c if q is None else q, dtype=float)
        q2 = np.asarray(b.q2 if q2 is None else q2, dtype=float)
        lb, ub = (np.asarray(v) for v in self._bounds())
        S = b.num_scenarios
        if self._warm is not None:
            x_hint = np.asarray(self._warm[0])
        else:
            # no batched solve yet (the Lagrangian spoke may skip it): a
            # hint sized from the finite problem data keeps the X-cap box
            # far outside any reachable optimizer
            finite_max = 1.0
            for arr in (b.cl, b.cu, lb, ub):
                fa = np.abs(arr[np.isfinite(arr)])
                if fa.size:
                    finite_max = max(finite_max, float(fa.max()))
            x_hint = np.full((S, b.num_vars), finite_max)
        cache = getattr(self, "_donor_dual_cache", None)
        age = getattr(self, "_donor_dual_age", 0)
        if cache is None or age >= max(1, int(refresh_every)):
            sel = np.unique(
                np.linspace(0, S - 1, min(int(k), S)).astype(int))
            A_csr = (sp.csr_matrix(b.A_shared)
                     if b.A_shared is not None else None)
            deadline = time.monotonic() + float(budget_s)
            cache = []
            for s_k in sel:
                remaining = deadline - time.monotonic()
                if remaining <= 1.0:
                    break
                res = scipy_backend.solve_lp_with_duals(
                    q[s_k], A_csr if A_csr is not None else b.A[s_k],
                    b.cl[s_k], b.cu[s_k], lb[s_k], ub[s_k],
                    time_limit=min(float(time_limit), remaining))
                if not res.feasible or res.duals is None:
                    continue
                obj_k = float(q[s_k] @ res.x)
                cache.append(_pick_dual_sign(
                    q[s_k], b.A[s_k], b.cl[s_k], b.cu[s_k],
                    lb[s_k], ub[s_k], res.duals, res.x, obj_k))
            if not cache:
                # nothing new: keep the previous duals (still
                # certificates), or leave the cache unset so the next call
                # retries
                prev = getattr(self, "_donor_dual_cache", None)
                if prev:
                    cache = prev
                else:
                    self._donor_dual_cache = None
                    self._donor_dual_age = 0
                    return None
            self._donor_dual_cache = cache
            age = 0
        self._donor_dual_age = age + 1
        self.donor_duals_used = len(cache)
        dt = self.admm_settings.tdtype()
        A_d, cl_d, cu_d = self._device_consts(dt)

        def t(v):
            return admm._tensor(v, dt, self.device)

        lb_d, ub_d, q_d, q2_d, xh_d = (t(v) for v in (lb, ub, q, q2, x_hint))
        const = np.asarray(np.broadcast_to(b.const, (S,)))
        best = None
        for y_k in cache:
            y_tiled = t(y_k).expand(S, y_k.size)
            args = (q_d, q2_d, A_d, cl_d, cu_d, lb_d, ub_d, y_tiled, xh_d)
            dvals, margin = _certified_dual_eval(args)
            dv = dvals - margin + const
            best = dv if best is None else np.maximum(best, dv)
        return best

    # ---- nonant fixing (tpusppy/spopt.py:1490-1513) -------------------------
    def _bounds(self):
        """(lb, ub) of the solves: the batch's, or the fixing overlay."""
        b = self.batch
        return (b.lb if self._fixed_lb is None else self._fixed_lb,
                b.ub if self._fixed_ub is None else self._fixed_ub)

    def restore_nonants(self):
        """Drop the fixing overlay."""
        self._fixed_lb = None
        self._fixed_ub = None

    def fix_nonants(self, cache):
        """Clamp the nonant columns to a candidate, lb = ub = value, for the
        solves and certified bounds until :meth:`restore_nonants`.
        ``cache``: (K,) one candidate for every scenario, or (S, K).
        Integer nonants are rounded."""
        b = self.batch
        cache = np.asarray(cache, dtype=float)
        if cache.ndim == 1:
            cache = np.broadcast_to(cache, (b.num_scenarios, cache.shape[0]))
        idx = self.tree.nonant_indices
        ints = b.is_int[idx]
        if np.any(ints):
            cache = np.where(ints[None, :], np.round(cache), cache)
        lb = b.lb.copy()
        ub = b.ub.copy()
        lb[:, idx] = cache
        ub[:, idx] = cache
        self._fixed_lb, self._fixed_ub = lb, ub

    def _inwheel_feas_tol(self) -> float:
        """The feasibility-gate tolerance of :meth:`feas_prob`, Iter0's
        check and the in-wheel evaluation: option ``feas_tol`` floored at
        10x the solver's own eps."""
        return max(float(self.options.get("feas_tol", 1e-3)),
                   10.0 * self.admm_settings.eps_rel)

    def feas_prob(self, tol=None) -> float:
        """Probability mass of scenarios whose ADMM primal residual is
        within tolerance (spopt.py:394-433)."""
        if tol is None:
            tol = self._inwheel_feas_tol()
        if self.pri_res is None:
            return 1.0
        return float(self.probs @ (self.pri_res < tol))

    def infeas_prob(self, tol=None) -> float:
        return 1.0 - self.feas_prob(tol)

    def save_nonants(self):
        """Keep the nonants of the last solve (xhat bookkeeping)."""
        self._cached_nonants = self.nonants_of(self.local_x).copy()
