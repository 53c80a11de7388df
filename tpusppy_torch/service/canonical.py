"""Request canonicalization: model ingest -> batched arrays + family key.

Port of ``tpusppy/service/canonical.py``.  A solve request is ingested
EXACTLY ONCE (:func:`ingest`, the same :func:`..spbase.build_batch`
construction the opt classes run); the resulting :class:`CanonicalModel`
is handed to every cylinder of the wheel through
``options["canonical_model"]`` and fingerprinted into a SHAPE FAMILY key
before anything is built on the device.

Two requests with the same family key run the same device programs: the
same shapes, integer pattern, nonant layout, bucketing, solver settings,
program-shaping options and device.  On the card a program is a set of
CUDA graphs captured over buffers of those shapes
(:mod:`..solvers.device_loop`), held by an owner token; the solve server
keeps one set of owner tokens a family, so a second request of a family
copies its numbers into the captured buffers and captures nothing.  The
shapes sit at the front of the key, so captured graphs are never served
across a shape mismatch.  Coefficient VALUES are absent from the family key
(they are runtime data); :func:`content_fingerprint` is the exact-content
identity, the reference's digest over the same arrays.

The key's shape prefix is the reference's ``shape_family_parts`` tuple and
the constant digests its ``array_digest`` (``tpusppy/solvers/aot.py:201``,
``:238``); the port keeps its own copies of those two hashing helpers here
(the reference's executable cache has no twin on the card).
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

from ..ir import BucketedBatch
from ..spbase import build_batch, make_admm_settings


def shape_family_parts(S, n, m, settings=None, a_kind="?", ndev=1,
                       axis="scen") -> tuple:
    """((S, n), (S, m), A-kind, settings, n_devices, axis): the common
    prefix of every family key (``tpusppy/solvers/aot.py:201``)."""
    return ((int(S), int(n)), (int(S), int(m)), a_kind, settings,
            int(ndev), axis)


def array_digest(a) -> str:
    """sha1 of a small host array baked into a program as a constant (the
    nonant indices, the integer pattern): programs differing only in such
    constants key differently (``tpusppy/solvers/aot.py:238``)."""
    a = np.ascontiguousarray(np.asarray(a))
    return hashlib.sha1(
        repr((a.shape, str(a.dtype))).encode() + a.tobytes()).hexdigest()


@dataclasses.dataclass
class CanonicalModel:
    """One ingested request: the batched arrays and their identity.

    ``batch``/``bundling``/``names`` are what :class:`..spbase.SPBase`
    would have built itself; ``options["canonical_model"]`` makes every
    cylinder bind this object (shared, the batch-cache discipline: in-place
    writers copy first)."""

    batch: object
    bundling: bool
    names: list
    family: tuple          # the shape-family key (structural identity)
    fingerprint: str       # sha1 over the full coefficient content

    @property
    def tree(self):
        return self.batch.tree

    @property
    def family_digest(self) -> str:
        """Stable short id of the family key: equal keys <=> equal digests,
        and it survives the request journal as a plain string (the
        cross-lifetime family identity of the durable server)."""
        return family_digest_of(self.family)


def family_digest_of(family) -> str:
    """sha1-prefix digest of a family-key tuple."""
    return hashlib.sha1(repr(family).encode()).hexdigest()[:12]


def _batch_family_parts(batch, settings, ndev, axis) -> tuple:
    """Family parts of one homogeneous ScenarioBatch: the shape prefix and
    the program identity the bare shapes do not carry."""
    S, n = batch.c.shape
    m = batch.cl.shape[1]
    a_kind = "shared" if getattr(batch, "A_shared", None) is not None \
        else batch.A.ndim
    return shape_family_parts(
        S, n, m, settings=settings, a_kind=a_kind, ndev=ndev, axis=axis) + (
        ("int", array_digest(batch.is_int)),
        ("nonants", array_digest(batch.tree.nonant_indices)),
        ("stages", int(batch.tree.num_stages)),
    )


def _has_int_nonants(batch) -> bool:
    """Whether ANY nonant slot is integer (the condition under which a
    bound-pass window runs the batched integer sweep)."""
    if isinstance(batch, BucketedBatch):
        return any(
            np.asarray(sub.is_int, bool)[sub.tree.nonant_indices].any()
            for _, sub in batch.buckets)
    return bool(np.asarray(batch.is_int,
                           bool)[batch.tree.nonant_indices].any())


def _program_options_parts(options, int_nonants: bool = False) -> tuple:
    """Options that are program identity without being ADMMSettings
    fields: each changes which programs a wheel builds (a lean window, a
    different refresh cadence, a sparse device A, the bound-pass variant,
    the integer sweep's ladder, the device), so requests differing in them
    never share a family key."""
    options = dict(options or {})
    return (("ph_device_state", bool(options.get("ph_device_state"))),
            ("refresh_every",
             int(options.get("solver_refresh_every", 16) or 0)),
            ("sparse_device_A",
             str(options.get("sparse_device_A", "auto"))),
            ("in_wheel_bounds", bool(options.get("in_wheel_bounds"))),
            ("xhat_threshold",
             float(options.get("in_wheel_xhat_threshold", 0.5))
             if options.get("in_wheel_bounds") else None),
            ("int_sweep",
             (bool(options.get("in_wheel_int_sweep", True)),
              tuple(float(t) for t in
                    options.get("in_wheel_int_thresholds") or ()) or None)
             if (options.get("in_wheel_bounds") and int_nonants)
             else None),
            ("device", str(options.get("device") or "cuda")))


def family_key(batch, settings=None, ndev: int = 1,
               axis: str = "scen", options=None) -> tuple:
    """Shape-family key of a canonical batch: equal keys <=> the wheels
    run identical programs.  Coefficient values never enter."""
    opts = _program_options_parts(options, _has_int_nonants(batch))
    if isinstance(batch, BucketedBatch):
        return ("bucketed", opts) + tuple(
            _batch_family_parts(sub, settings, ndev, axis)
            + (("rows", int(idx.size)),)
            for idx, sub in batch.buckets)
    return _batch_family_parts(batch, settings, ndev, axis) + (opts,)


def content_fingerprint(batch) -> str:
    """sha1 over every coefficient array (the reference's digest): equal
    fingerprints are the same problem instance."""
    from ..spopt import dispatch_A

    h = hashlib.sha1()

    def _upd(b):
        for a in (b.c, b.q2, dispatch_A(b), b.cl, b.cu, b.lb, b.ub,
                  b.const, b.is_int):
            a = np.ascontiguousarray(np.asarray(a))
            h.update(repr((a.shape, str(a.dtype))).encode())
            h.update(a.tobytes())

    if isinstance(batch, BucketedBatch):
        for _idx, sub in batch.buckets:
            _upd(sub)
    else:
        _upd(batch)
    return h.hexdigest()


def ingest(all_scenario_names, scenario_creator, scenario_creator_kwargs=None,
           options=None, ndev: int = 1, axis: str = "scen") -> CanonicalModel:
    """Ingest one request into a :class:`CanonicalModel`: the
    :func:`..spbase.build_batch` construction (bundling and bucketing
    options honoured), the family key (its settings half through the same
    :func:`..spbase.make_admm_settings` the wheel uses) and the content
    fingerprint.  Host numpy only: nothing touches the device."""
    options = dict(options or {})
    batch, names = build_batch(
        all_scenario_names, scenario_creator, scenario_creator_kwargs,
        options, verbose=options.get("verbose", False))
    bundling = int(options.get("bundles_per_rank", 0) or 0) > 0
    settings = make_admm_settings(options, bundling)
    return CanonicalModel(
        batch=batch, bundling=bundling, names=list(names),
        family=family_key(batch, settings=settings, ndev=ndev, axis=axis,
                          options=options),
        fingerprint=content_fingerprint(batch))
