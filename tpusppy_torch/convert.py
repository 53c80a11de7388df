"""State carry-across: the reference package's state as the port's objects.

The JAX package's arrays come in as numpy (``np.asarray`` of a device array,
``dataclasses.asdict`` of a dataclass, ``NamedTuple._asdict()``), so nothing
here imports the reference.  This is the system's analogue of loading
weights: a scenario batch (a shape-bucketed one too), a refresh solve's
factors, or a PH hub's state (with a bucketed batch's per-bucket slots:
warm state, factors and age) carried over lets the port continue exactly
where the reference stopped.
"""

from __future__ import annotations

import numpy as np
import torch

from .ir import BucketedBatch, ScenarioBatch
from .scenario_tree import TreeInfo
from .solvers.admm import Factors
from .solvers.shared_admm import SharedFactors
from .solvers.sparse import SparseA
from .solvers.structured_kkt import (BlockWoodbury, StructureArrays,
                                     woodbury_layout)


def tree_from_arrays(node_names, node_stage, scen_node_ids, nonant_stage,
                     nonant_indices, node_prob, scen_prob) -> TreeInfo:
    """A :class:`TreeInfo` from the reference's TreeInfo fields."""
    return TreeInfo(
        node_names=list(node_names),
        node_stage=np.asarray(node_stage, dtype=np.int32),
        scen_node_ids=np.asarray(scen_node_ids, dtype=np.int32),
        nonant_stage=np.asarray(nonant_stage, dtype=np.int32),
        nonant_indices=np.asarray(nonant_indices, dtype=np.int32),
        node_prob=np.asarray(node_prob, dtype=np.float64),
        scen_prob=np.asarray(scen_prob, dtype=np.float64))


def batch_from_arrays(names, c, q2, A, cl, cu, lb, ub, is_int, const, tree,
                      var_names=None, version=0, A_shared=None,
                      **_ignored) -> ScenarioBatch:
    """A :class:`ScenarioBatch` from the reference's ScenarioBatch fields.
    ``tree`` is a TreeInfo or a dict of its fields.  A shared A stays ONE
    (m, n) array in ``A_shared`` with ``A`` its zero-copy (S, m, n) view.
    Fields the port's batch does not have (``repair_fn``) are ignored."""
    if isinstance(tree, dict):
        tree = tree_from_arrays(**tree)

    def f(v):
        return np.array(v, dtype=np.float64)

    c = f(c)
    if A_shared is not None:
        A_shared = np.ascontiguousarray(f(A_shared))
        A = np.broadcast_to(A_shared[None], (c.shape[0],) + A_shared.shape)
    else:
        A = f(A)
    return ScenarioBatch(
        names=list(names), c=c, q2=f(q2), A=A, cl=f(cl), cu=f(cu),
        lb=f(lb), ub=f(ub), is_int=np.asarray(is_int, dtype=bool),
        const=f(const), tree=tree,
        var_names=None if var_names is None else list(var_names),
        version=int(version), A_shared=A_shared)


def bucketed_batch_from_arrays(names, buckets, tree, c, q2, lb, ub, cl, cu,
                               const, var_names=None, version=0,
                               **_ignored) -> BucketedBatch:
    """A :class:`BucketedBatch` from the reference's BucketedBatch fields
    (``dataclasses.asdict`` of one): ``buckets`` is a list of (scenario
    indices, sub-batch), each sub-batch a port ScenarioBatch or a dict of
    the reference's ScenarioBatch fields; ``tree`` a TreeInfo or a dict."""
    if isinstance(tree, dict):
        tree = tree_from_arrays(**tree)
    parts = []
    for idx, sub in buckets:
        if isinstance(sub, dict):
            sub = batch_from_arrays(**sub)
        parts.append((np.asarray(idx, dtype=np.int64), sub))

    def f(v):
        return np.array(v, dtype=np.float64)

    return BucketedBatch(
        names=list(names), buckets=parts, tree=tree, c=f(c), q2=f(q2),
        lb=f(lb), ub=f(ub), cl=f(cl), cu=f(cu), const=f(const),
        var_names=None if var_names is None else list(var_names),
        version=int(version))


def factors_from_arrays(arrays: dict, device, dtype=torch.float64) -> Factors:
    """:class:`Factors` from the reference's Factors as a dict of numpy
    arrays (``{k: np.asarray(v) for k, v in factors._asdict().items()}``)."""
    return Factors(**{
        k: torch.tensor(np.asarray(arrays[k]), dtype=dtype, device=device)
        for k in Factors._fields})


def _fields_of(v):
    """A reference NamedTuple (``_asdict``) or a dict, as a dict."""
    return v._asdict() if hasattr(v, "_asdict") else dict(v)


def _is_none(v):
    """None, or ``np.asarray(None)`` (how a None field arrives when the
    caller maps ``np.asarray`` over a factors' ``_asdict()``)."""
    return v is None or (isinstance(v, np.ndarray) and v.dtype == object
                         and v.shape == () and v.item() is None)


def shared_factors_from_arrays(arrays: dict, device, dtype=torch.float64,
                               A=None) -> SharedFactors:
    """:class:`SharedFactors` from the reference's shared-A factors as a
    dict of numpy arrays.  ``Kinv`` is an (n, n) array, or the structured
    engine's BlockWoodbury (a NamedTuple or dict with ``binv``, ``bvars``,
    ``Aw``, ``Cinv``); ``K`` may be None (the sparse regimes, or
    ``factors_keep_K=False``), and refinement then runs matrix-free.  A
    BlockWoodbury needs ``A``, the batch's structured :class:`SparseA` on
    ``device`` (unscaled): its kernel layout, which the port's sweep kernel
    applies, is made here from A scaled by the factors' D and E."""
    def t(v):
        return torch.tensor(np.asarray(v), dtype=dtype, device=device)

    out = {k: t(arrays[k]) for k in ("D", "E", "cost", "rho_a", "rho_x",
                                      "gamma", "q2ref")}
    kinv = arrays["Kinv"]
    if isinstance(kinv, dict) or hasattr(kinv, "binv"):
        f = _fields_of(kinv)
        kinv = BlockWoodbury(
            binv=tuple(t(v) for v in f["binv"]),
            bvars=tuple(torch.tensor(np.asarray(v), dtype=torch.int64,
                                     device=device) for v in f["bvars"]),
            Aw=t(f["Aw"]), Cinv=t(f["Cinv"]))
    else:
        kinv = t(kinv)
    op = kinv
    if isinstance(kinv, BlockWoodbury):
        if not isinstance(A, SparseA) or A.structure is None:
            raise ValueError("structured factors need the batch's "
                             "structured SparseA (argument A)")
        op = woodbury_layout(kinv, A.astype(dtype).scale(out["E"],
                                                         out["D"]))
    K = arrays.get("K")
    return SharedFactors(**out, Kinv=kinv, K=None if _is_none(K) else t(K),
                         Kinv_op=op)


def sparse_from_arrays(rows, cols, vals, shape, structure=None, device=None,
                       dtype=torch.float64, **_ignored) -> SparseA:
    """A :class:`SparseA` from the reference's SparseA fields (``rows``,
    ``cols``, ``vals`` in CSR order, ``shape``; its ``perm_csc`` and
    ``ell`` are not needed: the port builds the ELL twin its products and
    kernel run on).  ``structure`` is the reference's StructureArrays (a
    NamedTuple or dict with ``bvars``, ``brows``, ``wide_rows``) or None."""
    sp = SparseA.from_coo(np.asarray(rows), np.asarray(cols),
                          np.asarray(vals), tuple(shape), dtype=dtype,
                          device=device)
    if structure is not None:
        f = _fields_of(structure)

        def idx(v):
            return torch.tensor(np.asarray(v), dtype=torch.int64,
                                device=device)

        sp.structure = StructureArrays(
            bvars=tuple(idx(v) for v in f["bvars"]),
            brows=tuple(idx(v) for v in f["brows"]),
            wide_rows=idx(f["wide_rows"]))
    return sp


def _factors_for(arrays, device, dt, A_dev):
    """The port's factors of one batch part from the reference's arrays:
    :class:`SharedFactors` where the part's device A is a shared (m, n)
    matrix or a SparseA."""
    if A_dev is not None and (A_dev.ndim == 2 or isinstance(A_dev, SparseA)):
        return shared_factors_from_arrays(arrays, device, dt, A=A_dev)
    return factors_from_arrays(arrays, device, dt)


def load_ph_state(ph, W, xbars, rho, warm, factors=None, factors_age=1,
                  iteration=0):
    """Seat a PH hub state in a port ``PH``/``PHBase`` object.

    ``W``, ``xbars``, ``rho`` are (S, K); ``warm`` is the last solve's
    (x, z, y, yx) (unscaled, as the reference's ``_warm``); ``factors`` is
    an optional dict of the reference's refresh factors (``Factors``, or
    ``SharedFactors`` on a shared-A batch), valid for the augmented
    objective at this ``rho``, with their age.  The next
    ``_iterk_one(iteration + 1, ...)`` then repeats the reference's next
    iteration: a frozen solve when factors came along and are not aged out,
    else a refresh.

    On a bucketed batch ``warm`` is a list of the buckets' (x, z, y, yx)
    (the reference's ``_bucket_slots[k]["warm"]``), ``factors`` a list of
    their factors (or None) and ``factors_age`` an int or a list: they
    seat the port's per-bucket slots."""
    S, K = ph.batch.num_scenarios, ph.nonant_length
    for name, v in (("W", W), ("xbars", xbars), ("rho", rho)):
        v = np.array(v, dtype=np.float64)
        if v.shape != (S, K):
            raise ValueError(f"{name} has shape {v.shape}, wanted {(S, K)}")
        setattr(ph, name, v)
    dt = ph.admm_settings.tdtype()

    def t(v):
        return torch.tensor(np.asarray(v), dtype=dt, device=ph.device)

    ph._iter = int(iteration)
    if isinstance(ph.batch, BucketedBatch):
        b = ph.batch
        n_b = len(b.buckets)
        ages = (list(factors_age) if np.ndim(factors_age)
                else [factors_age] * n_b)
        facs = list(factors) if factors is not None else [None] * n_b
        consts = ph._bucket_device_consts(dt)
        q2_full = ph._augmented_q2()
        x = np.zeros((S, b.num_vars))
        slots = []
        for (idx, sub), w, fac, age, (A_d, _, _) in zip(
                b.buckets, warm, facs, ages, consts):
            slot = {"warm": tuple(t(v) for v in w), "n_div_prev": 0}
            x[idx, :sub.num_vars] = np.asarray(w[0], dtype=np.float64)
            if fac is not None:
                n = sub.num_vars
                slot["factors"] = _factors_for(fac, ph.device, dt, A_d)
                slot["sig"] = ph._solve_sig(q2_full[idx, :n],
                                            b.lb[idx, :n], b.ub[idx, :n])
                slot["age"] = int(age)
            slots.append(slot)
        ph._bucket_slots = slots
        ph._warm = ph._factors = ph._factors_sig = None
        ph._factors_age = 0
        ph.local_x = x
        _, ph.xsqbars = ph._node_avgs(ph.nonants_of(x))
        return ph
    ph._warm = tuple(t(v) for v in warm)
    x = np.array(warm[0], dtype=np.float64)
    ph.local_x = x
    _, ph.xsqbars = ph._node_avgs(ph.nonants_of(x))
    if factors is None:
        ph._factors = ph._factors_sig = None
        ph._factors_age = 0
        return ph
    if ph.batch.A_shared is not None:
        ph._factors = shared_factors_from_arrays(
            factors, ph.device, dt, A=ph._device_consts(dt)[0])
    else:
        ph._factors = factors_from_arrays(factors, ph.device, dt)
    ph._factors_sig = ph._solve_sig(ph._augmented_q2(), ph.batch.lb,
                                    ph.batch.ub)
    ph._factors_age = int(factors_age)
    return ph
