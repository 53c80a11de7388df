"""SPBase: scenario ownership, probabilities, options — the runtime root.

Port of ``tpusppy/spbase.py`` without the mesh: the whole
scenario set is built as ONE batch and the node-grouping index arrays
replace per-node communicators.  ``bundles_per_rank`` > 0 merges the
scenarios into that many bundle EFs (:mod:`.bundles`), and
``shape_buckets`` groups a ragged family (uneven bundles) into a
:class:`~tpusppy_torch.ir.BucketedBatch` of compact shapes (rounded up to
``shape_bucket_quantum``, default 16).  With ``options["batch_cache"]`` the
cylinders of a wheel that build the same family share one batch.
``options["device"]`` picks the device the solves run on (CUDA unless
``"cpu"`` is asked for; see :func:`tpusppy_torch.resolve_device`).
``options["canonical_model"]`` (a :class:`.service.canonical.CanonicalModel`)
binds a batch the service tier ingested once instead of building one.
"""

from __future__ import annotations

import hashlib
import threading

import numpy as np

from . import global_toc, resolve_device
from .ir import BucketedBatch, ScenarioBatch
from .solvers import precision
from .solvers.admm import ADMMSettings


#: (creator, names, kwargs, bundling) -> batch, for ``batch_cache``.
_BATCH_CACHE: dict = {}
_BATCH_LOCK = threading.Lock()


def clear_batch_cache():
    with _BATCH_LOCK:
        _BATCH_CACHE.clear()


def _kwargs_key(kwargs: dict) -> tuple:
    """Exact cache key of scenario_creator_kwargs: numpy arrays by shape,
    dtype and the hash of their bytes (a repr truncates long arrays)."""
    parts = []
    for k in sorted(kwargs):
        v = kwargs[k]
        if isinstance(v, np.ndarray):
            h = hashlib.sha1(np.ascontiguousarray(v).tobytes()).hexdigest()
            parts.append((k, "ndarray", v.shape, str(v.dtype), h))
        else:
            parts.append((k, repr(v)))
    return tuple(parts)


def build_batch(all_scenario_names, scenario_creator,
                scenario_creator_kwargs=None, options=None, verbose=False):
    """Model ingest -> one batched array family (``tpusppy/spbase.py:45``):
    the problems, then bundling (``bundles_per_rank`` > 0: that many
    bundle EFs, :func:`~tpusppy_torch.bundles.form_bundles`), then shape
    bucketing (``shape_buckets`` on a family of more than one shape: a
    :class:`~tpusppy_torch.ir.BucketedBatch` at ``shape_bucket_quantum``,
    kept only when it makes more than one bucket).  Returns ``(batch,
    names)``, the bundle names when bundled."""
    options = dict(options or {})
    names = list(all_scenario_names)
    problems = [
        scenario_creator(name, **dict(scenario_creator_kwargs or {}))
        for name in names
    ]
    nbundles = int(options.get("bundles_per_rank", 0) or 0)
    if nbundles > 0:
        from .bundles import form_bundles

        problems = form_bundles(problems, nbundles)
        names = [p.name for p in problems]
    quantum = int(options.get("shape_bucket_quantum", 16))
    # the integer pattern is part of the shape: one ScenarioBatch takes one
    shapes = {(p.num_vars, p.num_rows, p.is_int.tobytes())
              for p in problems}
    if len(shapes) > 1 and options.get("shape_buckets", False):
        bucketed = BucketedBatch.from_problems(problems, quantum)
        if len(bucketed.buckets) > 1:
            global_toc(
                "shape-bucketed ragged family: "
                f"{[(int(i.size), s.num_rows, s.num_vars) for i, s in bucketed.buckets]}",
                verbose)
            return bucketed, names
    return ScenarioBatch.from_problems(problems), names


def make_admm_settings(options, bundling=False) -> ADMMSettings:
    """``solver_options`` -> :class:`ADMMSettings`.  A bundled family
    (``bundling``) has fewer, larger subproblems: it takes ``max_iter``
    4000 and ``restarts`` 6 unless they are set.  The reference's
    ``use_pallas`` is the port's ``use_kernel``.  ``sweep_precision`` takes
    the modes of :mod:`.solvers.precision` ("default", "high", "highest")
    or None, with ``precision_refine_iters`` and ``precision_guard``; an
    unknown mode raises ``ValueError``.  ``megastep`` is 0 (auto: the PH
    megastep where its gates allow), 1 (the legacy per-iteration loop) or
    k > 1 (windows of k).  A lowered ``matmul_precision`` (the reference's
    ambient XLA matmul precision, which has no PyTorch counterpart that
    computes the same: TF32 is not bf16x3) would change the solve itself
    and raises until the port has it; other keys the port's settings do
    not have are ignored."""
    so = dict(options.get("solver_options") or {})
    if so.get("matmul_precision") not in (None, "highest"):
        raise NotImplementedError(
            f"solver_options matmul_precision={so['matmul_precision']!r}: "
            "a lowered matmul precision outside the sweep is not ported "
            "yet (ROADMAP Queue 1 item 5)")
    if precision.canon(so.get("sweep_precision")) == "highest":
        # "highest" runs exactly as the default
        so.pop("sweep_precision", None)
    if "use_pallas" in so:
        use = so.pop("use_pallas")
        if so.setdefault("use_kernel", use) != use:
            raise ValueError(
                f"solver_options use_pallas={use!r} and use_kernel="
                f"{so['use_kernel']!r} disagree (use_pallas is the "
                "reference's name for use_kernel)")
    if bundling:
        so.setdefault("max_iter", 4000)
        so.setdefault("restarts", 6)
    allowed = {f.name for f in ADMMSettings.__dataclass_fields__.values()}
    return ADMMSettings(**{k: v for k, v in so.items() if k in allowed})


class SPBase:
    """Base class for scenario-programming objects.

    Args:
      options: dict of options (reference option names honored:
        ``defaultPHrho``, ``convthresh``, ``PHIterLimit``, ``verbose``,
        ``display_progress``, ``solver_options`` ...; plus ``device``).
      all_scenario_names: list of scenario names.
      scenario_creator: callable(name, **kwargs) -> ScenarioProblem.
      scenario_creator_kwargs: kwargs passed through.
    """

    def __init__(self, options, all_scenario_names, scenario_creator,
                 scenario_creator_kwargs=None):
        self.options = dict(options or {})
        self.device = resolve_device(self.options.get("device"))
        self.all_scenario_names = list(all_scenario_names)
        self.scenario_creator = scenario_creator
        self.scenario_creator_kwargs = dict(scenario_creator_kwargs or {})
        self.verbose = self.options.get("verbose", False)
        self.spcomm = None      # attached by an SPCommunicator in a wheel

        self._build_or_share_batch()
        self.tree = self.batch.tree
        global_toc(
            f"Built scenario batch: {self.batch.num_scenarios} scenarios, "
            f"{self.batch.num_vars} vars, {self.batch.num_rows} rows, "
            f"{self.tree.num_nonants} nonants, {self.tree.num_stages} stages",
            self.verbose,
        )
        # nid_sk[s, k] = node-id owning nonant slot k in scenario s
        self.nid_sk = self.tree.nid_sk()
        self.admm_settings = make_admm_settings(self.options, self.bundling)

    @property
    def bundling(self) -> bool:
        """Whether the batch's subproblems are bundles."""
        return int(self.options.get("bundles_per_rank", 0) or 0) > 0

    def _build_or_share_batch(self):
        """Build the batch, or with ``options["batch_cache"]`` take the one
        an earlier object built from the same creator, names and kwargs
        (``tpusppy/spbase.py:181-200``): the solve paths only read it, and
        fixing copies the bounds it changes."""
        self._batch_shared = False
        cm = self.options.get("canonical_model")
        if cm is not None:
            # the service tier ingested the request once
            # (:func:`.service.canonical.ingest`): every cylinder binds that
            # batch, shared as a cache hit (in-place writers copy first)
            self.batch = cm.batch
            self.all_scenario_names = list(cm.names)
            self._batch_shared = True
            return
        if not self.options.get("batch_cache"):
            self.batch, self.all_scenario_names = build_batch(
                self.all_scenario_names, self.scenario_creator,
                self.scenario_creator_kwargs, self.options, self.verbose)
            return
        key = (self.scenario_creator, tuple(self.all_scenario_names),
               _kwargs_key(self.scenario_creator_kwargs),
               int(self.options.get("bundles_per_rank", 0) or 0),
               int(self.options.get("shape_bucket_quantum", 16)),
               bool(self.options.get("shape_buckets", False)))
        with _BATCH_LOCK:
            hit = _BATCH_CACHE.get(key)
        if hit is None:
            hit = build_batch(self.all_scenario_names, self.scenario_creator,
                              self.scenario_creator_kwargs, self.options,
                              self.verbose)
            with _BATCH_LOCK:
                hit = _BATCH_CACHE.setdefault(key, hit)
        self.batch, names = hit
        self.all_scenario_names = list(names)
        self._batch_shared = True

    def _ensure_private_batch(self):
        """Copy a cache-shared batch's 2-D arrays before an in-place write
        (``tpusppy/spbase.py:243``), so the cylinders sharing it (a
        Lagrangian spoke's bound is of the unrestricted problem) never see
        the write.  A no-op on a private batch."""
        if not getattr(self, "_batch_shared", False):
            return
        import dataclasses

        b = self.batch
        self.batch = dataclasses.replace(
            b, c=b.c.copy(), q2=b.q2.copy(), cl=b.cl.copy(),
            cu=b.cu.copy(), lb=b.lb.copy(), ub=b.ub.copy())
        self.tree = self.batch.tree
        self._batch_shared = False

    def _options_check(self, required, options=None):
        """Hard check for required options (spbase.py:524-531)."""
        options = self.options if options is None else options
        missing = [k for k in required if k not in options]
        if missing:
            raise RuntimeError(f"Missing required options: {missing}")

    @property
    def is_minimizing(self):
        return True  # the IR is always stated as minimization

    @property
    def probs(self) -> np.ndarray:
        return self.tree.scen_prob

    @property
    def nonant_length(self) -> int:
        return self.tree.num_nonants

    def nonants_of(self, x) -> np.ndarray:
        """Gather packed nonant vector(s) (…, K) from full x (…, n)."""
        return np.asarray(x)[..., self.tree.nonant_indices]

    @property
    def nonant_var_names(self) -> list:
        """Names of the packed nonant slots; slot indices when the columns
        are unnamed (a bundled or bucketed batch)."""
        vn = self.batch.var_names
        if vn is None:
            return [str(k) for k in range(self.nonant_length)]
        return [vn[i] for i in self.tree.nonant_indices]

    def report_var_values_at_rank0(self, x, max_rows=40):
        """A table of nonant values by scenario (spbase.py:584-616)."""
        xn = self.nonants_of(x)
        print(f"{'scenario':>12} " + " ".join(
            f"nonant[{k}]" for k in range(min(self.nonant_length, 8))))
        for s, name in enumerate(self.all_scenario_names[:max_rows]):
            vals = " ".join(f"{v:9.4f}" for v in xn[s][:8])
            print(f"{name:>12} {vals}")
