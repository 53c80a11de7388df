"""Checkpoint engine: versioned, atomic, asynchronous wheel snapshots.

A copy of ``tpusppy/resilience/checkpoint.py``, in the same file format
and :data:`CHECKPOINT_VERSION`, so a checkpoint written by either package
loads in the other.  One checkpoint is one ``.npz`` file holding the
wheel state a resumed run needs: per-scenario W, xbars (and xsqbars),
rho, the hub's iteration, the best inner and outer bounds (overall and
per spoke, each with its kind).  The write is atomic (a tempfile in the
same directory, ``os.replace`` into place), so a kill at any instant
leaves the previous checkpoint or the new one, never a torn file.

Capture fetches nothing from the card: the hub's PH state lives in host
mirrors (each window ends in one packed fetch; a lean window's mirrors
are refreshed by the one boundary fetch before a due capture,
``PHBase._spcomm_needs_host_state``), so a snapshot is host copies, and
the file I/O runs on a writer thread that coalesces to the newest pending
snapshot.  :meth:`CheckpointManager.capture` bills every
:func:`..solvers.hostsync.fetch` the snapshot builder makes on its own
thread to ``checkpoint.capture_fetches`` (zero on every path here), and
:func:`capture_ph` refuses an opt whose mirrors are tensors rather than
numpy arrays: the reference's ``jax`` transfer guard has no PyTorch
twin.

Resume: ``WheelSpinner(..., resume=<dir-or-file>)`` (or the hub option
``"resume"``) loads :func:`load_latest` and hands the checkpoint to the
hub's opt; :func:`restore_ph` re-seats W, xbars and rho after the warm-up
Iter0 and sets ``_iter_base``, so ``PHIterLimit`` stays the total across
restarts.  The hub re-seeds its bounds from the checkpoint
(:meth:`..cylinders.hub.Hub.seed_resume`), so they are monotone across the
restart.

The sharded files (:func:`save_shard`, :func:`load_sharded`,
:class:`ShardedCheckpointReader`) are host numpy code and ported; the
restore of one field as a tensor sharded over a mesh
(:func:`restore_sharded_array`) waits for the distributed port (ROADMAP
Queue 1 item 7) and raises.  The autotuner's state is not captured
(the autotuner is ROADMAP Queue 1 item 5); a ``tune_state`` a file holds
loads and is carried, never acted on.  The reference's AOT cache pointer
has no twin.

Legacy interchange: :func:`write_wxbar` / :func:`read_wxbar` read and
write the reference's W/xbar csv files (``scenario,varname,value`` rows),
and real checkpoints for ``.npz`` paths; the WXBarWriter/WXBarReader
extensions route through them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import re
import tempfile
import threading
import time

import numpy as np

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from ..obs.log import get_logger

CHECKPOINT_VERSION = 1

_log = get_logger("resilience.checkpoint")

_CTR_CAPTURES = _metrics.counter("checkpoint.captures")
_CTR_CAPTURE_FETCHES = _metrics.counter("checkpoint.capture_fetches")
_CTR_WRITES = _metrics.counter("checkpoint.writes")
_CTR_WRITE_ERRORS = _metrics.counter("checkpoint.write_errors")
_CTR_COALESCED = _metrics.counter("checkpoint.coalesced")
_CTR_RESTORES = _metrics.counter("checkpoint.restores")
_CTR_CORRUPT_SKIPPED = _metrics.counter("checkpoint.corrupt_skipped")
_HIST_WRITE_SECS = _metrics.histogram("checkpoint.write_secs")


@dataclasses.dataclass
class WheelCheckpoint:
    """One snapshot of warm-startable wheel state (all host arrays)."""

    iteration: int
    W: np.ndarray | None = None           # (S, K) dual weights
    xbars: np.ndarray | None = None       # (S, K) node averages
    xsqbars: np.ndarray | None = None     # (S, K)
    rho: np.ndarray | None = None         # (S, K) penalty
    best_inner: float = float("inf")
    best_outer: float = float("-inf")
    spoke_bounds: dict = dataclasses.field(default_factory=dict)
    tune_state: dict = dataclasses.field(default_factory=dict)
    meta: dict = dataclasses.field(default_factory=dict)
    version: int = CHECKPOINT_VERSION

    @property
    def shape(self):
        return None if self.W is None else tuple(self.W.shape)


_ARRAY_FIELDS = ("W", "xbars", "xsqbars", "rho")


# ---------------------------------------------------------------------------
# File format (atomic npz)
# ---------------------------------------------------------------------------
def atomic_write_json(path: str, obj) -> str:
    """THE atomic small-file write (tempfile in the target dir, fsync,
    ``os.replace``) — shared by every JSON sidecar of the resilience
    layer (tune verdict cache, bench ladder state) so the discipline
    lives in one place."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=".json_tmp_", suffix=".json", dir=d)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise
    return path


def save(ckpt: WheelCheckpoint, path: str) -> str:
    """Atomically write ``ckpt`` to ``path`` (npz).  The tempfile lives in
    the target directory so ``os.replace`` is a same-filesystem rename —
    a kill mid-write can never leave a torn checkpoint."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    meta = {
        "version": int(ckpt.version),
        "iteration": int(ckpt.iteration),
        "best_inner": float(ckpt.best_inner),
        "best_outer": float(ckpt.best_outer),
        # per-spoke entries are [kind, bound] so a resumed wheel with a
        # DIFFERENT spoke topology can still apply each bound under its
        # true semantics (an outer bound is outer whatever slot it came
        # from); bare floats from hand-built checkpoints are tolerated
        "spoke_bounds": {
            str(k): (list(v) if isinstance(v, (list, tuple))
                     else float(v))
            for k, v in (ckpt.spoke_bounds or {}).items()},
        "tune_state": ckpt.tune_state or {},
        "meta": ckpt.meta or {},
        "arrays": [f for f in _ARRAY_FIELDS
                   if getattr(ckpt, f) is not None],
    }
    arrays = {f: np.asarray(getattr(ckpt, f), dtype=np.float64)
              for f in meta["arrays"]}
    fd, tmp = tempfile.mkstemp(prefix=".ckpt_tmp_", suffix=".npz", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, meta=np.array(json.dumps(meta)), **arrays)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        with contextlib.suppress(OSError):
            os.remove(tmp)
        raise
    return path


def load(path: str, _assemble: bool = True) -> WheelCheckpoint:
    """Read one checkpoint file; unknown versions are refused loudly (a
    silent partial restore would corrupt the gap trajectory it exists to
    preserve).  A member of a SHARDED set (``.s<k>of<n>.npz``) loads the
    whole set assembled — pass through :func:`load_sharded` explicitly
    (or :class:`ShardedCheckpointReader` for row reads) to control that."""
    if _assemble and _SHARD_RE.match(os.path.basename(path)):
        return load_sharded(path)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"][()]))
        if int(meta.get("version", -1)) > CHECKPOINT_VERSION:
            raise RuntimeError(
                f"checkpoint {path} has version {meta.get('version')}; "
                f"this build reads <= {CHECKPOINT_VERSION}")
        arrays = {f: np.array(z[f]) for f in meta.get("arrays", [])
                  if f in z}
    return WheelCheckpoint(
        iteration=int(meta["iteration"]),
        best_inner=float(meta.get("best_inner", float("inf"))),
        best_outer=float(meta.get("best_outer", float("-inf"))),
        spoke_bounds=dict(meta.get("spoke_bounds", {})),
        tune_state=dict(meta.get("tune_state", {})),
        meta=dict(meta.get("meta", {})),
        version=int(meta.get("version", CHECKPOINT_VERSION)),
        **arrays,
    )


_CKPT_RE = re.compile(r"^ckpt_.*_(\d+)\.npz$")
_SHARD_RE = re.compile(r"^ckpt_.*_(\d+)\.s(\d+)of(\d+)\.npz$")


def checkpoint_path(directory: str, iteration: int,
                    tag: str = "wheel") -> str:
    return os.path.join(directory, f"ckpt_{tag}_{int(iteration):08d}.npz")


def shard_checkpoint_path(directory: str, iteration: int, shard: int,
                          num_shards: int, tag: str = "wheel") -> str:
    """Per-shard file of one sharded checkpoint: ``ckpt_<tag>_<iter>.
    s<k>of<n>.npz`` — each process writes ONLY its scenario-row slice, so
    a 100k-scenario snapshot never materializes on one host."""
    return os.path.join(
        directory,
        f"ckpt_{tag}_{int(iteration):08d}"
        f".s{int(shard):03d}of{int(num_shards):03d}.npz")


def list_checkpoints(directory: str) -> list:
    """[(iteration, path)] ascending; tolerates foreign files.

    A SHARDED checkpoint (``.s<k>of<n>.npz`` siblings) appears once, as
    its shard-0 path, and only when the set is COMPLETE — per-shard
    writes are individually atomic but the set is not, so a kill between
    shard renames must leave the previous complete checkpoint as
    ``latest``, never a torn set."""
    out = []
    shard_sets: dict = {}
    try:
        names = os.listdir(directory)
    except OSError:
        return []
    for nm in names:
        m = _CKPT_RE.match(nm)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, nm)))
            continue
        m = _SHARD_RE.match(nm)
        if m:
            it, k, n = (int(m.group(i)) for i in (1, 2, 3))
            shard_sets.setdefault((it, n), {})[k] = os.path.join(
                directory, nm)
    for (it, n), shards in shard_sets.items():
        if len(shards) == n and 0 in shards:
            out.append((it, shards[0]))
    return sorted(out)


def _read_npy_header(f):
    """(shape, dtype) of one npy stream — public numpy surface first,
    the private helper only as the fallback (upstream drift must not be
    able to fail verification, see :func:`verify`)."""
    from numpy.lib import format as _npf

    version = _npf.read_magic(f)
    if version == (1, 0):
        shape, _fortran, dtype = _npf.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, _fortran, dtype = _npf.read_array_header_2_0(f)
    else:
        shape, _fortran, dtype = _npf._read_array_header(f, version)
    return shape, dtype


def _verify_member(path: str):
    """Integrity check of ONE npz checkpoint file without reading array
    data: the zip central directory must be present (truncation chops it
    off — it lives at the END of the file), ``meta`` must parse, and
    every array the meta declares must have a parseable npy header whose
    payload size matches its (stored, uncompressed) zip entry.  Raises
    on any mismatch."""
    import zipfile

    with zipfile.ZipFile(path) as zf:
        names = set(zf.namelist())
        if "meta.npy" not in names:
            raise ValueError(f"{path}: no meta member")
        with zf.open("meta.npy") as f:
            meta = json.loads(str(np.lib.format.read_array(
                f, allow_pickle=False)[()]))
        for fld in meta.get("arrays", []):
            nm = fld + ".npy"
            if nm not in names:
                raise ValueError(f"{path}: declared array {fld!r} missing")
            info = zf.getinfo(nm)
            with zf.open(nm) as f:
                shape, dtype = _read_npy_header(f)
                expect = f.tell() + int(np.prod(shape)) * dtype.itemsize
            if info.file_size != expect:
                raise ValueError(
                    f"{path}: array {fld!r} is {info.file_size} bytes, "
                    f"header promises {expect} — truncated/corrupt")


#: the exception classes that MEAN "this file is corrupt" — everything
#: else (NFS blips, numpy API drift, ...) must NOT be read as corruption
_CORRUPT_ERRORS = (ValueError, KeyError, EOFError)


def verify(path: str) -> bool:
    """True when the checkpoint ARTIFACT at ``path`` (every shard sibling
    when it names a sharded-set member) passes the size + per-array
    header check — cheap enough for the resume walk, strong enough to
    catch a truncated/torn file before it raises out of a restore.

    FAIL-OPEN on unexpected errors: only genuine corruption signatures
    (bad zip, unparsable meta/header, size mismatch) report False.  An
    environmental or drift failure (transient IO, a numpy rename) says
    True and lets :func:`load` fail loud instead — a blanket "corrupt"
    verdict here would make ``latest()`` skip EVERY set, the resume
    silently cold-start, and the manager's ``fresh_start`` then DELETE
    the healthy snapshots."""
    import zipfile

    for p in (_shard_sibling_names(path) or [path]):
        try:
            _verify_member(p)
        except (zipfile.BadZipFile, *_CORRUPT_ERRORS):
            return False
        except Exception as e:      # fail open, loudly
            _log.warning("checkpoint verification of %s errored (%r) — "
                         "treating as valid; the load will decide", p, e)
    return True


def latest(directory: str, verify_integrity: bool = True) -> str | None:
    """Path of the newest VALID checkpoint in ``directory`` (None when
    empty).  A corrupt/truncated newest set — e.g. filesystem damage
    after the atomic rename — is skipped loudly
    (``checkpoint.corrupt_skipped``) and the previous complete set
    serves instead of the resume crashing out of ``load``."""
    for _it, p in reversed(list_checkpoints(directory)):
        if not verify_integrity or verify(p):
            return p
        _CTR_CORRUPT_SKIPPED.inc(1)
        _log.warning("checkpoint %s failed integrity verification — "
                     "falling back to the previous complete set", p)
    return None


def latest_iteration(directory: str) -> int | None:
    """Iteration number of the newest VALID checkpoint in ``directory``
    (None when there is none) — WITHOUT decompressing any array block.
    The solve server's restart-recovery triage runs this per journaled
    tenant to decide warm-resume vs loud cold restart, so it must stay
    cheap even when a work dir holds many parked tenants.  One
    directory walk (``latest()``'s verify loop, keeping the iteration
    instead of discarding it) — re-listing after ``latest()`` could
    race a concurrent prune and miss the match."""
    for it, p in reversed(list_checkpoints(directory)):
        if verify(p):
            return int(it)
        _CTR_CORRUPT_SKIPPED.inc(1)
        _log.warning("checkpoint %s failed integrity verification — "
                     "falling back to the previous complete set", p)
    return None


def load_latest(path: str) -> WheelCheckpoint | None:
    """Load ``path`` directly (a file) or its newest VALID checkpoint (a
    directory — corrupt sets are skipped with a
    ``checkpoint.corrupt_skipped`` count; an explicitly named FILE still
    fails loud, the caller pinned it).  None when nothing is there —
    callers treat a missing checkpoint as a cold start, which is what
    ``--resume`` on a first run must mean.  A sharded set loads
    ASSEMBLED (all rows on this host); big-S callers that must never
    materialize the full state use :class:`ShardedCheckpointReader` /
    :func:`restore_sharded_array`."""
    if path is None:
        return None
    if os.path.isdir(path):
        p = latest(path)
        return None if p is None else load(p)
    if os.path.exists(path):
        return load(path)
    return None


# ---------------------------------------------------------------------------
# Sharded checkpoints: the (S, K) wheel state written as one npz a
# scenario-row shard, each process of a multi-process run saving only its
# own rows; a reader opens only the shard files that overlap the rows it
# asks for, so a large snapshot need never materialize on one host.
# ---------------------------------------------------------------------------
def save_shard(ckpt: WheelCheckpoint, directory: str, shard: int,
               num_shards: int, rows, S_total: int,
               tag: str = "wheel") -> str:
    """Atomically write ONE shard of a sharded checkpoint.

    ``ckpt``'s arrays hold only this shard's rows; ``rows`` is their
    (lo, hi) global row range and ``S_total`` the full scenario count.
    Every shard carries the full scalar meta (iteration, bounds, ...) so
    any single shard can answer metadata queries without its siblings."""
    lo, hi = (int(rows[0]), int(rows[1]))
    sh_meta = {"index": int(shard), "count": int(num_shards),
               "rows": [lo, hi], "S": int(S_total)}
    for f in _ARRAY_FIELDS:
        a = getattr(ckpt, f, None)
        if a is not None and np.ndim(a) == 2:
            # column width in the meta so readers can answer shape
            # queries without decompressing any shard's array block
            sh_meta["K"] = int(np.shape(a)[1])
            break
    ck = dataclasses.replace(
        ckpt, meta=dict(ckpt.meta or {}, shard=sh_meta))
    return save(ck, shard_checkpoint_path(directory, ckpt.iteration,
                                          shard, num_shards, tag))


def _shard_sibling_names(path: str) -> list:
    """Every sibling shard PATH of one set member, derived from the
    ``.s<k>of<n>`` name pattern alone — no file is opened, and the list
    is independent of which siblings currently exist."""
    d, base = os.path.split(os.path.abspath(path))
    m = _SHARD_RE.match(base)
    if not m:
        return []
    n = int(m.group(3))
    stem = base[:base.rindex(".s")]
    return [os.path.join(d, f"{stem}.s{k:03d}of{n:03d}.npz")
            for k in range(n)]


def shard_set_paths(path: str) -> list:
    """[(lo, hi, path)] for every sibling shard of one sharded-checkpoint
    member ``path``, ascending by row range; [] when ``path`` is not a
    shard file or the set is incomplete/unreadable (a sibling vanishing
    mid-listing — e.g. a concurrent controller's cleanup — reads as
    incomplete, never as a crash)."""
    import zipfile

    out = []
    for p in _shard_sibling_names(path):
        try:
            with np.load(p, allow_pickle=False) as z:
                meta = json.loads(str(z["meta"][()]))
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            return []
        lo, hi = meta.get("meta", {}).get("shard", {}).get("rows", (0, 0))
        out.append((int(lo), int(hi), p))
    return sorted(out)


def remove_checkpoint_files(path: str):
    """Remove one checkpoint ARTIFACT: the file itself, plus every
    sibling shard when ``path`` is a member of a sharded set
    (``list_checkpoints`` names a complete set by its shard-0 path, so a
    prune that removed only that file would orphan the siblings
    forever).  Pure name-pattern deletion: nothing is opened, so
    concurrent cleanup across controllers cannot race a read."""
    for p in _shard_sibling_names(path) or [path]:
        with contextlib.suppress(OSError):
            os.remove(p)


def load_sharded(path: str) -> WheelCheckpoint:
    """Assemble one FULL checkpoint from a sharded set (any member path).
    Host-side concatenation — the compatibility loader for single-host
    resumes; the O(1)-host path is :func:`restore_sharded_array`."""
    parts = shard_set_paths(path)
    if not parts:
        raise RuntimeError(f"incomplete or foreign sharded checkpoint "
                           f"set at {path}")
    members = [load(p, _assemble=False) for _, _, p in parts]
    first = members[0]
    S = int((first.meta or {}).get("shard", {}).get("S", 0)) or \
        sum(hi - lo for lo, hi, _ in parts)
    out = dataclasses.replace(first, meta={
        k: v for k, v in (first.meta or {}).items() if k != "shard"})
    for f in _ARRAY_FIELDS:
        if getattr(first, f) is None:
            continue
        full = np.zeros((S,) + getattr(first, f).shape[1:])
        for (lo, hi, _), mem in zip(parts, members):
            full[lo:hi] = getattr(mem, f)
        setattr(out, f, full)
    return out


class ShardedCheckpointReader:
    """Row-range reads over one sharded checkpoint set, opening only the
    shard files a requested slice overlaps (one npz handle cache per
    file): each process asks for its own rows only, so no host reads rows
    it does not own."""

    def __init__(self, path: str):
        self.parts = shard_set_paths(path)
        if not self.parts:
            raise RuntimeError(
                f"incomplete or foreign sharded checkpoint set at {path}")
        with np.load(self.parts[0][2], allow_pickle=False) as z:
            self.meta = json.loads(str(z["meta"][()]))
        sh = self.meta.get("meta", {}).get("shard", {})
        self.S = int(sh.get("S", self.parts[-1][1]))
        self.K = int(sh["K"]) if "K" in sh else None
        self.iteration = int(self.meta.get("iteration", 0))
        self._cache: dict = {}

    def drop_cache(self):
        """Release the per-shard array cache (call once the restore is
        done: the reader may be kept alive by closures for the run's
        lifetime, and cached foreign-row blocks would otherwise dilute
        the O(1)-per-host contract this API exists for)."""
        self._cache = {}

    def _shard_arrays(self, p: str) -> dict:
        got = self._cache.get(p)
        if got is None:
            with np.load(p, allow_pickle=False) as z:
                meta = json.loads(str(z["meta"][()]))
                got = {f: np.array(z[f])
                       for f in meta.get("arrays", []) if f in z}
            self._cache[p] = got
        return got

    def read_rows(self, field: str, lo: int, hi: int) -> np.ndarray:
        """Rows [lo, hi) of ``field`` assembled from the overlapping
        shards.  Rows at/above the stored S (``pad_to`` ghost padding on
        an uneven mesh) come back zero — ghosts never checkpoint."""
        lo, hi = int(lo), int(hi)
        cols = None
        chunks = []
        for slo, shi, p in self.parts:
            if shi <= lo or slo >= hi:
                continue
            a = self._shard_arrays(p).get(field)
            if a is None:
                raise KeyError(f"field {field!r} absent from shard {p}")
            cols = a.shape[1:]
            chunks.append(a[max(lo - slo, 0):max(min(hi, shi) - slo, 0)])
        if cols is None:
            # an ALL-ghost request (a device whose rows are entirely mesh
            # padding): zeros, shaped like the field's columns
            a0 = self._shard_arrays(self.parts[0][2]).get(field)
            if a0 is None:
                raise KeyError(f"field {field!r} absent from shard set")
            return np.zeros((hi - lo,) + a0.shape[1:])
        got = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        if got.shape[0] < hi - lo:        # ghost-row tail: zeros
            pad = np.zeros((hi - lo - got.shape[0],) + cols)
            got = np.concatenate([got, pad])
        return got


def restore_sharded_array(src, field: str, sharding, shape, dtype=None):
    """The reference builds a device array of ``field`` across a mesh,
    each process reading only its rows' shard files: not ported yet (the
    distributed port, ROADMAP Queue 1 item 7).  A single-device resume
    reads the assembled set (:func:`load_sharded`) or rows through
    :class:`ShardedCheckpointReader`."""
    raise NotImplementedError(
        "restore_sharded_array: the restore across a mesh is not ported "
        "yet (ROADMAP Queue 1 item 7, torch.distributed)")


# ---------------------------------------------------------------------------
# PH state capture / restore
# ---------------------------------------------------------------------------
def capture_ph(opt, hub=None) -> WheelCheckpoint | None:
    """Snapshot a PH-like opt object: host copies of its host mirrors of
    W, xbars, xsqbars and rho (each must be a numpy array: a tensor there
    raises rather than fetch), so this fetches nothing from the device.
    Returns None for an opt object without PH state, so callers skip
    cleanly.  No autotuner state is written (the autotuner is ROADMAP
    Queue 1 item 5): ``tune_state`` stays empty."""
    W = getattr(opt, "W", None)
    if W is None:
        return None
    for f in _ARRAY_FIELDS:
        v = getattr(opt, f, None)
        if v is not None and not isinstance(v, np.ndarray):
            raise TypeError(
                f"opt.{f} is a {type(v).__name__}, not a host numpy array: "
                "a capture must not touch the device")
    ck = WheelCheckpoint(
        iteration=int(getattr(opt, "_iter", 0)),
        W=np.array(W, dtype=np.float64, copy=True),
        xbars=np.array(opt.xbars, dtype=np.float64, copy=True)
        if getattr(opt, "xbars", None) is not None else None,
        xsqbars=np.array(opt.xsqbars, dtype=np.float64, copy=True)
        if getattr(opt, "xsqbars", None) is not None else None,
        rho=np.array(opt.rho, dtype=np.float64, copy=True)
        if getattr(opt, "rho", None) is not None else None,
        meta={
            "S": int(W.shape[0]), "K": int(W.shape[1]),
            "opt_class": type(opt).__name__,
            "num_scenarios": len(getattr(opt, "all_scenario_names", ())),
        },
    )
    if hub is not None:
        ck.best_inner = float(getattr(hub, "BestInnerBound", float("inf")))
        ck.best_outer = float(getattr(hub, "BestOuterBound", float("-inf")))
        # bounds are stored WITH their kind: validity is a property of
        # the bound, not of which spoke slot happens to hold it in the
        # (possibly different) resumed wheel
        outer = getattr(hub, "outerbound_spoke_indices", set()) or set()
        inner = getattr(hub, "innerbound_spoke_indices", set()) or set()
        ck.spoke_bounds = {
            str(idx): ["outer" if idx in outer else "inner", float(b)]
            for idx, b in (getattr(hub, "latest_spoke_bounds", {})
                           or {}).items()
            if idx in outer or idx in inner}
    return ck


def restore_ph(opt, ckpt: WheelCheckpoint):
    """Re-seat PH state from a checkpoint (the post-Iter0 seam: Iter0's
    plain warm-up solve has run, and the W/xbars/rho it computed are
    REPLACED wholesale, so the next iterk solve sees exactly the
    checkpointed augmented objective).  Also offsets the iteration
    counter: ``PHIterLimit`` keeps meaning TOTAL iterations across
    restarts (``iterk_loop`` starts at ``_iter_base + 1``).  A
    ``tune_state`` the file holds (one the reference wrote) stays on the
    checkpoint and is not acted on: the autotuner is ROADMAP Queue 1
    item 5."""
    S, K = opt.W.shape
    if ckpt.W is None or ckpt.W.shape != (S, K):
        raise RuntimeError(
            f"checkpoint shape {ckpt.shape} does not match this wheel's "
            f"PH state ({S}, {K}) — resuming a different family?")
    opt.W = np.array(ckpt.W, copy=True)
    if ckpt.xbars is not None:
        opt.xbars = np.array(ckpt.xbars, copy=True)
    if ckpt.xsqbars is not None:
        opt.xsqbars = np.array(ckpt.xsqbars, copy=True)
    if ckpt.rho is not None:
        opt.rho = np.array(ckpt.rho, copy=True)
    opt._iter_base = int(ckpt.iteration)
    if hasattr(opt, "_bump_state_version"):
        opt._bump_state_version()   # hub payload tokens must see new state
    _CTR_RESTORES.inc(1)
    if _trace.enabled():
        _trace.instant("ckpt", "restore", iteration=ckpt.iteration,
                       best_inner=ckpt.best_inner,
                       best_outer=ckpt.best_outer)
    _log.info("restored checkpoint at iteration %d (inner=%.6g outer=%.6g)",
              ckpt.iteration, ckpt.best_inner, ckpt.best_outer)


# ---------------------------------------------------------------------------
# Async manager
# ---------------------------------------------------------------------------
class CheckpointManager:
    """Cadence-gated asynchronous checkpointing for one wheel run.

    ``maybe_capture(iteration, snapshot_fn)`` snapshots when the wall
    clock (``every_secs``) or iteration (``every_iters``) cadence is due
    and the iteration advanced; the snapshot is pure host copies
    (guarded: implicit D2H disallowed, explicit hostsync fetches billed
    to ``checkpoint.capture_fetches`` — zero on every shipped path), and
    the npz write runs on a dedicated writer thread that coalesces to
    the newest pending snapshot, so a slow disk can never backlog or
    stall the hub loop.  ``keep`` most-recent files are retained.
    """

    def __init__(self, directory: str, every_secs: float | None = 60.0,
                 every_iters: int | None = None, keep: int = 3,
                 tag: str = "wheel", fresh_start: bool = False):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        if fresh_start:
            # a COLD run pointed at a reused directory: a previous run's
            # snapshots must not survive (retention keys on iteration
            # only, so they would out-prune this run's early snapshots
            # AND hijack a later resume with foreign state) — the
            # spinners pass fresh_start=True whenever no resume loaded
            stale = [p for _, p in list_checkpoints(self.directory)]
            for p in stale:
                remove_checkpoint_files(p)
            if stale:
                _log.info("cold start: cleared %d stale checkpoint(s) "
                          "from %s", len(stale), self.directory)
        self.every_secs = None if every_secs in (None, 0) else float(every_secs)
        self.every_iters = None if not every_iters else int(every_iters)
        self.keep = max(1, int(keep))
        self.tag = str(tag)
        self._last_t = time.monotonic()
        self._last_iter = None
        self._lock = threading.Lock()
        self._pending: WheelCheckpoint | None = None
        self._cv = threading.Condition(self._lock)
        self._writing = False
        self._closed = False
        self._thread: threading.Thread | None = None

    # ---- cadence ----------------------------------------------------------
    def _due(self, iteration: int) -> bool:
        if self._last_iter is not None and iteration <= self._last_iter:
            return False        # never re-capture the same iteration
        if self.every_iters is not None:
            base = -self.every_iters if self._last_iter is None \
                else self._last_iter
            if iteration - base >= self.every_iters:
                return True
        if self.every_secs is not None:
            return time.monotonic() - self._last_t >= self.every_secs
        return False

    def maybe_capture(self, iteration: int, snapshot_fn) -> bool:
        if self._closed or not self._due(iteration):
            return False
        return self.capture(iteration, snapshot_fn)

    def capture(self, iteration: int, snapshot_fn) -> bool:
        """Snapshot NOW and enqueue the write.  Returns False when the
        snapshot builder declined (returned None)."""
        from ..solvers import hostsync

        # THREAD-LOCAL fetch accounting: concurrent spoke threads fetch
        # continuously in a live wheel, and a process-global counter
        # delta would bill their traffic as capture fetches — false
        # positives in the exact signal the zero pin exists to watch
        with _trace.span("ckpt", "capture", iteration=int(iteration)):
            with hostsync.track() as _ftr:
                snap = snapshot_fn()
        if snap is None:
            # a hub whose opt carries no snapshot-able state (e.g. a
            # Benders root): advance the cadence clocks anyway so the
            # decline doesn't refire on EVERY sync, and say once that
            # the armed checkpoint_dir is inert for this hub
            self._last_t = time.monotonic()
            self._last_iter = int(iteration)
            _metrics.inc("checkpoint.captures_declined")
            if not getattr(self, "_declined_warned", False):
                self._declined_warned = True
                _log.warning(
                    "snapshot builder declined (opt has no checkpointable "
                    "PH state) — checkpointing is inactive for this hub")
            return False
        # the zero-fetch property, measured not presumed: any explicit
        # decision-path fetch inside the snapshot lands here (pinned ==0)
        _CTR_CAPTURE_FETCHES.inc(_ftr.count)
        _CTR_CAPTURES.inc(1)
        snap.iteration = int(iteration)
        self._last_t = time.monotonic()
        self._last_iter = int(iteration)
        with self._cv:
            if self._pending is not None:
                _CTR_COALESCED.inc(1)     # newest snapshot wins
            self._pending = snap
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._writer_loop, name="ckpt-writer",
                    daemon=True)
                self._thread.start()
            self._cv.notify_all()
        return True

    # ---- writer thread ----------------------------------------------------
    def _writer_loop(self):
        # numpy and file I/O only: the cylinders share this interpreter
        while True:
            with self._cv:
                while self._pending is None and not self._closed:
                    self._cv.wait(timeout=1.0)
                if self._pending is None and self._closed:
                    return
                snap, self._pending = self._pending, None
                self._writing = True
            try:
                self._write(snap)
            finally:
                with self._cv:
                    self._writing = False
                    self._cv.notify_all()

    def _write(self, snap: WheelCheckpoint):
        t0 = time.perf_counter()
        path = checkpoint_path(self.directory, snap.iteration, self.tag)
        try:
            with _trace.span("ckpt", "write", iteration=snap.iteration):
                save(snap, path)
            _CTR_WRITES.inc(1)
            _HIST_WRITE_SECS.add(time.perf_counter() - t0)
            self._prune()
        except Exception as e:
            # a full disk must degrade the run's resumability, never the
            # run itself
            _CTR_WRITE_ERRORS.inc(1)
            _log.warning("checkpoint write failed (%s): %r", path, e)

    def _prune(self):
        for _, p in list_checkpoints(self.directory)[:-self.keep]:
            # a complete sharded set is listed by its shard-0 path:
            # removing that alone would orphan the sibling shards
            remove_checkpoint_files(p)

    # ---- teardown ---------------------------------------------------------
    def flush(self, timeout: float = 30.0) -> bool:
        """Wait for every enqueued write to land (True on success)."""
        deadline = time.monotonic() + timeout
        with self._cv:
            while self._pending is not None or self._writing:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._cv.wait(timeout=left)
        return True

    def close(self, timeout: float = 30.0):
        self.flush(timeout)
        with self._cv:
            self._closed = True
            self._cv.notify_all()


# ---------------------------------------------------------------------------
# Legacy W/xbar interchange (mpi-sppy wxbarutils csv format)
# ---------------------------------------------------------------------------
def write_wxbar(opt, w_fname=None, xbar_fname=None, sep_files=False):
    """Engine-side writer behind the WXBarWriter extension.

    ``.npz`` targets get a REAL checkpoint (atomic, versioned, holding W
    and xbar together — an ``xbar_fname`` naming the SAME file is then
    redundant); any other target keeps the reference's csv formats
    byte-compatible (``scenario,varname,value`` W rows appended per
    iteration, ``varname,value`` xbar rows) via
    :mod:`..utils.wxbarutils`.  Mixed forms write BOTH targets —
    an npz W next to a csv xbar still produces the csv (the read side
    resolves the same mix slot-by-slot).
    """
    from ..utils import wxbarutils

    ck_box = []

    def _ck():
        """One capture per call, however many npz targets consume it."""
        if not ck_box:
            ck_box.append(capture_ph(opt))
        return ck_box[0]

    if w_fname:
        if str(w_fname).endswith(".npz"):
            if _ck() is not None:
                save(_ck(), w_fname)
            if xbar_fname == w_fname:
                return           # one checkpoint already carries both
        else:
            wxbarutils.write_W_to_file(opt, w_fname, sep_files=sep_files)
    if xbar_fname:
        if str(xbar_fname).endswith(".npz"):
            if _ck() is not None:
                save(_ck(), xbar_fname)
        else:
            wxbarutils.write_xbar_to_file(opt, xbar_fname)


def read_wxbar(opt, w_fname=None, xbar_fname=None, sep_files=False):
    """Engine-side reader behind the WXBarReader extension: a ``.npz``
    W target restores the full checkpoint (W, xbar, rho) in one shot;
    csv files go through the legacy readers unchanged.  Mixed forms
    respect their slot — an npz passed as ``xbar_fname`` next to a csv
    ``w_fname`` restores only the xbar fields, never clobbering the W
    the caller explicitly sourced from the csv."""
    from ..utils import wxbarutils

    def _restore_npz(fname, want_w, want_xbar):
        ck = load(fname)
        # same family guard as restore_ph: a wrong-shaped W silently
        # installed here would corrupt the duals instead of failing loud
        S, K = opt.W.shape
        if ck.W is not None and ck.W.shape != (S, K):
            raise RuntimeError(
                f"checkpoint {fname} has W shape {ck.W.shape}; this "
                f"opt's PH state is ({S}, {K}) — a different family?")
        if want_w:
            if ck.W is not None:
                opt.W = np.array(ck.W, copy=True)
            if ck.rho is not None:
                opt.rho = np.array(ck.rho, copy=True)
        if want_xbar:
            if ck.xbars is not None:
                opt.xbars = np.array(ck.xbars, copy=True)
            if ck.xsqbars is not None:
                opt.xsqbars = np.array(ck.xsqbars, copy=True)
        if hasattr(opt, "_bump_state_version"):
            opt._bump_state_version()

    if w_fname and str(w_fname).endswith(".npz"):
        # the W checkpoint covers xbar too UNLESS a distinct xbar source
        # was requested alongside it
        _restore_npz(w_fname, want_w=True,
                     want_xbar=not xbar_fname or xbar_fname == w_fname)
        if xbar_fname == w_fname:
            xbar_fname = None
        w_fname = None
    elif w_fname:
        wxbarutils.set_W_from_file(w_fname, opt, sep_files=sep_files)
        w_fname = None
    if xbar_fname:
        if str(xbar_fname).endswith(".npz"):
            _restore_npz(xbar_fname, want_w=False, want_xbar=True)
        else:
            wxbarutils.set_xbar_from_file(xbar_fname, opt)
