"""SolveServer: a long-lived, multi-tenant, warm-path wheel service.

Port of ``tpusppy/service/server.py``.  A process that never goes cold:
each shape family's captured device programs (the CUDA graphs of its
sweep loops and window steps, :mod:`..solvers.device_loop`) and its
kernels stay resident while solve requests come and go.

Request lifecycle (each stage observable in the per-request SLO record):

1. **ingest**: :meth:`SolveServer.submit` resolves the request's model
   (farmer, uc_lite, sslp, sizes, netdes, or a custom creator) and runs
   :func:`.canonical.ingest` ONCE: canonical batched arrays and the
   shape-family key.
2. **warm bind**: every cylinder of a request's wheel runs as an owner
   token the server keeps for its family and cylinder role (the opt option
   ``device_owner``), released only when the family is retired or the
   server shuts down.  A request of a family seen before copies its
   numbers into the buffers of the graphs an earlier request captured and
   replays them: it captures no graph and builds no kernel library.
3. **schedule**: requests queue FIFO under family affinity; the executor
   runs ONE wheel at a time and TIME-SLICES when others wait: a running
   wheel parks through the hub's ``preempt_check`` at a window boundary,
   its state banks through the checkpoint seam, and the tenant re-queues;
   the resumed slice continues with its bounds monotone.  With
   ``batch_slots`` K > 1, same-family self-certifying tenants share one
   tenant window instead (:mod:`.batching`).
4. **SLO record**: queue wait, time to the first iteration, bounds, gap,
   iterations a second, slices, preemptions, wall; latency percentiles
   ride the ``service.*`` histograms.  The record keeps the reference's
   keys: ``aot_misses`` counts the graphs the request captured
   (``device_loop.captures``), ``aot_hits`` the graph replays it ran
   (``device_loop.replays``) and ``compile_s`` the seconds of its captures
   and of any kernel build (``device_loop.capture_secs`` and
   ``cuda_kernels.build_secs``).  Across a process restart the port is
   cold: only the built kernel libraries survive on disk.

What is shared across tenants: captured programs and kernels.  What is
NOT shared: batch coefficient arrays (each request's own numbers, copied
into the captured buffers), wheel state (W, xbars, rho), bounds,
checkpoints.  The reference's executable cache and autotuner verdicts have
no counterpart: ``batch_slots`` is used as given, as the reference does
with no verdict banked.
"""

from __future__ import annotations

import collections
import os
import tempfile
import threading
import time
import uuid
from math import inf

import numpy as np

from ..obs import metrics as _metrics
from ..obs import telemetry as _telemetry
from ..obs import trace as _trace
from ..obs.log import get_logger
from ..resilience import faults as _faults
from .. import resolve_device
from ..solvers import device_loop
from . import canonical as _canonical
from .journal import RequestJournal

_log = get_logger("service")

_CTR_REQUESTS = _metrics.counter("service.requests")
_CTR_COMPLETED = _metrics.counter("service.completed")
_CTR_FAILED = _metrics.counter("service.failed")
_CTR_WARM_HITS = _metrics.counter("service.warm_hits")
_CTR_COLD_FAMILIES = _metrics.counter("service.cold_families")
_CTR_SLICES = _metrics.counter("service.slices")
_CTR_RECOVERED = _metrics.counter("service.recovered")
_CTR_RECOVERED_COLD = _metrics.counter("service.recovered_cold")
_CTR_REJECTED = _metrics.counter("service.rejected_overload")
_CTR_DEADLINE = _metrics.counter("service.deadline_failed")
_CTR_DUPLICATES = _metrics.counter("service.duplicate_submits")
_HIST_QUEUE_WAIT = _metrics.histogram("service.queue_wait_s")
_HIST_WALL = _metrics.histogram("service.wall_s")
_HIST_TTFI = _metrics.histogram("service.ttfi_s")

#: Registry deltas billed into a record's compile/warm keys:
#: (record key, [metric names summed]).
_WARM_KEYS = (("compile_s", ("device_loop.capture_secs",
                             "cuda_kernels.build_secs")),
              ("aot_hits", ("device_loop.replays",)),
              ("aot_misses", ("device_loop.captures",)))


class ServerOverloaded(RuntimeError):
    """Typed fast-fail admission rejection: the bounded queue is full.
    Over the TCP transport this surfaces as a structured
    ``{"status": "rejected", "error_code": "overload"}`` payload —
    clients back off instead of timing out."""

    code = "overload"


class ServerClosed(RuntimeError):
    """Submit refused because the server is shutting down.  Typed (and
    surfaced over TCP as ``error_code="unavailable"``) so a client can
    tell "retry against the restarted server" apart from "my request is
    malformed"."""

    code = "unavailable"


def _model_registry():
    """Name -> (module, default opt options).  Lazily imported so the
    server module stays importable without touching every model."""
    from ..models import farmer, netdes, sizes, sslp, uc_lite

    return {
        "farmer": (farmer, {"defaultPHrho": 1.0,
                            "xhat_looper_options": {"scen_limit": 3}}),
        # UC runs the bench wheel's rho (bench_uc.py: LP-relaxation-tight
        # family, rho=500 matches the cost scale)
        "uc_lite": (uc_lite, {"defaultPHrho": 500.0,
                              "xhat_looper_options": {"scen_limit": 3}}),
        "sslp": (sslp, {"defaultPHrho": 5.0,
                        "xhat_looper_options": {"scen_limit": 3}}),
        # integer families (doc/integer.md): one-line requests for the
        # batched integer wheel — rho from the example scripts; requests
        # add {"relax_integers": False} in creator_kwargs for the true
        # integer posture (the sweep arms itself from the int pattern)
        "sizes": (sizes, {"defaultPHrho": 0.01,
                          "xhat_looper_options": {"scen_limit": 3}}),
        "netdes": (netdes, {"defaultPHrho": 1.0,
                            "xhat_looper_options": {"scen_limit": 3}}),
    }


class SolveRequest:
    """One solve request.

    Args:
      model: registry name ("farmer", "uc_lite", "sslp") — or pass
        ``scenario_creator`` + ``names`` for a custom family (in-process
        submits only; the TCP transport is name-based).
      num_scens: scenario count.
      creator_kwargs: extra scenario-creator kwargs (seedoffset,
        crops_multiplier, num_gens, ... — routed through the model's
        ``kw_creator``).
      options: opt/hub option overrides (PHIterLimit, rel_gap,
        solver_options, ...).  ``rel_gap`` defaults to the server's.
      request_id: optional stable id (generated when empty).  A STABLE
        id is the idempotency key: re-submitting a journaled id — a
        client retry after a reconnect or a server restart — resolves to
        the original record instead of starting a second run.
      deadline_secs: optional wall-clock budget from ACCEPTANCE: a
        request still unfinished past it parks at the next checkpoint
        seam and completes ``failed`` (``error_code="deadline"``,
        checkpoint banked) instead of burning scheduler quantum forever.
        The deadline is absolute — it keeps ticking across server
        restarts.
      qos: QoS class ("interactive" < "standard" < "batch") — decides
        SLOT ASSIGNMENT when several same-family tenants compete for a
        continuous-batching slot (doc/serving.md "Continuous batching");
        ties keep submission order, so same-class requests retain FIFO
        semantics.  Scheduler-side only (popped from the canonical
        settings key like rel_gap).
      trace_id: request-scoped trace id (doc/observability.md "The
        request telemetry plane").  Minted at the OUTERMOST edge —
        ``SolveClient.submit`` — and carried here through the wire;
        minted fresh only for requests that arrive without one
        (in-process submits).  Persisted in the journal, so a
        SIGKILL-recovered request keeps its trace.
    """

    def __init__(self, model="farmer", num_scens=3, creator_kwargs=None,
                 options=None, request_id=None, scenario_creator=None,
                 names=None, deadline_secs=None, qos=None,
                 trace_id=None):
        self.model = str(model)
        self.num_scens = int(num_scens)
        self.creator_kwargs = dict(creator_kwargs or {})
        self.options = dict(options or {})
        self.request_id = request_id or f"req-{uuid.uuid4().hex[:10]}"
        self.scenario_creator = scenario_creator
        self.names = names
        if deadline_secs is None:
            # options spelling works too, like rel_gap/linger_secs (it
            # is a hub-side knob — _resolve pops it from the canonical
            # settings key either way)
            deadline_secs = self.options.get("deadline_secs")
        self.deadline_secs = (None if deadline_secs is None
                              else float(deadline_secs))
        if qos is None:
            qos = self.options.get("qos")
        self.qos = str(qos or "standard")
        self.trace_id = str(trace_id or _telemetry.mint_trace_id())

    @classmethod
    def from_dict(cls, d: dict) -> "SolveRequest":
        return cls(model=d.get("model", "farmer"),
                   num_scens=d.get("num_scens", 3),
                   creator_kwargs=d.get("creator_kwargs"),
                   options=d.get("options"),
                   request_id=d.get("request_id"),
                   deadline_secs=d.get("deadline_secs"),
                   qos=d.get("qos"),
                   trace_id=d.get("trace_id"))

    def to_dict(self) -> dict:
        """The journal/wire form.  Custom in-process creators are NOT
        representable (callables don't journal) — such requests are
        accepted but flagged unrecoverable in the WAL."""
        return {"model": self.model, "num_scens": self.num_scens,
                "creator_kwargs": dict(self.creator_kwargs),
                "options": dict(self.options),
                "request_id": self.request_id,
                "deadline_secs": self.deadline_secs,
                "qos": self.qos,
                "trace_id": self.trace_id}


def _blank_record(rid, model, family, fingerprint) -> dict:
    """THE SLO-record template — the single source of the field set
    (both tenant constructors build from it; a recovered tenant's
    journaled snapshot overlays it, so a field added here can never be
    silently absent after a restart)."""
    return {
        "request_id": rid, "model": model,
        "family": family, "fingerprint": fingerprint,
        "status": "queued", "warm_hit": None,
        "queue_wait_s": None, "exec_s": 0.0, "wall_s": None,
        "ttfi_s": None, "compile_s": 0.0,
        "aot_hits": 0.0, "aot_misses": 0.0,
        "slices": 0, "preemptions": 0, "iters": 0,
        "iters_per_sec": None, "rel_gap": None,
        "inner": None, "outer": None, "certified": False,
        "bounds_monotone": True, "error": None, "error_code": None,
        "recovered": None,
        # continuous batching (doc/serving.md): QoS class, whether any
        # execution ran inside a fused tenant batch, and the tenant's
        # live-row share of the shared dispatches' model FLOPs
        "qos": "standard", "batched": False, "attributed_flops": 0.0,
        # request-scoped trace id (the telemetry plane's merge key —
        # riding the record means journal replay restores it for free)
        "trace_id": None,
    }


class _Tenant:
    """Scheduler-side state of one request.

    ``family`` is the canonical model's FAMILY DIGEST (the stable short
    hash of the family-key tuple) rather than the tuple itself: equal
    tuples <=> equal digests, and a digest survives the journal, so
    affinity/warm bookkeeping keys stay comparable across server
    restarts."""

    def __init__(self, req, canon, opt_options, creator, names, workdir):
        self.req = req
        self.canonical = canon             # dropped on completion (the
        self.family = canon.family_digest  # batched arrays are the bulk
        self.opt_options = opt_options     # of a tenant's footprint)
        self.creator = creator
        self.names = names
        self.id = req.request_id
        self.dir = os.path.join(workdir, "tenants", self.id)
        self.seq = 0                       # submission order (server sets)
        self.status = "queued"
        self.slices = 0
        self.submitted = time.monotonic()
        self.deadline_at = (time.time() + req.deadline_secs
                            if req.deadline_secs else None)
        self.first_exec = None
        self.done = threading.Event()
        self.last_outer = -inf
        self.last_inner = inf
        self.record = _blank_record(self.id, req.model,
                                    canon.family_digest,
                                    canon.fingerprint[:12])
        self.record["qos"] = req.qos
        self.trace = req.trace_id
        self.record["trace_id"] = req.trace_id

    def past_deadline(self) -> bool:
        return self.deadline_at is not None and time.time() > self.deadline_at

    @classmethod
    def from_journal(cls, jr, workdir):
        """Rebuild scheduler bookkeeping from a journal record — the
        restart-recovery constructor.  The canonical model is NOT
        rebuilt here (finished stubs never need it; unfinished tenants
        re-ingest in ``SolveServer._recover``)."""
        t = object.__new__(cls)
        t.req = (SolveRequest.from_dict(jr.request) if jr.request
                 else SolveRequest(request_id=jr.rid))
        t.req.request_id = jr.rid
        t.canonical = None
        t.opt_options = None
        t.creator = None
        t.names = None
        t.family = jr.family
        t.id = jr.rid
        t.dir = jr.checkpoint_dir or os.path.join(workdir, "tenants",
                                                  jr.rid)
        t.seq = int(jr.seq)
        t.status = jr.status
        t.slices = int(jr.record.get("slices") or 0)
        t.submitted = time.monotonic()
        t.deadline_at = jr.deadline_at
        t.first_exec = None
        t.done = threading.Event()
        rec = dict(jr.record)
        if not rec and jr.undelivered:
            # no status snapshot ever landed (an undelivered-rejection
            # stub, or a terminal transition whose append failed): the
            # banked response payload is the best record we have
            rec = dict(jr.undelivered)
        ob, ib = rec.get("outer"), rec.get("inner")
        t.last_outer = float(ob) if ob is not None and np.isfinite(ob) \
            else -inf
        t.last_inner = float(ib) if ib is not None and np.isfinite(ib) \
            else inf
        base = _blank_record(t.id, t.req.model, jr.family, "")
        base.update(rec)
        base["status"] = jr.status
        # the trace survives the restart: the journal carries the id
        # first-class (accepted line), with the request payload / record
        # snapshot as legacy fallbacks — a recovered request's spans
        # continue the SAME trace minted at the client
        t.trace = (getattr(jr, "trace_id", "")
                   or base.get("trace_id") or t.req.trace_id)
        base["trace_id"] = t.trace
        t.req.trace_id = t.trace
        t.record = base
        return t


class SolveServer:
    """The long-lived solve server (in-process API; TCP transport in
    :mod:`tpusppy.service.net`).

    Args:
      work_dir: root for per-tenant checkpoints and the request journal
        (a temp dir when omitted).  Pointing a later server lifetime at
        the same ``work_dir`` recovers its journaled requests.
      quantum_secs: minimum uninterrupted run time a wheel gets before a
        waiting tenant may preempt it.
      rel_gap: default certification target per request.
      max_queue: admission bound — a submit that would push the run
        queue past this depth fast-fails with the typed
        :class:`ServerOverloaded` (``service.rejected_overload``).
        None (default) = unbounded.
      checkpoint_every_secs: mid-slice checkpoint cadence for every
        tenant wheel (on top of the terminal park capture) — bounds how
        much work a server crash can cost a RUNNING tenant.
      recover: replay the work dir's request journal on startup
        (doc/serving.md "Durability"): parked tenants re-ingest and
        resume from their banked checkpoints, queued-never-started
        tenants re-enter the queue in submission order, mid-slice
        tenants without a complete checkpoint restart from scratch
        loudly (``service.recovered_cold``), and finished tenants'
        records stay fetchable by id.  :meth:`recover_from` is the
        explicit spelling.
      batch_slots: continuous batching (doc/serving.md): K > 1 fuses up
        to K concurrent SAME-FAMILY self-certifying tenants into one
        tenant-batched megastep (``service/batching.py``) — joins and
        evictions at window boundaries, per-tenant trajectories exactly
        the solo wheel's.  None/1 keeps pure time-slicing.

    The executor thread does all device work; a request whose options do
    not ask for the CPU (``"device": "cpu"``) needs a GPU, and its submit
    raises without one.
    """

    def __init__(self, work_dir=None, quantum_secs=5.0, rel_gap=1e-3,
                 linger_secs=30.0, max_queue=None,
                 checkpoint_every_secs=20.0, recover=False,
                 in_wheel_bounds=False, batch_slots=None,
                 _start_executor=True):
        self.work_dir = work_dir or tempfile.mkdtemp(prefix="tpusppy_srv_")
        os.makedirs(os.path.join(self.work_dir, "tenants"), exist_ok=True)
        self.quantum_secs = float(quantum_secs)
        self.rel_gap = float(rel_gap)
        self.linger_secs = float(linger_secs)
        # self-certifying tenant wheels (doc/pipeline.md "In-wheel
        # certification"): the megastep's fused bound pass certifies the
        # gap, so a slice runs ZERO spoke threads/device programs —
        # shrinking each request's device footprint to one cylinder.
        # Server default; a request option "in_wheel_bounds" overrides
        # per tenant.
        self.in_wheel_bounds = bool(in_wheel_bounds)
        self.batch_slots = (None if not batch_slots or int(batch_slots) < 2
                            else int(batch_slots))
        self.max_queue = None if max_queue is None else int(max_queue)
        self.checkpoint_every_secs = float(checkpoint_every_secs)
        self._cv = threading.Condition()
        self._runq: collections.deque = collections.deque()
        self._tenants: dict = {}
        self._families: dict = {}          # family digest -> request count
        self._families_done: set = set()   # families with a COMPLETED run
        self._family_open: dict = {}       # family -> set of UNFINISHED seqs
                                           # (affinity checks stay O(open),
                                           # never O(historical requests))
        self._force_preempt: set = set()
        self._stop = False
        self._drain = True                 # shutdown(wait=True) semantics
        self._seq = 0
        # the live telemetry plane (doc/observability.md): bounded
        # per-request progress queues the TCP frontend streams from
        # (SolveClient.watch), plus batch-occupancy bookkeeping for the
        # scrape endpoint's status snapshot
        self.progress = _telemetry.ProgressBus()
        self._batch_live: dict = {}
        _telemetry.record_clock_sync("scheduler", work_dir=self.work_dir)
        # the write-ahead request journal (service/journal.py): accepted
        # requests + status transitions persist under the work dir, so a
        # crashed server's obligations survive it
        self.journal = RequestJournal(
            os.path.join(self.work_dir, "journal.jsonl"))
        # family digest -> role -> the owner token its cylinders' device
        # state belongs to (captured graphs, kernel operands): the warm
        # path.  Released by retire_family and shutdown
        self._owners: dict = {}
        self._owners_lock = threading.Lock()
        if recover:
            self._recover()
        self._executor = None
        if _start_executor:
            self._executor = threading.Thread(
                target=self._executor_loop, name="solve-server",
                daemon=True)
            self._executor.start()

    @classmethod
    def recover_from(cls, work_dir, **kwargs):
        """A restarted server over an existing ``work_dir``: replay the
        journal, re-admit every unfinished tenant, serve finished
        records by id.  Equivalent to ``SolveServer(work_dir=...,
        recover=True, ...)``."""
        kwargs.setdefault("recover", True)
        return cls(work_dir=work_dir, **kwargs)

    # ---- lifecycle ----------------------------------------------------------
    # ---- device owners (the warm path) ------------------------------------
    def _owner(self, family: str, role: str):
        """The owner token of ``family``'s ``role`` cylinder (made on first
        use): every request of the family runs that cylinder as it, so a
        later request replays the graphs an earlier one captured."""
        with self._owners_lock:
            roles = self._owners.setdefault(family, {})
            tok = roles.get(role)
            if tok is None:
                tok = roles[role] = ("service", id(self), family, role)
            return tok

    def retire_family(self, family: str):
        """Free the device state (captured graphs, kernel operands) of
        ``family``'s owners; a later request of the family captures
        again."""
        with self._owners_lock:
            roles = self._owners.pop(family, {})
        for tok in roles.values():
            device_loop.release(tok)

    # ---- restart recovery ---------------------------------------------------
    def _recover(self):
        """Replay the journal into live scheduler state.  Runs on the
        constructing thread BEFORE the executor starts, so no locking is
        needed against ourselves."""
        from ..resilience import checkpoint as _ckpt

        replayed = self.journal.replay()
        if not replayed:
            return
        # journal writes during recovery go through the degrade-not-die
        # guard like everywhere else: an unwritable journal (disk full)
        # must not abort the restart and strand every journaled
        # obligation — it costs durability of the NEXT crash only
        self._journal_append_safe(lambda: self.journal.recovery_marker(
            {"pid": os.getpid(), "journaled": len(replayed)}))
        self._seq = max(r.seq for r in replayed.values()) + 1
        for jr in sorted(replayed.values(), key=lambda r: r.seq):
            t = _Tenant.from_journal(jr, self.work_dir)
            self._tenants[t.id] = t
            if jr.finished:
                # finished in a previous lifetime: the record stays
                # fetchable by id (result()/the TCP fetch op), and a
                # completed family is warm capital for followers
                # (undelivered-rejection stubs carry no family)
                if t.family:
                    self._families[t.family] = \
                        self._families.get(t.family, 0) + 1
                    if jr.status == "done":
                        self._families_done.add(t.family)
                t.done.set()
                continue
            if not jr.recoverable:
                # custom in-process creators don't journal (callables):
                # fail the obligation loudly rather than strand waiters
                t.status = "failed"
                t.record.update(
                    status="failed", error_code="unrecoverable",
                    error="request used a custom scenario_creator — not "
                          "recoverable across a server restart")
                self._families[t.family] = \
                    self._families.get(t.family, 0) + 1
                self._journal_safe(t.id, "failed", t.record)
                _CTR_FAILED.inc(1)
                t.done.set()
                continue
            try:
                creator, names, kwargs, opt_options = self._resolve(t.req)
                canon = _canonical.ingest(names, creator, kwargs,
                                          options=opt_options)
                t.req.creator_kwargs = kwargs
                t.canonical, t.opt_options = canon, opt_options
                t.creator, t.names = creator, names
                t.record["fingerprint"] = canon.fingerprint[:12]
                drifted = bool(jr.family
                               and canon.family_digest != jr.family)
                if drifted:
                    # the model code changed between lifetimes: the
                    # banked checkpoint/programs belong to a
                    # DIFFERENT program family — it must never be
                    # resumed (shape/settings mismatch), so the warm
                    # branch below is off the table and the stale
                    # checkpoints are wiped by the cold slice's
                    # fresh_start
                    _log.warning(
                        "request %s: family drifted across restart "
                        "(%s -> %s) — cold restart", t.id, jr.family,
                        canon.family_digest)
                    t.family = canon.family_digest
                    t.record["family"] = canon.family_digest
                    t.slices = 0
                    # PERSIST the new family: replay folds `family` from
                    # the accepted event, so without re-journaling it a
                    # SECOND restart would re-detect "drift" against the
                    # stale digest and wipe the legitimately-banked
                    # new-family checkpoints all over again
                    self._journal_append_safe(
                        lambda t=t, jr=jr, canon=canon:
                        self.journal.accepted(
                            rid=t.id, seq=t.seq,
                            request=t.req.to_dict(),
                            family=canon.family_digest,
                            checkpoint_dir=t.dir,
                            recoverable=jr.recoverable,
                            deadline_at=t.deadline_at,
                            record=t.record,
                            trace_id=t.trace))
            except Exception as e:
                t.status = "failed"
                t.record.update(status="failed", error_code="exception",
                                error=repr(e))
                self._families[t.family] = \
                    self._families.get(t.family, 0) + 1
                self._journal_safe(t.id, "failed", t.record)
                _CTR_FAILED.inc(1)
                t.done.set()
                continue
            banked = None if drifted else _ckpt.latest_iteration(t.dir)
            started = jr.status in ("running", "parked") or t.slices > 0
            if started and banked is not None:
                # warm resume: the park (or mid-slice cadence) checkpoint
                # carries W/xbars/rho + bounds; the next slice continues
                # with PHIterLimit total-iteration semantics and bounds
                # monotone vs the snapshot (seeded above from the
                # journaled record)
                t.slices = max(t.slices, 1)
                t.record["recovered"] = "warm"
                _log.info("request %s recovered PARKED at checkpoint "
                          "iteration %d", t.id, banked)
            elif started:
                # mid-slice with no complete checkpoint: the slice's
                # work is LOST — restart from scratch, loudly.  The
                # record's execution state resets WITH the scheduler's
                # (a journaled slices>0 would read as "started" at the
                # next recovery and re-trigger the cold path forever)
                _CTR_RECOVERED_COLD.inc(1)
                t.slices = 0
                t.record["recovered"] = "cold"
                t.last_outer, t.last_inner = -inf, inf
                t.record.update(slices=0, iters=0, ttfi_s=None,
                                exec_s=0.0)
                _log.warning(
                    "request %s was mid-slice with no complete "
                    "checkpoint — restarting from scratch", t.id)
            else:
                t.record["recovered"] = "requeued"
            t.status = "queued"
            t.record["status"] = "queued"
            # family bookkeeping keyed on the FINAL digest (drift above
            # may have rewritten t.family — counting earlier would bank
            # the stale digest and double-count the family forever)
            self._families[t.family] = self._families.get(t.family, 0) + 1
            self._family_open.setdefault(t.family, set()).add(t.seq)
            self._runq.append(t)           # seq-sorted iteration above
            _CTR_RECOVERED.inc(1)          # => original admission order
            self._journal_safe(t.id, "queued", t.record)
            # same trace_id across the kill: the recovered lifetime's
            # spans continue the trace the client minted
            _telemetry.tenant_instant(
                t.id, t.trace, "recovered",
                mode=t.record["recovered"], seq=t.seq)
            self.progress.emit(t.id, "recovered", status="queued",
                               mode=t.record["recovered"],
                               trace_id=t.trace)
        _log.info("recovery: %d journaled request(s) — %d re-admitted, "
                  "%d already finished", len(replayed), len(self._runq),
                  sum(1 for r in replayed.values() if r.finished))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    def shutdown(self, wait: bool = True, timeout: float = 600.0,
                 drain: bool | None = None, park_queued: bool = False):
        """Stop the server.  ``wait=True`` / ``drain=True`` (default)
        is the GRACEFUL DRAIN: admissions stop immediately (submit
        raises), every already-admitted request finishes (or parks on
        its deadline), and each final state is journaled by the normal
        transition path.  ``wait=False`` preempts the running wheel at
        its next window boundary and leaves unfinished tenants PARKED
        on disk — ``SolveServer.recover_from(work_dir)`` resumes them;
        ``park_queued=True`` additionally keeps queued-never-started
        tenants journaled as queued (recoverable) instead of cancelling
        them."""
        if drain is not None:
            wait = bool(drain)
        with self._cv:
            self._stop = True
            self._drain = bool(wait)
            if not wait:
                self._force_preempt.update(t.id for t in self._tenants.values()
                                           if t.status == "running")
                # queued-but-never-started tenants have no state to park:
                # CANCEL them loudly so result() waiters unblock instead
                # of timing out against a dead queue (park_queued=True
                # keeps them journaled-queued for a recovering
                # successor).  Tenants already PARKED in the queue DO
                # have banked checkpoints — they stay parked
                # (resumable), exactly like the running one
                for t in self._runq:
                    if t.slices > 0:
                        t.status = "parked"
                        t.record["status"] = "parked"
                    elif park_queued:
                        t.record["status"] = "queued"
                    else:
                        t.status = "cancelled"
                        t.record.update(
                            status="cancelled", error_code="cancelled",
                            error="server shut down before start")
                        t.canonical = None
                    self._journal_safe(t.id, t.record["status"], t.record)
                    self._close_tenant_locked(t)
                    self.progress.emit(t.id, t.record["status"],
                                       status=t.record["status"])
                    self.progress.mark_done(t.id)
                    t.done.set()
                self._runq.clear()
            self._cv.notify_all()
        if self._executor is not None:
            self._executor.join(timeout=timeout)
        # release the device memory the server held (the families' captured
        # programs, the content-keyed A caches): a clean shutdown parks no
        # orphan device state
        from ..spopt import clear_device_caches

        if self._executor is None or not self._executor.is_alive():
            for family in list(self._owners):
                self.retire_family(family)
        clear_device_caches()

    def _close_tenant_locked(self, t):
        """Retire a tenant from the affinity index (caller holds _cv)."""
        open_ = self._family_open.get(t.family)
        if open_ is not None:
            open_.discard(t.seq)
            if not open_:
                del self._family_open[t.family]

    def _journal_append_safe(self, fn):
        """Run one journal append; an IO failure (disk full, work dir
        yanked) costs DURABILITY of that entry, never the serving path
        itself — warned once per server."""
        try:
            fn()
        except Exception as e:
            if not getattr(self, "_journal_err_warned", False):
                self._journal_err_warned = True
                _log.warning("journal append failed (durability "
                             "degraded): %r", e)

    def _journal_safe(self, rid, status, record=None):
        self._journal_append_safe(
            lambda: self.journal.transition(rid, status, record))

    # ---- submission ---------------------------------------------------------
    def _resolve(self, req: SolveRequest):
        """(creator, names, creator_kwargs, opt_options) for one request
        — opt_options is the FINAL option dict the wheel opts run with,
        and therefore exactly what the canonicalizer must key on."""
        if req.scenario_creator is not None:
            creator = req.scenario_creator
            names = list(req.names or
                         [f"scen{i}" for i in range(req.num_scens)])
            kwargs = dict(req.creator_kwargs)
            defaults = {"defaultPHrho": 1.0,
                        "xhat_looper_options": {"scen_limit": 3}}
        else:
            registry = _model_registry()
            if req.model not in registry:
                raise ValueError(f"unknown model {req.model!r} "
                                 f"(have {sorted(registry)})")
            module, defaults = registry[req.model]
            names = module.scenario_names_creator(req.num_scens)
            kwargs = module.kw_creator(
                **dict(req.creator_kwargs, num_scens=req.num_scens))
            creator = module.scenario_creator
        opt_options = dict(defaults)
        opt_options.update({
            "PHIterLimit": 200, "convthresh": -1.0,
        })
        opt_options.update(req.options)
        # hub-side knobs must not leak into the canonical settings key
        for k in ("rel_gap", "abs_gap", "linger_secs", "deadline_secs",
                  "qos"):
            opt_options.pop(k, None)
        # the server-level self-certifying default resolves HERE so the
        # family key sees the effective value (a request that rode a
        # different server default must never warm-bind the other
        # variant's programs)
        if opt_options.get("in_wheel_bounds") is None:
            opt_options["in_wheel_bounds"] = self.in_wheel_bounds
        return creator, names, kwargs, opt_options

    def submit(self, req) -> str:
        """Ingest + canonicalize + enqueue; returns the request id.
        Ingestion runs on the CALLER's thread (pure numpy — it cannot
        disturb the executor's device work).

        IDEMPOTENT on request id: re-submitting an already-journaled id
        (a client retry after a reconnect, or after a server restart)
        returns the existing request's id instead of starting a second
        run — ``result(rid)`` then serves the original record.  The
        bounded queue fast-fails with :class:`ServerOverloaded` before
        paying for ingest."""
        if isinstance(req, dict):
            req = SolveRequest.from_dict(req)
        req_payload = req.to_dict()        # journal the ORIGINAL request
        with self._cv:
            if self._stop:
                raise ServerClosed("server is shut down")
            if req.request_id in self._tenants:
                _CTR_DUPLICATES.inc(1)
                _log.info("request %s re-submitted — resolving to the "
                          "existing record (idempotent)", req.request_id)
                return req.request_id
            if (self.max_queue is not None
                    and len(self._runq) >= self.max_queue):
                _CTR_REJECTED.inc(1)
                raise ServerOverloaded(
                    f"queue full ({len(self._runq)}/{self.max_queue}): "
                    f"request {req.request_id!r} rejected")
        if _faults.active():               # deterministic slow-ingest
            _faults.on_ingest()            # injection (stall_ingest)
        creator, names, kwargs, opt_options = self._resolve(req)
        # no GPU and no "device": "cpu" in the request: raise here, before
        # the request is accepted
        resolve_device(opt_options.get("device"))
        canon = _canonical.ingest(names, creator, kwargs,
                                  options=opt_options)
        t = _Tenant(req, canon, opt_options, creator, names, self.work_dir)
        t.req.creator_kwargs = kwargs
        with self._cv:
            if self._stop:
                # re-check under a lock hold BEFORE any visible state: a
                # shutdown racing the (slow, unlocked) ingest above must
                # not slip a tenant into a queue nobody will ever drain
                raise ServerClosed("server is shut down")
            if t.id in self._tenants:
                # two concurrent submits of the same id raced the
                # ingest: the loser resolves to the winner's record —
                # same idempotency contract as the pre-ingest check
                _CTR_DUPLICATES.inc(1)
                return t.id
            if (self.max_queue is not None
                    and len(self._runq) >= self.max_queue):
                # authoritative admission check at the enqueue (the
                # pre-ingest one is the cheap fast path; concurrent
                # ingests may both have passed it)
                _CTR_REJECTED.inc(1)
                raise ServerOverloaded(
                    f"queue full ({len(self._runq)}/{self.max_queue}): "
                    f"request {t.id!r} rejected")
            self._families[t.family] = \
                self._families.get(t.family, 0) + 1
            t.seq = self._seq
            self._seq += 1
            self._family_open.setdefault(t.family, set()).add(t.seq)
            self._tenants[t.id] = t
            # counted only once ACCEPTED (rejected duplicates/shutdown
            # races must not leave phantom requests on the dashboards)
            _CTR_REQUESTS.inc(1)
        # WRITE-AHEAD: the acceptance is journaled BEFORE the tenant
        # becomes runnable (enqueue + notify below) — otherwise a fast
        # executor could journal this tenant's 'running' (even 'done')
        # transition ahead of its 'accepted' line, and replay drops
        # status events for unknown rids (the crash would then recover
        # a mid-slice tenant as never-started).  The tenant is already
        # in _tenants, so duplicate submits in this window resolve
        # idempotently.
        self._journal_append_safe(lambda: self.journal.accepted(
            rid=t.id, seq=t.seq, request=req_payload,
            family=canon.family_digest, checkpoint_dir=t.dir,
            recoverable=req.scenario_creator is None,
            deadline_at=t.deadline_at, record=t.record,
            trace_id=t.trace))
        with self._cv:
            if self._stop:
                # a shutdown landed while we journaled: the executor may
                # already have drained and exited, so enqueueing now
                # would strand the waiters.  Un-admit loudly — and
                # journal the cancellation so a recovering successor
                # does not resurrect a request its submitter saw fail.
                del self._tenants[t.id]
                self._close_tenant_locked(t)
                self._families[t.family] -= 1
                t.status = "cancelled"
                t.record.update(status="cancelled",
                                error_code="cancelled",
                                error="server shut down during submit")
                self._journal_safe(t.id, "cancelled", t.record)
                # a racing result() waiter that already grabbed the
                # tenant object must unblock, not hang
                self.progress.emit(t.id, "cancelled", status="cancelled")
                self.progress.mark_done(t.id)
                t.done.set()
                raise ServerClosed("server is shut down")
            self._runq.append(t)
            self._cv.notify_all()
        # admission on the request's trace + progress stream: the first
        # event a watcher sees, and the span boundary trace_merge joins
        # to the client's submit instant
        _telemetry.tenant_instant(t.id, t.trace, "admitted",
                                  model=req.model, qos=req.qos,
                                  family=canon.family_digest, seq=t.seq)
        self.progress.emit(t.id, "queued", status="queued",
                           model=req.model, qos=req.qos,
                           trace_id=t.trace)
        # warm_hit is decided at FIRST EXECUTION, not here: only a family
        # whose capture leader actually COMPLETED has programs to bind
        # (family affinity guarantees the leader finishes first; a failed
        # leader must not mark its followers warm)
        _log.info("request %s (%s, family %s) queued", t.id, req.model,
                  canon.family_digest)
        return t.id

    def preempt(self, request_id: str):
        """Ask a running request to park at its next window boundary
        (deterministic preemption for tests/operators; the scheduler's
        own quantum preemption needs no call)."""
        with self._cv:
            self._force_preempt.add(request_id)

    # ---- results ------------------------------------------------------------
    def result(self, request_id: str, timeout: float | None = None) -> dict:
        """Block until the request finishes; returns its SLO record.
        A finished request that was retired from memory (or finished in
        a PREVIOUS server lifetime) still answers from the journal."""
        t = self._tenants.get(request_id)
        if t is None:
            rec = self._journal_record(request_id)
            if rec is not None:
                return rec
            raise KeyError(f"unknown (or retired) request id "
                           f"{request_id!r}")
        if not t.done.wait(timeout):
            raise TimeoutError(f"request {request_id} still "
                               f"{t.status} after {timeout}s")
        return dict(t.record)

    def _journal_record(self, request_id: str) -> dict | None:
        """Finished record for ``request_id`` from the journal (None
        when the journal never saw it, or it never finished).  Uses the
        stat-memoized replay — a polling fetch-by-id client must not
        re-parse the whole journal per call.  An UNDELIVERED banked
        response serves as the fallback: if the terminal transition
        append itself failed (durability degraded) but the frontend's
        failed-put payload was journaled, that payload is still the
        best record we have for the id."""
        try:
            jr = self.journal.replay_cached().get(request_id)
        except Exception:
            return None
        if jr is None:
            return None
        if jr.finished and jr.record:
            return dict(jr.record)
        if jr.undelivered:
            return dict(jr.undelivered)
        return None

    def lookup(self, request_id: str):
        """The live tenant for ``request_id`` (None when unknown) — the
        TCP frontend's non-blocking hook for fetch-by-id."""
        return self._tenants.get(request_id)

    def status_snapshot(self, request_id: str | None = None) -> dict:
        """The live status surface (the ``status`` RPC and the scrape
        endpoint's per-tenant gauges both render this).

        Whole-server form (``request_id=None``)::

            {"queue_depth", "requests_live", "batch_slots",
             "batch_slots_occupied", "requests": {rid: {status, model,
             qos, batched, trace_id, rel_gap, outer, inner, iters,
             certified, attributed_flops, mfu_pct,
             deadline_headroom_s, queue_wait_s, exec_s}}}

        Per-request form: ``{"request_id", "done", "status",
        "record"}`` — the record snapshot is served from memory (live
        tenants) or the journal (previous lifetimes), WITHOUT blocking
        for completion: the answer a poll-free client wakes on."""
        if request_id is not None:
            t = self._tenants.get(str(request_id))
            if t is not None:
                return {"request_id": str(request_id),
                        "done": t.done.is_set(), "status": t.status,
                        "record": dict(t.record)}
            rec = self._journal_record(str(request_id))
            return {"request_id": str(request_id),
                    "done": rec is not None,
                    "status": (rec or {}).get("status"),
                    "record": rec}
        now = time.time()
        with self._cv:
            tenants = list(self._tenants.values())
            qdepth = len(self._runq)
            batch = dict(self._batch_live)
        reqs = {}
        live = 0
        for t in tenants:
            r = t.record
            if t.status in ("queued", "running", "parked"):
                live += 1
            # no peak-rate table on the port: the MFU stays unreported
            mfu = None
            reqs[t.id] = {
                "status": t.status, "model": r.get("model"),
                "qos": r.get("qos"), "batched": r.get("batched"),
                "trace_id": r.get("trace_id"),
                "rel_gap": r.get("rel_gap"),
                "outer": r.get("outer"), "inner": r.get("inner"),
                "iters": r.get("iters"),
                "certified": r.get("certified"),
                "attributed_flops": r.get("attributed_flops"),
                "mfu_pct": mfu,
                "queue_wait_s": r.get("queue_wait_s"),
                "exec_s": r.get("exec_s"),
                "deadline_headroom_s": (
                    t.deadline_at - now
                    if t.deadline_at is not None else None),
            }
        return {"queue_depth": qdepth, "requests_live": live,
                "batch_slots": batch.get("k", self.batch_slots),
                "batch_slots_occupied": batch.get("occupied"),
                "requests": reqs}

    def retire_finished(self, keep: int = 0) -> int:
        """Drop finished tenants' bookkeeping (all but the newest
        ``keep``), returning how many were retired.  Completed tenants
        already released their batched arrays; this sheds the residual
        _Tenant + SLO-record dicts so a genuinely long-lived server's
        memory and ``slo_records`` cost stay bounded — call it (or wire
        it on a cadence) after harvesting the records you need.  The
        journal COMPACTS in the same sweep: retired records leave the
        file, retained ones fold to two lines each — so the journal's
        replay cost tracks the retained window, not server lifetime."""
        with self._cv:
            finished = [t for t in self._tenants.values()
                        if t.status in ("done", "failed", "cancelled")]
            finished.sort(key=lambda t: t.seq)
            drop = finished[:max(0, len(finished) - int(keep))]
            for t in drop:
                del self._tenants[t.id]
            retained = set(self._tenants)
        for t in drop:
            # progress-bus memory tracks the retained-record window
            self.progress.drop(t.id)
        try:
            # compact_keep folds + rewrites ATOMICALLY under the append
            # lock — a submit/transition racing this sweep serializes
            # against the rewrite instead of landing between read and
            # os.replace and being erased.  UNFINISHED records always
            # survive, retained or not: a submit journaled after the
            # retained-set snapshot must not be un-written.
            self.journal.compact_keep(
                lambda r: r.rid in retained or not r.finished)
        except Exception as e:
            _log.warning("journal compaction failed (file keeps "
                         "growing): %r", e)
        return len(drop)

    def slo_records(self) -> list:
        with self._cv:              # submit() inserts under this lock
            tenants = list(self._tenants.values())
        return [dict(t.record) for t in tenants]

    @staticmethod
    def _pct(values, q):
        """Nearest-rank percentile over this SERVER's own samples."""
        vals = sorted(v for v in values if v is not None)
        if not vals:
            return None
        return vals[min(len(vals) - 1, int(round(q * (len(vals) - 1))))]

    def slo_summary(self) -> dict:
        """Aggregate serving SLOs over this instance's RETAINED records
        (``retire_finished`` narrows the window).  Percentiles are
        computed from the records themselves — the ``service.*``
        registry histograms carry the same samples for obs/report
        consumers, but they are process-global and would conflate
        several server lifetimes in one process."""
        with self._cv:
            tenants = list(self._tenants.values())
        recs = [t.record for t in tenants]
        done = [r for r in recs if r["status"] == "done"]
        n_warm = sum(1 for r in done if r["warm_hit"])
        walls = [r["wall_s"] for r in done]
        return {
            "requests": len(tenants),
            "completed": len(done),
            "failed": sum(1 for r in recs if r["status"] == "failed"),
            "warm_hit_rate": (n_warm / len(done)) if done else None,
            "preemptions": sum(r["preemptions"] for r in recs),
            "p50_latency_s": self._pct(walls, 0.50),
            "p95_latency_s": self._pct(walls, 0.95),
            "p99_latency_s": self._pct(walls, 0.99),
            "p50_queue_wait_s": self._pct(
                [r["queue_wait_s"] for r in recs], 0.50),
            "p95_queue_wait_s": self._pct(
                [r["queue_wait_s"] for r in recs], 0.95),
            "p50_ttfi_s": self._pct([r["ttfi_s"] for r in recs], 0.50),
            "families": len(self._families),
        }

    # ---- the executor -------------------------------------------------------
    def _pick_next(self):
        """Next runnable tenant under FAMILY AFFINITY: a tenant never
        starts while an EARLIER-submitted tenant of the same shape
        family is still unfinished.  The first request of a family is
        its capture leader — letting a warm follower race a parked
        leader would hand the follower whatever program variants the
        leader had not reached yet (park/resume truncates execution
        paths), breaking the warm zero-capture contract the follower
        was promised.  Cross-family requests still time-slice freely.
        Blocking is answered from the ``_family_open`` index (seq sets
        of UNFINISHED tenants only — O(open), never O(every request
        ever served)).  Caller holds the lock; returns None when every
        queued tenant is blocked (the blocking leader is queued or
        running, and its park/finish re-notifies)."""
        for i, t in enumerate(self._runq):
            open_ = self._family_open.get(t.family)
            if open_ is None or min(open_) >= t.seq:
                del self._runq[i]
                # mark running UNDER THE LOCK: a shutdown(wait=False)
                # racing the gap between pick and slice start must see
                # this tenant as preemptable, not miss it entirely
                t.status = "running"
                return t
        return None

    def _executor_loop(self):
        while True:
            with self._cv:
                while True:
                    if not self._runq and self._stop:
                        return             # stopped and drained
                    tenant = self._pick_next() if self._runq else None
                    if tenant is not None:
                        break
                    self._cv.wait()
            try:
                if self._batch_viable(tenant):
                    self._run_batch(tenant)
                else:
                    self._run_slice(tenant)
            except Exception as e:         # a tenant failure never kills
                _CTR_FAILED.inc(1)         # the server
                _log.warning("request %s failed: %r", tenant.id, e)
                tenant.status = "failed"
                tenant.record.update(status="failed",
                                     error_code="exception",
                                     error=repr(e))
                tenant.canonical = None    # release the batched arrays
                self._journal_safe(tenant.id, "failed", tenant.record)
                with self._cv:
                    self._close_tenant_locked(tenant)
                self.progress.emit(tenant.id, "failed", status="failed",
                                   error=repr(e))
                self.progress.mark_done(tenant.id)
                tenant.done.set()

    def _want_preempt(self, tenant, slice_start) -> bool:
        # an expired deadline parks UNCONDITIONALLY — the checkpoint
        # seam is where a doomed request exits cleanly (state banked,
        # bounds harvested) instead of burning quantum forever
        if tenant.past_deadline():
            return True
        with self._cv:
            if tenant.id in self._force_preempt:
                self._force_preempt.discard(tenant.id)
                return True
            # preempt only for a tenant that could actually RUN: a
            # queued same-family follower is blocked behind this very
            # tenant (family affinity), and parking for it would churn
            if not any(o.family != tenant.family or o.seq < tenant.seq
                       for o in self._runq):
                return False
        return time.monotonic() - slice_start >= self.quantum_secs

    def _finish_deadline(self, t: _Tenant):
        """Fail a request whose ``deadline_secs`` expired: UNCERTIFIED
        by construction, checkpoint (if any) left banked on disk, the
        record says exactly what happened.  The park already harvested
        bounds, so the record still carries the best-known gap."""
        _CTR_DEADLINE.inc(1)
        _CTR_FAILED.inc(1)
        t.status = "failed"
        t.record.update(
            status="failed", error_code="deadline",
            error=f"deadline_secs={t.req.deadline_secs} exceeded "
                  f"(parked at iter {t.record['iters']})",
            certified=False,
            wall_s=time.monotonic() - t.submitted)
        t.canonical = None
        t.opt_options = None
        t.creator = None
        self._journal_safe(t.id, "failed", t.record)
        with self._cv:
            self._close_tenant_locked(t)
        _log.warning("request %s failed its deadline (gap %s after %d "
                     "iter(s), %d slice(s))", t.id, t.record["rel_gap"],
                     t.record["iters"], t.slices)
        _telemetry.tenant_instant(t.id, t.trace, "deadline_failed",
                                  iters=t.record["iters"],
                                  rel_gap=t.record["rel_gap"])
        self.progress.emit(t.id, "deadline", status="failed",
                           iters=t.record["iters"],
                           rel_gap=t.record["rel_gap"])
        self.progress.mark_done(t.id)
        t.done.set()

    def _tenant_in_wheel(self, t: _Tenant) -> bool:
        """Whether this tenant's slices run the SELF-CERTIFYING wheel —
        resolved into ``opt_options`` at ingest (request option wins over
        the server default) so the family key keyed the same value."""
        return bool((t.opt_options or {}).get("in_wheel_bounds"))

    def _in_wheel_viable(self, t: _Tenant) -> bool:
        """Whether a spoke-LESS slice can certify: the fused bound pass runs
        only in megastep windows, so a refresh cadence too short for a
        window keeps the bound spokes.  A family with second-stage integer
        columns certifies spoke-less only through the integer escalation's
        MIP leg (a homogeneous batch with the escalation, the host rescue
        and the integer sweep armed); without it the spokes stay.  (The
        reference also keeps spokes for shapes in its TPU segmentation
        regime; the card's window has no such limit,
        :func:`..solvers.segmented.megastep_cap`.)"""
        if int(t.opt_options.get("solver_refresh_every", 16) or 0) <= 2:
            return False
        b = t.canonical.batch
        subs = ([sub for _, sub in b.buckets]
                if hasattr(b, "buckets") else [b])
        for sub in subs:
            free = np.ones(sub.num_vars, dtype=bool)
            free[sub.tree.nonant_indices] = False
            if np.asarray(sub.is_int, bool)[free].any():
                return bool(
                    not hasattr(b, "buckets")
                    and t.opt_options.get("integer_escalation", True)
                    and t.opt_options.get("in_wheel_host_rescue", True)
                    and t.opt_options.get("in_wheel_int_sweep", True))
        return True

    def _batch_viable(self, t: _Tenant) -> bool:
        """Whether this tenant may run inside a fused tenant batch
        (doc/serving.md "Continuous batching").  The batched runner is
        the SELF-CERTIFYING wheel generalized over a tenant axis, so the
        gate is the in-wheel gate plus the batch-specific exclusions:
        homogeneous batches only (the tenant kernel carries one shape
        per slot, not a bucket tuple), and no integer nonants (the
        batched integer sweep's global-argmin semantics have no
        per-tenant masked form — integer families keep time-slicing).
        """
        from ..ir import BucketedBatch

        if self.batch_slots is None or t.canonical is None:
            return False
        b = t.canonical.batch
        if isinstance(b, BucketedBatch):
            return False
        if np.asarray(b.is_int, bool).any():
            return False
        return self._tenant_in_wheel(t) and self._in_wheel_viable(t)

    def _build_wheel(self, t: _Tenant, preempt_check, on_iter0_done):
        """Hub/spoke dicts for one slice of one tenant — the standard
        certified-wheel topology (PH hub + Lagrangian outer + XhatShuffle
        inner), every cylinder binding the SAME canonical model.

        In-wheel mode (:meth:`_tenant_in_wheel`): the hub's megastep
        windows certify via the fused bound pass and the slice spawns NO
        spoke threads — per-request device footprint shrinks to one
        cylinder's programs (doc/pipeline.md "In-wheel certification").
        """
        from ..cylinders import (LagrangianOuterBound, PHHub,
                                 XhatShuffleInnerBound)
        from ..opt.ph import PH
        from ..phbase import PHBase
        from ..xhat_eval import Xhat_Eval

        in_wheel = self._tenant_in_wheel(t)
        if in_wheel and not self._in_wheel_viable(t):
            # keep the bound spokes: a spoke-less slice of this family
            # could never certify (no megastep -> no fused bound pass)
            if not getattr(t, "_in_wheel_declined", False):
                t._in_wheel_declined = True
                _log.warning(
                    "request %s: in_wheel_bounds requested but the "
                    "family cannot certify spoke-less (refresh window / "
                    "integer recourse) — keeping bound spokes", t.id)
            in_wheel = False

        def opt_kwargs(role, extra=None):
            options = dict(t.opt_options, canonical_model=t.canonical,
                           device_owner=self._owner(t.family, role))
            options.update(extra or {})
            return {
                "options": options,
                "all_scenario_names": list(t.names),
                "scenario_creator": t.creator,
                "scenario_creator_kwargs": dict(t.req.creator_kwargs),
            }

        hub_options = {
            "rel_gap": float(t.req.options.get("rel_gap", self.rel_gap)),
            "linger_secs": float(t.req.options.get("linger_secs",
                                                   self.linger_secs)),
            "preempt_check": preempt_check,
            # live per-window progress (doc/observability.md): the hub
            # calls this on every gap computation; the server dedupes
            # and feeds the request's progress stream + trace series
            "progress_cb": self._progress_cb(t),
            "checkpoint_dir": t.dir,
            # mid-slice cadence on top of the terminal park capture: a
            # server CRASH (not just a park) loses at most this much of
            # a running tenant's work (doc/serving.md "Durability")
            "checkpoint_every_secs": self.checkpoint_every_secs,
            "resume": t.dir if t.slices else None,
        }
        if "abs_gap" in t.req.options:
            hub_options["abs_gap"] = float(t.req.options["abs_gap"])
        hub_dict = {
            "hub_class": PHHub,
            "hub_kwargs": {"options": hub_options},
            "opt_class": PH,
            "opt_kwargs": opt_kwargs("hub",
                                     {"on_iter0_done": on_iter0_done}),
        }
        if in_wheel:
            return hub_dict, []
        spokes = [
            {"spoke_class": LagrangianOuterBound, "spoke_kwargs": {},
             "opt_class": PHBase, "opt_kwargs": opt_kwargs("lagrangian")},
            {"spoke_class": XhatShuffleInnerBound, "spoke_kwargs": {},
             "opt_class": Xhat_Eval, "opt_kwargs": opt_kwargs("xhat")},
        ]
        return hub_dict, spokes

    def _progress_cb(self, t: _Tenant):
        """Per-window progress hook for a SOLO slice's hub: dedupe the
        compute_gaps call stream (the hub computes gaps more than once
        per iteration) into the request's bounded progress queue — one
        ``gap`` point per new iteration, one ``bound_update`` per actual
        bound improvement — and mirror the same samples onto the
        request's trace track (source char '*': the hub's own typed
        updates)."""
        state = {"iter": -1, "outer": None, "inner": None}
        bus = self.progress

        def cb(abs_gap, rel_gap, outer, inner, iteration):
            improved = (outer, inner) != (state["outer"],
                                          state["inner"])
            fresh = iteration != state["iter"]
            if not (improved or fresh):
                return
            state.update(iter=iteration, outer=outer, inner=inner)
            if improved:
                bus.emit(t.id, "bound_update", source="*",
                         outer=float(outer), inner=float(inner),
                         iteration=int(iteration))
                if np.isfinite(outer):
                    _telemetry.tenant_counter(t.id, t.trace,
                                              "best_outer", outer)
                if np.isfinite(inner):
                    _telemetry.tenant_counter(t.id, t.trace,
                                              "best_inner", inner)
            if np.isfinite(rel_gap):
                bus.emit(t.id, "gap", iteration=int(iteration),
                         rel_gap=float(rel_gap),
                         abs_gap=float(abs_gap), source="*")
                _telemetry.tenant_counter(t.id, t.trace, "rel_gap",
                                          rel_gap)
                _telemetry.tenant_counter(t.id, t.trace, "abs_gap",
                                          abs_gap)
        return cb

    def _run_slice(self, t: _Tenant):
        from ..spin_the_wheel import WheelSpinner

        if t.past_deadline():
            # expired while queued/parked: fail WITHOUT burning a slice
            self._finish_deadline(t)
            return
        t.status = "running"
        t.record["status"] = "running"
        self._journal_safe(t.id, "running", t.record)
        self.progress.emit(t.id, "running", status="running",
                           slice=t.slices + 1)
        if t.first_exec is None:
            t.first_exec = time.monotonic()
            if t.record["queue_wait_s"] is None:
                # recovered tenants that already executed in a previous
                # lifetime keep their journaled queue wait — the restart
                # gap is recovery latency, not queueing, and summing the
                # two would double-count the metric across a recovery
                t.record["queue_wait_s"] = t.first_exec - t.submitted
                _HIST_QUEUE_WAIT.add(t.record["queue_wait_s"])
            # warm verdict at first execution: true only when a member
            # of this family actually COMPLETED (its programs exist);
            # family affinity made any earlier leader finish (or fail)
            # before this point.  None = never evaluated (a recovered
            # tenant keeps its first lifetime's verdict)
            if t.record["warm_hit"] is None:
                with self._cv:
                    warm = t.family in self._families_done
                t.record["warm_hit"] = warm
                (_CTR_WARM_HITS if warm else _CTR_COLD_FAMILIES).inc(1)
                _log.info("request %s starts %s", t.id,
                          "WARM" if warm else "cold")
        slice_start = time.monotonic()

        def on_iter0_done():
            if t.record["ttfi_s"] is None:
                t.record["ttfi_s"] = time.monotonic() - slice_start
                _HIST_TTFI.add(t.record["ttfi_s"])

        hub_dict, spokes = self._build_wheel(
            t, lambda: self._want_preempt(t, slice_start), on_iter0_done)
        _CTR_SLICES.inc(1)
        # the executor is the ONLY thread doing device work, so registry
        # window deltas here are this slice's traffic (the wheel's own
        # cylinder threads are part of the slice)
        with _metrics.window() as w, \
                _telemetry.request_scope(t.trace, t.id), \
                _telemetry.tenant_span(t.id, t.trace, "slice",
                                       slice=t.slices + 1):
            ws = WheelSpinner(hub_dict, spokes).run()
        t.slices += 1
        if _faults.active():
            # deterministic serving chaos: the wheel tore down (terminal
            # checkpoint banked) but the transition below has NOT been
            # journaled — the kill lands in exactly the window restart
            # recovery must close (kill_server_after_slices)
            _faults.on_server_slice(t.slices)
        wall = time.monotonic() - slice_start
        hub = ws.spcomm
        rec = t.record
        rec["slices"] = t.slices
        rec["exec_s"] += wall
        for key, names in _WARM_KEYS:
            rec[key] += sum(w.delta(nm) for nm in names)
        # bounds must be monotone across every park/resume cycle (the
        # seed_resume contract) — a violation is a correctness bug the
        # SLO record surfaces loudly
        ob, ib = float(hub.BestOuterBound), float(hub.BestInnerBound)
        tol = 1e-9 * max(1.0, abs(t.last_outer) if
                         np.isfinite(t.last_outer) else 1.0)
        if ob < t.last_outer - tol or ib > t.last_inner + tol:
            rec["bounds_monotone"] = False
            _log.warning("request %s: bounds regressed across resume "
                         "(outer %s -> %s, inner %s -> %s)", t.id,
                         t.last_outer, ob, t.last_inner, ib)
        t.last_outer = max(t.last_outer, ob)
        t.last_inner = min(t.last_inner, ib)
        rec["outer"], rec["inner"] = ob, ib
        rec["iters"] = int(hub.current_iteration())
        if rec["exec_s"] > 0:
            rec["iters_per_sec"] = rec["iters"] / rec["exec_s"]
        abs_gap, rel_gap = hub.compute_gaps()
        rec["rel_gap"] = float(rel_gap)

        iter_limit = int(t.opt_options.get("PHIterLimit", 200))
        if getattr(hub, "preempted", False) and rec["iters"] < iter_limit:
            if t.past_deadline():
                # the park banked the checkpoint + harvested bounds;
                # the request exits FAILED-UNCERTIFIED instead of
                # re-queueing for quantum it can never certify within
                rec["preemptions"] += 1
                self._finish_deadline(t)
                return
            t.status = "parked"
            rec["status"] = "parked"
            rec["preemptions"] += 1
            self._journal_safe(t.id, "parked", rec)
            _telemetry.tenant_instant(t.id, t.trace, "parked",
                                      iters=rec["iters"])
            self.progress.emit(t.id, "parked", status="parked",
                               iters=rec["iters"],
                               rel_gap=rec["rel_gap"])
            with self._cv:
                if self._stop and not self._drain:
                    # shutdown(wait=False): the park WAS the drain — the
                    # tenant stays parked on disk (resumable by a later
                    # server over this work_dir), and waiters unblock on
                    # the parked record instead of timing out
                    self._close_tenant_locked(t)
                    self.progress.mark_done(t.id)
                    t.done.set()
                    _log.info("request %s left PARKED by shutdown "
                              "(checkpoint banked at iter %d)", t.id,
                              rec["iters"])
                    return
                self._runq.append(t)       # round-robin: back of the line
                self._cv.notify_all()
            _log.info("request %s parked at iter %d (slice %d, %.2fs)",
                      t.id, rec["iters"], t.slices, wall)
            return
        # completion — including a preempt that found the ITERATION
        # BUDGET already spent: a budget-exhausted wheel can only linger,
        # and re-parking it would let two never-certifying tenants of
        # different families alternate {Iter0, quantum of linger, park}
        # forever (each resume restarting the linger clock) — it
        # completes UNCERTIFIED instead, and the record says so
        t.status = "done"
        rec["status"] = "done"
        rec["wall_s"] = time.monotonic() - t.submitted
        rec["certified"] = bool(np.isfinite(rel_gap) and rel_gap <= float(
            t.req.options.get("rel_gap", self.rel_gap)) + 1e-12)
        _HIST_WALL.add(rec["wall_s"])
        _CTR_COMPLETED.inc(1)
        self._journal_safe(t.id, "done", rec)
        with self._cv:
            self._families_done.add(t.family)
            self._close_tenant_locked(t)
        t.canonical = None      # release the batched arrays: a long-lived
        t.opt_options = None    # server must not retain every request's
        t.creator = None        # coefficient tensors (records stay)
        _log.info("request %s done: gap %.3e in %.2fs (%d slice(s), "
                  "%d captures)", t.id, rel_gap, rec["wall_s"], t.slices,
                  int(rec["aot_misses"]))
        _telemetry.tenant_instant(t.id, t.trace, "complete",
                                  certified=rec["certified"],
                                  iters=rec["iters"])
        if rec["rel_gap"] is not None and np.isfinite(rec["rel_gap"]):
            # the live gap series ends AT the certified gap: the final
            # certification can tighten past the last in-iteration point
            self.progress.emit(t.id, "gap", source="C",
                               rel_gap=rec["rel_gap"],
                               outer=rec["outer"], inner=rec["inner"],
                               iteration=rec["iters"])
        self.progress.emit(t.id, "done", status="done",
                           certified=rec["certified"],
                           rel_gap=rec["rel_gap"], outer=rec["outer"],
                           inner=rec["inner"], iters=rec["iters"])
        self.progress.mark_done(t.id)
        t.done.set()

    # ---- continuous batching ------------------------------------------------
    def _run_batch(self, leader):
        """One BATCHED slice: fuse up to ``batch_slots`` same-family
        tenants into one tenant-batched megastep wheel (doc/serving.md
        "Continuous batching").

        The leader constructs the
        :class:`~tpusppy.service.batching.BatchedFamilyRunner`; queued
        same-family tenants JOIN free slots at window boundaries in QoS
        order, a finishing/expiring tenant EVICTS only its own slot
        (banked through the checkpoint seam), and the freed slot
        backfills from the queue.  Each window report carries the
        tenant's live-row-fraction share of the shared dispatch, so SLO
        records stay comparable with the time-sliced path.  The batch
        as a whole is ONE device occupant: a waiting DIFFERENT-family
        tenant preempts it at the quantum exactly like a solo slice,
        parking every member.
        """
        from .batching import BatchedFamilyRunner, qos_rank

        if leader.past_deadline():
            self._finish_deadline(leader)
            return

        def mark_running(t, joiner):
            t.status = "running"
            t.record["status"] = "running"
            self._journal_safe(t.id, "running", t.record)
            if t.first_exec is None:
                t.first_exec = time.monotonic()
                if t.record["queue_wait_s"] is None:
                    t.record["queue_wait_s"] = t.first_exec - t.submitted
                    _HIST_QUEUE_WAIT.add(t.record["queue_wait_s"])
                if t.record["warm_hit"] is None:
                    if joiner:
                        # a joiner binds the batch's ALREADY-CAPTURED
                        # programs — warm by construction, so the
                        # follower contract (zero captures) holds even
                        # before any family member COMPLETES
                        warm = True
                    else:
                        with self._cv:
                            warm = t.family in self._families_done
                    t.record["warm_hit"] = warm
                    (_CTR_WARM_HITS if warm else _CTR_COLD_FAMILIES).inc(1)
                    _log.info("request %s starts %s (batched)", t.id,
                              "WARM" if warm else "cold")

        mark_running(leader, joiner=False)
        # K: the server's slot count (the reference clamps it by a banked
        # "batched" autotuner verdict; the port has no verdict store)
        k = int(self.batch_slots)

        members: dict = {}
        slice_start = time.monotonic()

        def fail(t, e):
            _CTR_FAILED.inc(1)
            _log.warning("request %s failed: %r", t.id, e)
            t.status = "failed"
            t.record.update(status="failed", error_code="exception",
                            error=repr(e))
            t.canonical = None
            self._journal_safe(t.id, "failed", t.record)
            with self._cv:
                self._close_tenant_locked(t)
            self.progress.emit(t.id, "failed", status="failed",
                               error=repr(e))
            self.progress.mark_done(t.id)
            t.done.set()

        def admit(t, joiner):
            if t.past_deadline():
                # expired while queued/parked: fail WITHOUT a slot
                self._finish_deadline(t)
                return False
            if joiner:
                mark_running(t, joiner=True)
            try:
                info = runner.admit(
                    t.id, t.canonical, t.dir,
                    int(t.opt_options.get("PHIterLimit", 200)),
                    resume=t.slices > 0,
                    best_inner=t.last_inner, best_outer=t.last_outer,
                    trace_id=t.trace)
            except Exception as e:
                fail(t, e)
                return False
            bill(t.record, info["metered"])
            self.progress.emit(t.id, "running", status="running",
                               batched=True, joiner=bool(joiner),
                               resumed=bool(info["resumed"]),
                               slice=t.slices + 1)
            t.slices += 1
            t.record["slices"] = t.slices
            t.record["batched"] = True
            _CTR_SLICES.inc(1)
            if info["resumed"]:
                t.record["iters"] = int(info["iteration"])
            if t.record["ttfi_s"] is None:
                # admit ran Iter0 (or the resume seed) synchronously
                t.record["ttfi_s"] = time.monotonic() - t.first_exec
                _HIST_TTFI.add(t.record["ttfi_s"])
            members[t.id] = t
            return True

        def pull_joiners():
            free = runner.free_slots()
            if free <= 0:
                return []
            with self._cv:
                cand = [t2 for t2 in self._runq
                        if t2.family == leader.family
                        and self._batch_viable(t2)]
                # QoS decides who takes a free slot (the PR-12 debt);
                # ties break on submission order so same-class requests
                # keep FIFO semantics
                cand.sort(key=lambda t2: (qos_rank(t2.req.qos), t2.seq))
                take = cand[:free]
                for t2 in take:
                    self._runq.remove(t2)
                    t2.status = "running"
            return take

        def park(t, stopping):
            t.record["iters"] = int(runner.evict(t.id, bank=True))
            t.record["preemptions"] += 1
            members.pop(t.id, None)
            t.status = "parked"
            t.record["status"] = "parked"
            self._journal_safe(t.id, "parked", t.record)
            self.progress.emit(t.id, "parked", status="parked",
                               batched=True, iters=t.record["iters"],
                               rel_gap=t.record["rel_gap"])
            if stopping:
                # shutdown(wait=False): the evict WAS the drain — the
                # tenant stays parked on disk, waiters unblock now
                with self._cv:
                    self._close_tenant_locked(t)
                self.progress.mark_done(t.id)
                t.done.set()
                _log.info("request %s left PARKED by shutdown "
                          "(checkpoint banked at iter %d)", t.id,
                          t.record["iters"])
            else:
                with self._cv:
                    self._runq.append(t)
                    self._cv.notify_all()
                _log.info("request %s parked at iter %d (batched, "
                          "slice %d)", t.id, t.record["iters"], t.slices)

        def finish_deadline_slot(t):
            # a deadline crossing evicts ONLY this tenant's slot at the
            # window boundary (state banked, bounds harvested) — it
            # never parks the rest of the batch
            t.record["iters"] = int(runner.evict(t.id, bank=True))
            t.record["preemptions"] += 1
            members.pop(t.id, None)
            self._finish_deadline(t)

        def complete(t, certified):
            runner.complete(t.id)
            members.pop(t.id, None)
            rec = t.record
            t.status = "done"
            rec["status"] = "done"
            rec["wall_s"] = time.monotonic() - t.submitted
            rec["certified"] = bool(certified)
            _HIST_WALL.add(rec["wall_s"])
            _CTR_COMPLETED.inc(1)
            self._journal_safe(t.id, "done", rec)
            with self._cv:
                self._families_done.add(t.family)
                self._close_tenant_locked(t)
                self._cv.notify_all()
            t.canonical = None
            t.opt_options = None
            t.creator = None
            _log.info("request %s done (batched): gap %s in %.2fs "
                      "(%d slice(s))", t.id, rec["rel_gap"],
                      rec["wall_s"], t.slices)
            _telemetry.tenant_instant(t.id, t.trace, "complete",
                                      certified=rec["certified"],
                                      iters=rec["iters"], batched=True)
            if (rec["rel_gap"] is not None
                    and np.isfinite(rec["rel_gap"])):
                self.progress.emit(t.id, "gap", source="C",
                                   rel_gap=rec["rel_gap"],
                                   outer=rec["outer"],
                                   inner=rec["inner"],
                                   iteration=rec["iters"])
            self.progress.emit(t.id, "done", status="done",
                               certified=rec["certified"],
                               rel_gap=rec["rel_gap"],
                               outer=rec["outer"], inner=rec["inner"],
                               iters=rec["iters"], batched=True)
            self.progress.mark_done(t.id)
            t.done.set()

        with _metrics.window() as w:
            try:
                runner = BatchedFamilyRunner(
                    leader.canonical, leader.opt_options, k,
                    owner=self._owner(leader.family, f"batch{k}"))
            except Exception as e:
                _log.warning("request %s: batched runner unavailable "
                             "(%r) — time-slicing instead", leader.id, e)
                self._run_slice(leader)
                return

            # captures, replays and build seconds are billed to the member
            # whose admission, refresh or slot window ran them (the
            # runner meters each); what no member's metering holds goes
            # to the leader.  Incremental against the window snapshot so
            # repeated flushes never double-count
            attr = {key: 0.0 for key, _ in _WARM_KEYS}

            def bill(rec, metered):
                for key, names in _WARM_KEYS:
                    d = sum(metered[nm] for nm in names)
                    if d:
                        rec[key] += d
                        attr[key] += d

            def flush_compile(rec):
                for key, names in _WARM_KEYS:
                    d = sum(w.delta(nm) for nm in names) - attr[key]
                    if d:
                        rec[key] += d
                        attr[key] += d

            if not admit(leader, joiner=False):
                return
            for t2 in pull_joiners():
                admit(t2, joiner=True)

            last_bank = time.monotonic()
            while members:
                # live batch occupancy for the scrape endpoint / status
                # RPC (read under self._cv by status_snapshot)
                with self._cv:
                    self._batch_live = {"k": k,
                                        "occupied": len(members)}
                # (a) deadline crossings — per-slot evictions only
                for t in [t for t in members.values()
                          if t.past_deadline()]:
                    finish_deadline_slot(t)
                # (b) forced preemption / shutdown
                with self._cv:
                    stopping = self._stop and not self._drain
                    forced = set(members) & self._force_preempt
                    self._force_preempt -= forced
                if stopping:
                    for t in list(members.values()):
                        park(t, stopping=True)
                    break
                for rid in forced:
                    park(members[rid], stopping=False)
                # (c) cross-family quantum preemption: the batch is one
                # device occupant — same-family waiters JOIN instead
                if (members
                        and time.monotonic() - slice_start
                        >= self.quantum_secs):
                    with self._cv:
                        other = any(o.family != leader.family
                                    for o in self._runq)
                    if other:
                        for t in list(members.values()):
                            park(t, stopping=False)
                        break
                # (d) backfill freed slots from the queue
                for t2 in pull_joiners():
                    admit(t2, joiner=True)
                if not members:
                    break
                # (e) ONE fused window over every live slot
                reports = runner.window()
                # (f) mid-run durability cadence (solo parity: a server
                # crash costs each member at most this much work)
                now = time.monotonic()
                if now - last_bank >= self.checkpoint_every_secs:
                    last_bank = now
                    for rid in list(members):
                        try:
                            runner.bank(rid)
                        except Exception as e:
                            _log.warning("mid-run bank failed for %s: "
                                         "%r", rid, e)
                for rid, rep in reports.items():
                    t = members.get(rid)
                    if t is None:
                        continue
                    rec = t.record
                    bill(rec, rep["metered"])
                    rec["iters"] = int(rep["iters"])
                    rec["exec_s"] += rep["wall_s"]
                    rec["attributed_flops"] += rep["flops"]
                    if rec["exec_s"] > 0:
                        rec["iters_per_sec"] = (rec["iters"]
                                                / rec["exec_s"])
                    ob, ib = float(rep["outer"]), float(rep["inner"])
                    prev_outer, prev_inner = t.last_outer, t.last_inner
                    tol = 1e-9 * max(1.0, abs(t.last_outer) if
                                     np.isfinite(t.last_outer) else 1.0)
                    if ob < t.last_outer - tol or ib > t.last_inner + tol:
                        rec["bounds_monotone"] = False
                        _log.warning(
                            "request %s: bounds regressed across resume "
                            "(outer %s -> %s, inner %s -> %s)", t.id,
                            t.last_outer, ob, t.last_inner, ib)
                    t.last_outer = max(t.last_outer, ob)
                    t.last_inner = min(t.last_inner, ib)
                    rec["outer"], rec["inner"] = ob, ib
                    rec["rel_gap"] = float(rep["rel_gap"])
                    # per-window progress stream: one gap point per
                    # window, one bound_update per actual improvement
                    # (source 'B': the fused batched dispatch)
                    if t.last_outer > prev_outer or \
                            t.last_inner < prev_inner:
                        self.progress.emit(
                            rid, "bound_update", source="B",
                            outer=ob, inner=ib, iteration=rec["iters"])
                    if np.isfinite(rep["rel_gap"]):
                        self.progress.emit(
                            rid, "gap", source="B",
                            iteration=rec["iters"],
                            rel_gap=float(rep["rel_gap"]),
                            abs_gap=float(rep["abs_gap"]))
                    target = float(t.req.options.get("rel_gap",
                                                     self.rel_gap))
                    hit = (np.isfinite(rep["rel_gap"])
                           and rep["rel_gap"] <= target + 1e-12)
                    if not hit and "abs_gap" in t.req.options:
                        hit = (np.isfinite(rep["abs_gap"])
                               and rep["abs_gap"] <= float(
                                   t.req.options["abs_gap"]) + 1e-12)
                    if hit or rep["exhausted"]:
                        # budget exhaustion completes UNCERTIFIED, like
                        # the solo path — re-parking a spent wheel
                        # would churn forever
                        complete(t, certified=hit)
                flush_compile(leader.record)
            flush_compile(leader.record)
        with self._cv:
            self._batch_live = {}
