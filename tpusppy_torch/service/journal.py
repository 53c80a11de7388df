"""Write-ahead request journal: the solve server's durability spine.

A copy of ``tpusppy/service/journal.py`` (the file format is the
reference's: a journal either package writes replays in the other).

Every request the server ACCEPTS is journaled — id, submission order,
the original request payload, shape-family digest, checkpoint-dir
pointer — *before* ``submit`` returns, and every status transition
(queued → running → parked → done/failed/cancelled) appends a record
snapshot.  The journal is what makes a :class:`~.server.SolveServer`
crash-safe (doc/serving.md "Durability"): a SIGKILLed server loses its
process state but not its obligations — a restarted server over the same
``work_dir`` replays the journal and re-admits every unfinished tenant
(parked tenants resume from their banked checkpoints, queued tenants
re-enter the queue in submission order), while finished tenants' records
stay fetchable by request id across the restart.

File format: append-only JSONL (one event object per line) so an append
is a single ``write`` + ``fsync`` — the atomic-rename discipline of
:func:`..resilience.checkpoint.atomic_write_json` is reserved for
COMPACTION, which rewrites the whole file (tempfile in the same dir,
fsync, ``os.replace``).  A kill mid-append can tear at most the final
line; :func:`replay` detects and skips a torn tail (counted into
``service.journal_torn``), so the journal is never unreadable.

Event kinds::

    {"ev": "accepted", "rid", "seq", "request", "family",
     "checkpoint_dir", "recoverable", "deadline_at", "record", "t"}
    {"ev": "status", "rid", "status", "record"?, "t"}
    {"ev": "undelivered", "rid", "payload", "t"}   # a response the TCP
                                                   # frontend failed to
                                                   # deliver (client can
                                                   # re-fetch by id)
    {"ev": "recovery", "info", "t"}                # lifetime boundary

``record`` snapshots are the server's SLO-record dicts verbatim, so a
recovered tenant re-seeds its bookkeeping (queue_wait, ttfi, bounds,
preemption counts) from the journal instead of double-counting them in
the new lifetime.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import tempfile
import threading
import time

from ..obs import metrics as _metrics
from ..obs.log import get_logger

_log = get_logger("service.journal")

_CTR_WRITES = _metrics.counter("service.journal_writes")
_CTR_COMPACTIONS = _metrics.counter("service.journal_compactions")
_CTR_TORN = _metrics.counter("service.journal_torn")

#: Terminal statuses — records in these states are compaction candidates.
FINISHED = ("done", "failed", "cancelled")


@dataclasses.dataclass
class JournalRecord:
    """Folded state of one journaled request (the replay product)."""

    rid: str
    seq: int = 0
    request: dict = dataclasses.field(default_factory=dict)
    trace_id: str = ""                # distributed-trace id (first-class:
    family: str = ""                  # survives compaction + SIGKILL)
    checkpoint_dir: str = ""
    recoverable: bool = True
    deadline_at: float | None = None  # absolute epoch seconds (or None)
    status: str = "queued"
    record: dict = dataclasses.field(default_factory=dict)
    accepted_at: float = 0.0
    undelivered: dict | None = None   # last response that failed delivery

    @property
    def finished(self) -> bool:
        return self.status in FINISHED


class RequestJournal:
    """Append-only JSONL journal with tolerant replay and atomic
    compaction.  Thread-safe: appends serialize on an internal lock (the
    server calls from both the submit path and the executor)."""

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()
        self._fold_cache = None        # (mtime_ns, size, fold) — see
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)  # replay_cached()

    # ---- append side ------------------------------------------------------
    def _append(self, event: dict):
        line = json.dumps(event) + "\n"
        with self._lock:
            with open(self.path, "a") as f:
                f.write(line)
                f.flush()
                os.fsync(f.fileno())
        _CTR_WRITES.inc(1)

    def accepted(self, rid: str, seq: int, request: dict, family: str,
                 checkpoint_dir: str, recoverable: bool = True,
                 deadline_at: float | None = None, record: dict | None = None,
                 trace_id: str | None = None):
        """Journal an accepted request.  MUST run before ``submit``
        returns — the write-ahead property the recovery path relies on.
        ``trace_id`` is journaled first-class so a SIGKILLed request's
        distributed trace survives into the recovered lifetime."""
        self._append({"ev": "accepted", "rid": str(rid), "seq": int(seq),
                      "request": dict(request or {}), "family": str(family),
                      "checkpoint_dir": str(checkpoint_dir),
                      "recoverable": bool(recoverable),
                      "deadline_at": deadline_at,
                      "trace_id": str(trace_id or ""),
                      "record": dict(record or {}), "t": time.time()})

    def transition(self, rid: str, status: str, record: dict | None = None):
        ev = {"ev": "status", "rid": str(rid), "status": str(status),
              "t": time.time()}
        if record is not None:
            ev["record"] = dict(record)
        self._append(ev)

    def undelivered(self, rid: str, payload: dict):
        """Bank a response the transport failed to deliver, so a
        reconnecting client can still fetch it by request id."""
        self._append({"ev": "undelivered", "rid": str(rid or ""),
                      "payload": dict(payload or {}), "t": time.time()})

    def recovery_marker(self, info: dict | None = None):
        """Stamp a lifetime boundary (a recovering server writes one
        before re-admitting tenants — post-mortems and the chaos smoke
        read events after the newest marker as 'this lifetime')."""
        self._append({"ev": "recovery", "info": dict(info or {}),
                      "t": time.time()})

    # ---- replay side ------------------------------------------------------
    def replay(self) -> dict:
        return replay(self.path)

    def replay_cached(self) -> dict:
        """Like :meth:`replay`, but the fold is memoized on the file's
        (mtime, size) stat — the fetch-by-id / retired-result lookup
        path must not re-parse the whole journal on every call of a
        polling client."""
        try:
            st = os.stat(self.path)
            key = (st.st_mtime_ns, st.st_size)
        except OSError:
            return {}
        cached = self._fold_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        fold = replay(self.path)
        self._fold_cache = (key, fold)
        return fold

    def exists(self) -> bool:
        return os.path.exists(self.path)

    # ---- compaction -------------------------------------------------------
    def compact_keep(self, keep) -> int:
        """ATOMIC read-filter-rewrite: re-fold the journal and keep the
        records for which ``keep(record)`` is true, all under the append
        lock — an append racing the compaction can never land between
        the read and the ``os.replace`` and be silently erased (that
        would un-write the write-ahead).  Returns the number of records
        kept."""
        with self._lock:
            kept = [r for r in replay(self.path).values() if keep(r)]
            self._rewrite_locked(kept)
        return len(kept)

    def compact(self, records) -> int:
        """Atomically rewrite the journal as the folded state of
        ``records`` (an iterable of :class:`JournalRecord`): one
        ``accepted`` line plus, when the status moved past "queued", one
        ``status`` line per record.  Dropped (retired) records simply
        don't appear.  Returns the number of records written.  NOTE:
        callers filtering a replay they took themselves race concurrent
        appends — prefer :meth:`compact_keep`, which holds the append
        lock across read AND rewrite."""
        records = list(records)
        with self._lock:
            self._rewrite_locked(records)
        return len(records)

    def _rewrite_locked(self, records):
        """Tempfile-fsync-replace rewrite (caller holds ``_lock``)."""
        records = sorted(records, key=lambda r: r.seq)
        lines = []
        for r in records:
            lines.append(json.dumps(
                {"ev": "accepted", "rid": r.rid, "seq": r.seq,
                 "request": r.request, "family": r.family,
                 "checkpoint_dir": r.checkpoint_dir,
                 "recoverable": r.recoverable,
                 "deadline_at": r.deadline_at,
                 "trace_id": r.trace_id,
                 "record": {}, "t": r.accepted_at}))
            if r.status != "queued" or r.record:
                lines.append(json.dumps(
                    {"ev": "status", "rid": r.rid, "status": r.status,
                     "record": r.record, "t": time.time()}))
            if r.undelivered is not None:
                lines.append(json.dumps(
                    {"ev": "undelivered", "rid": r.rid,
                     "payload": r.undelivered, "t": time.time()}))
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=".journal_tmp_",
                                   suffix=".jsonl", dir=d)
        try:
            with os.fdopen(fd, "w") as f:
                f.write("".join(ln + "\n" for ln in lines))
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            with contextlib.suppress(OSError):
                os.remove(tmp)
            raise
        _CTR_COMPACTIONS.inc(1)
        return len(records)


def replay(path: str) -> dict:
    """Fold a journal file into ``{rid: JournalRecord}``.  Missing file
    => empty dict.  Unparseable lines are skipped (a kill mid-append can
    tear the FINAL line — anything else unparseable is logged loudly and
    still skipped: replaying the readable majority beats refusing to
    recover anything)."""
    out: dict = {}
    if not os.path.exists(path):
        return out
    with open(path) as f:
        raw = f.read()
    lines = raw.split("\n")
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            ev = json.loads(line)
        except ValueError:
            _CTR_TORN.inc(1)
            if i < len(lines) - 2:      # not the (possibly torn) tail
                _log.warning("journal %s: unparseable line %d skipped",
                             path, i + 1)
            continue
        kind = ev.get("ev")
        rid = str(ev.get("rid", ""))
        if kind == "accepted":
            req = dict(ev.get("request") or {})
            out[rid] = JournalRecord(
                rid=rid, seq=int(ev.get("seq", 0)),
                request=req,
                # pre-telemetry journals carry no trace_id line-level
                # key; the request payload is the fallback carrier
                trace_id=str(ev.get("trace_id")
                             or req.get("trace_id") or ""),
                family=str(ev.get("family", "")),
                checkpoint_dir=str(ev.get("checkpoint_dir", "")),
                recoverable=bool(ev.get("recoverable", True)),
                deadline_at=ev.get("deadline_at"),
                record=dict(ev.get("record") or {}),
                accepted_at=float(ev.get("t", 0.0)))
        elif kind == "status" and rid in out:
            out[rid].status = str(ev.get("status", out[rid].status))
            if ev.get("record") is not None:
                out[rid].record = dict(ev["record"])
        elif kind == "undelivered":
            if rid in out:
                out[rid].undelivered = dict(ev.get("payload") or {})
            elif rid:
                # the frontend also journals undeliverable responses for
                # requests that were never ACCEPTED (overload / shutdown
                # / bad-request rejections have no "accepted" line):
                # bank a finished, non-recoverable stub so fetch-by-id
                # still answers the rejection — and replay can never
                # re-admit it as a runnable obligation
                out[rid] = JournalRecord(
                    rid=rid, recoverable=False, status="failed",
                    undelivered=dict(ev.get("payload") or {}))
        # "recovery" markers and status lines for unknown rids (compacted
        # away) carry no replayable state
    return out
