"""Request-scoped telemetry plane: trace propagation, scrape, streaming.

A copy of ``tpusppy/obs/telemetry.py`` over the port's :mod:`.trace` and
:mod:`.metrics` (its Prometheus text is the reference's, byte for byte, for
the same counters, gauges and histograms).  The flight recorder
(:mod:`.trace`) is process-local and post-hoc; a multi-tenant serving
stack (:mod:`..service`) needs the LIVE plane:

- **Request-scoped distributed tracing** (Dapper idiom): a ``trace_id``
  minted once at :meth:`..service.net.SolveClient.submit`, carried
  in the wire payload, persisted in the request journal (so a recovered
  request keeps its trace across a SIGKILL) and threaded through
  admission, batch slot join/evict/bank/rejoin and every per-window
  bound event.  Each request renders as one contiguous logical track
  (``req:<request_id>``); every event's payload carries
  ``trace_id``/``request_id`` so :mod:`scripts.trace_merge` can stitch
  per-process rings into one multi-process timeline.
- **Clock alignment**: per-process rings are ``perf_counter``-relative.
  :func:`record_clock_sync` stamps a ``(wall, perf)`` pair into the ring
  (one instant on the ``clock`` track); the TCP hello/status exchange
  additionally records an NTP-style :func:`handshake_offset` between the
  client's and server's wall clocks, so ``scripts/trace_merge.py`` can
  place every file on one absolute timeline — including multi-controller
  ``dist_wheel`` meshes.
- **Prometheus text exposition** (:func:`prometheus_text`): the
  always-on metrics registry plus per-tenant gauges rendered in the
  text exposition format, served zero-dependency by
  :class:`ScrapeServer` (stdlib ``http.server``) on the TCP frontend.
- **Progress streaming** (:class:`ProgressBus`): bounded per-request
  event queues the scheduler feeds per window (gap point, bound updates
  with source char, join/evict/deadline verdicts) and the frontend
  drains into ``SolveClient.watch`` long-poll batches.

Everything here preserves the obs contract: the trace-ring paths gate on
:func:`trace.enabled` first (the <5µs disabled-span pin in
the reference's tests/test_obs.py holds with a request context in place), the bus and
the scrape surface are always-on but touched only at window boundaries.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import threading
import time
import uuid

from . import metrics as _metrics
from . import trace as _trace

__all__ = [
    "mint_trace_id", "req_track", "request_scope", "current_context",
    "tenant_instant", "tenant_counter", "tenant_span",
    "clock_stamp", "record_clock_sync", "handshake_offset",
    "record_clock_handshake", "ProgressBus", "prometheus_text",
    "tenant_gauge_lines", "ScrapeServer", "json_safe",
]


# ---------------------------------------------------------------------------
# Request context
# ---------------------------------------------------------------------------
def mint_trace_id() -> str:
    """A fresh trace id — minted ONCE per request at the outermost edge
    (the client's submit; the server mints only when a request arrives
    without one, e.g. in-process submits)."""
    return f"tr-{uuid.uuid4().hex[:16]}"


def req_track(request_id) -> str:
    """The logical trace track one request's events render on — one
    contiguous row per request in the merged timeline."""
    return f"req:{request_id}"


_tls = threading.local()


def push_context(trace_id, request_id):
    stack = getattr(_tls, "req_stack", None)
    if stack is None:
        stack = _tls.req_stack = []
    stack.append((str(trace_id or ""), str(request_id or "")))


def pop_context():
    stack = getattr(_tls, "req_stack", None)
    if stack:
        stack.pop()


def current_context():
    """(trace_id, request_id) of the innermost active request scope on
    this thread, or None.  Kept to a bare TLS list read so the disabled
    trace fast path stays under its 5µs/span pin with scopes active."""
    stack = getattr(_tls, "req_stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def request_scope(trace_id, request_id):
    """Bind the calling thread to one request: :func:`tenant_instant` /
    :func:`tenant_counter` / :func:`tenant_span` called with
    ``request_id=None`` inside the scope resolve to this request."""
    push_context(trace_id, request_id)
    try:
        yield
    finally:
        pop_context()


def _resolve(request_id, trace_id):
    if request_id is None:
        ctx = current_context()
        if ctx is None:
            return None, None
        return ctx[1], ctx[0]
    return str(request_id), str(trace_id or "")


def tenant_instant(request_id, trace_id, name, **payload):
    """Point event on the request's own track, tagged with its trace id
    (the merge key).  No-op (nothing allocated) while tracing is off."""
    if not _trace.enabled():
        return
    rid, tid = _resolve(request_id, trace_id)
    if rid is None:
        return
    _trace.instant(req_track(rid), name,
                   request_id=rid, trace_id=tid, **payload)


def tenant_counter(request_id, trace_id, name, value, **payload):
    """Numeric series sample on the request's track.  The payload
    carries ``request_id`` so :func:`report.build_report` buckets the
    sample into that tenant's gap/bound series (the batched runner's
    source-'B' bounds land here — the hub-only collection missed them).
    """
    if not _trace.enabled():
        return
    rid, tid = _resolve(request_id, trace_id)
    if rid is None:
        return
    _trace.counter(req_track(rid), name, value,
                   request_id=rid, trace_id=tid, **payload)


def tenant_span(request_id, trace_id, name, **payload):
    """Span on the request's track (context-manager).  Disabled: the
    shared no-op singleton, same as :func:`trace.span`."""
    if not _trace.enabled():
        return _trace._NULL
    rid, tid = _resolve(request_id, trace_id)
    if rid is None:
        return _trace._NULL
    return _trace.span(req_track(rid), name,
                       request_id=rid, trace_id=tid, **payload)


# ---------------------------------------------------------------------------
# Clock alignment (trace_merge's input)
# ---------------------------------------------------------------------------
def clock_stamp() -> dict:
    """A ``(wall, perf)`` timestamp pair sampled back to back — the unit
    of clock alignment: ``wall - perf`` maps this process's
    perf_counter-relative ring onto the wall clock."""
    return {"wall": time.time(), "perf": time.perf_counter()}


def record_clock_sync(role: str, **extra):
    """Stamp this process's ring with a ``clock_sync`` instant (track
    ``clock``) carrying the pair :func:`clock_stamp` plus the process
    id.  ``scripts/trace_merge.py`` reads the FIRST such instant per
    file to place the file on the absolute wall timeline."""
    if not _trace.enabled():
        return
    st = clock_stamp()
    _trace.instant("clock", "clock_sync", role=str(role),
                   wall=st["wall"], perf=st["perf"], pid=os.getpid(),
                   **extra)


def handshake_offset(send_wall: float, recv_wall: float,
                     server_wall: float) -> float:
    """NTP-style wall-clock offset estimate from one request/response
    exchange: the server stamped ``server_wall`` somewhere inside the
    client's ``[send_wall, recv_wall]`` window, so
    ``server_wall - midpoint`` estimates (server - client) with error
    bounded by half the round trip."""
    return float(server_wall) - 0.5 * (float(send_wall)
                                       + float(recv_wall))


def record_clock_handshake(role: str, offset_s: float, rtt_s: float,
                           **extra):
    """Record the measured (server - local) wall offset in the local
    ring; ``trace_merge --align handshake`` applies it so client files
    from a DIFFERENT host still land on the server's timeline."""
    if not _trace.enabled():
        return
    _trace.instant("clock", "clock_handshake", role=str(role),
                   offset_s=float(offset_s), rtt_s=float(rtt_s),
                   pid=os.getpid(), **extra)


# ---------------------------------------------------------------------------
# Progress streaming
# ---------------------------------------------------------------------------
class ProgressBus:
    """Bounded per-request progress queues (always on — this is the
    streaming plane ``SolveClient.watch`` drains, independent of the
    trace ring).

    Each :meth:`emit` appends one event dict ``{"seq", "t", "kind",
    ...fields}`` to the request's bounded deque; :meth:`poll` returns
    the events past a consumer cursor (plus how many were lost to the
    bound — a slow watcher loses the OLDEST events, never blocks the
    scheduler).  :meth:`mark_done` latches the terminal state so a
    late-arriving watcher still observes completion."""

    def __init__(self, maxlen: int = 256):
        self.maxlen = int(maxlen)
        self._lock = threading.Lock()
        self._q: dict = {}        # rid -> {"dq", "next_seq", "done"}

    def _entry(self, rid: str):
        e = self._q.get(rid)
        if e is None:
            e = self._q[rid] = {
                "dq": collections.deque(maxlen=self.maxlen),
                "next_seq": 0, "done": False}
        return e

    def emit(self, rid, kind: str, **fields) -> int:
        """Append one event; returns its sequence number."""
        rid = str(rid)
        with self._lock:
            e = self._entry(rid)
            seq = e["next_seq"]
            e["next_seq"] = seq + 1
            ev = {"seq": seq, "t": time.time(), "kind": str(kind)}
            ev.update(fields)
            e["dq"].append(ev)
            return seq

    def mark_done(self, rid):
        with self._lock:
            self._entry(str(rid))["done"] = True

    def is_done(self, rid) -> bool:
        with self._lock:
            e = self._q.get(str(rid))
            return bool(e and e["done"])

    def poll(self, rid, cursor: int = 0):
        """``(events, next_cursor, lost, done)`` — every event with
        ``seq >= cursor`` still in the bound, the cursor to pass next
        time, how many the bound already evicted past the cursor, and
        the terminal latch."""
        rid = str(rid)
        cursor = int(cursor)
        with self._lock:
            e = self._q.get(rid)
            if e is None:
                return [], cursor, 0, False
            evs = [dict(ev) for ev in e["dq"] if ev["seq"] >= cursor]
            first_kept = e["dq"][0]["seq"] if e["dq"] else e["next_seq"]
            lost = max(0, first_kept - cursor)
            return evs, e["next_seq"], lost, e["done"]

    def drop(self, rid):
        """Release a retired request's queue (the server's
        ``retire_finished`` sweep calls this so bus memory tracks the
        retained-record window)."""
        with self._lock:
            self._q.pop(str(rid), None)

    def known(self, rid) -> bool:
        with self._lock:
            return str(rid) in self._q


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------
def _prom_name(name: str) -> str:
    out = []
    for ch in str(name):
        out.append(ch if (ch.isalnum() or ch in "_:") else "_")
    s = "".join(out)
    if s and s[0].isdigit():
        s = "_" + s
    return s


def _prom_val(v) -> str:
    try:
        v = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    return repr(v)


def _prom_label(v) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n") \
                 .replace('"', r'\"')


def prometheus_text(registry=None, extra_lines=()) -> str:
    """Render the metrics registry in the Prometheus text exposition
    format (version 0.0.4): counters as ``tpusppy_<name>_total``,
    gauges as ``tpusppy_<name>``, histograms as summaries (quantile
    series + ``_sum``/``_count``).  ``extra_lines`` (pre-rendered
    strings, e.g. :func:`tenant_gauge_lines`) append verbatim."""
    registry = registry or _metrics.REGISTRY
    with registry._lock:
        items = sorted(registry._metrics.items())
    lines = []
    for name, m in items:
        base = "tpusppy_" + _prom_name(name)
        if isinstance(m, _metrics.Histogram):
            s = m.summary()
            lines.append(f"# TYPE {base} summary")
            for q in (0.50, 0.95, 0.99):
                qv = m.quantile(q)
                if qv is not None:
                    lines.append(f'{base}{{quantile="{q}"}} '
                                 f"{_prom_val(qv)}")
            lines.append(f"{base}_sum {_prom_val(s['total'])}")
            lines.append(f"{base}_count {_prom_val(s['count'])}")
        elif isinstance(m, _metrics.Gauge):
            v = m.get()
            lines.append(f"# TYPE {base} gauge")
            lines.append(f"{base} {_prom_val(v if v is not None else 0)}")
        else:
            lines.append(f"# TYPE {base}_total counter")
            lines.append(f"{base}_total {_prom_val(m.get())}")
    lines.extend(extra_lines)
    return "\n".join(lines) + "\n"


#: (snapshot key, metric suffix) pairs rendered per live tenant.
_TENANT_GAUGES = (
    ("rel_gap", "tenant_rel_gap"),
    ("outer", "tenant_best_outer"),
    ("inner", "tenant_best_inner"),
    ("iters", "tenant_iters"),
    ("deadline_headroom_s", "tenant_deadline_headroom_seconds"),
    ("attributed_flops", "tenant_attributed_flops"),
    ("mfu_pct", "tenant_mfu_pct"),
)


def tenant_gauge_lines(snapshot: dict) -> list:
    """Per-tenant gauge lines from a server ``status_snapshot()``:
    live rel_gap / best bounds / deadline headroom / attributed FLOPs
    per request (labels ``request_id``, ``model``, ``qos``), plus the
    scheduler-level queue depth and batch slot occupancy."""
    lines = []
    sched = [("tpusppy_queue_depth", snapshot.get("queue_depth")),
             ("tpusppy_requests_live", snapshot.get("requests_live")),
             ("tpusppy_batch_slots", snapshot.get("batch_slots")),
             ("tpusppy_batch_slots_occupied",
              snapshot.get("batch_slots_occupied"))]
    for name, v in sched:
        if v is not None:
            lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name} {_prom_val(v)}")
    per = snapshot.get("requests") or {}
    emitted = set()
    for rid, row in sorted(per.items()):
        labels = (f'request_id="{_prom_label(rid)}",'
                  f'model="{_prom_label(row.get("model", ""))}",'
                  f'qos="{_prom_label(row.get("qos", ""))}",'
                  f'status="{_prom_label(row.get("status", ""))}"')
        for key, suffix in _TENANT_GAUGES:
            v = row.get(key)
            if v is None:
                continue
            name = "tpusppy_" + suffix
            if name not in emitted:
                emitted.add(name)
                lines.append(f"# TYPE {name} gauge")
            lines.append(f"{name}{{{labels}}} {_prom_val(v)}")
    return lines


# ---------------------------------------------------------------------------
# Zero-dependency scrape endpoint
# ---------------------------------------------------------------------------
def json_safe(v):
    """Strict-JSON scrub (non-finite floats -> repr strings) — the
    status surface carries records whose gaps are legitimately inf."""
    if isinstance(v, float):
        return v if math.isfinite(v) else repr(v)
    if isinstance(v, (bool, int, str)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): json_safe(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [json_safe(x) for x in v]
    try:
        return json_safe(float(v))
    except (TypeError, ValueError):
        return repr(v)


class ScrapeServer:
    """Stdlib-HTTP scrape endpoint: ``GET /metrics`` serves
    :func:`prometheus_text` (+ per-tenant gauges when a ``status_fn``
    is wired), ``GET /status`` the structured JSON snapshot.  Runs a
    daemonized ``ThreadingHTTPServer`` — zero new dependencies, closed
    with the frontend that owns it."""

    def __init__(self, status_fn=None, registry=None, port: int = 0,
                 bind: str = "127.0.0.1"):
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        scrape = self

        class _Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):      # no stderr chatter per scrape
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?", 1)[0]
                try:
                    if path in ("/metrics", "/"):
                        extra = []
                        if scrape.status_fn is not None:
                            extra = tenant_gauge_lines(scrape.status_fn())
                        body = prometheus_text(
                            scrape.registry, extra_lines=extra).encode()
                        self._send(200, "text/plain; version=0.0.4",
                                   body)
                    elif path == "/status":
                        snap = (scrape.status_fn()
                                if scrape.status_fn is not None else {})
                        self._send(200, "application/json",
                                   json.dumps(json_safe(snap)).encode())
                    else:
                        self._send(404, "text/plain", b"not found\n")
                except Exception as e:      # a scrape must never wedge
                    with contextlib.suppress(Exception):
                        self._send(500, "text/plain",
                                   f"scrape error: {e!r}\n".encode())

        self.status_fn = status_fn
        self.registry = registry
        self._httpd = ThreadingHTTPServer((bind, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.1},
            name="telemetry-scrape", daemon=True)
        self._thread.start()

    def close(self):
        with contextlib.suppress(Exception):
            self._httpd.shutdown()
            self._httpd.server_close()
        self._thread.join(timeout=5.0)
