"""TCP request transport for the solve server — over the port's C++ TCP
window runtime (:mod:`..runtime.tcp_window_service`).

A copy of ``tpusppy/service/net.py`` (its payload encoding is the
reference's, byte for byte).

The server owns a :class:`TcpWindowFabric` with one mailbox PAIR per
request SLOT: clients put a JSON-encoded :class:`~.server.SolveRequest`
into the slot's inbound box and poll the outbound box for the SLO-record
response — the exact write-id freshness protocol every wheel spoke
already speaks, so remote ingest needs no new wire machinery (and rides
the runtime's retry/reconnect + shared-secret handshake for free).

JSON payloads travel as raw bytes memcpy'd into the box's float64 array:
``[byte_length, utf-8 bytes padded to 8-byte multiples]``.  A slot
serves requests SEQUENTIALLY (one in flight per slot); concurrency comes
from using several slots — see doc/serving.md for the client recipe.

Failure semantics (doc/serving.md "Durability"):

- Server-side failures answer STRUCTURED error payloads — ``status``
  plus a typed ``error_code`` ("overload", "bad_request", "deadline",
  "exception", ...) and message — so a failed request NEVER presents to
  the client as a poll-to-timeout.
- :class:`SolveClient` detects a dead socket, reconnects with bounded
  exponential backoff (the ``TPUSPPY_TCP_RETRIES``/``_BACKOFF`` knobs),
  and raises the typed :class:`ServerLost` when reconnection exhausts —
  immediately, not after the full poll timeout.
- Requests are IDEMPOTENT by ``request_id``: a re-submit after a
  reconnect (or across a server restart on the same work dir) resolves
  to the original journaled record, and ``{"op": "fetch"}`` retrieves a
  finished result by id — even one whose original delivery failed (the
  frontend journals undeliverable responses).
"""

from __future__ import annotations

import json
import os
import threading
import time

import numpy as np

import uuid

from ..obs import metrics as _metrics
from ..obs import telemetry as _telemetry
from ..obs.log import get_logger
from ..resilience import faults as _faults
from .server import ServerClosed, ServerOverloaded, SolveRequest

_log = get_logger("service")

_CTR_UNDELIVERED = _metrics.counter("service.undelivered_journaled")
_CTR_CLIENT_RECONNECTS = _metrics.counter("service.client_reconnects")
_CTR_SERVER_LOST = _metrics.counter("service.server_lost")

#: Mailbox sizes in float64 slots (first slot = byte length).
REQ_SLOTS = 4096          # ~32 KB of JSON per request
RESP_SLOTS = 4096


class ServiceError(RuntimeError):
    """A structured serving failure: typed ``code`` + human message."""

    def __init__(self, message: str, code: str = "error"):
        super().__init__(message)
        self.code = str(code)

    @classmethod
    def from_record(cls, record: dict) -> "ServiceError":
        return cls(str(record.get("error") or "request failed"),
                   code=str(record.get("error_code") or "error"))


class ServerLost(ServiceError):
    """The server is unreachable and bounded reconnection exhausted.
    Raised IMMEDIATELY by :meth:`SolveClient.wait` on a dead socket —
    a crashed server must never cost a waiter the full poll timeout."""

    def __init__(self, message: str):
        super().__init__(message, code="server_lost")


def encode_payload(obj, length: int) -> np.ndarray:
    """dict -> float64 mailbox payload (length-prefixed raw JSON bytes)."""
    raw = json.dumps(obj).encode()
    if len(raw) > (length - 1) * 8:
        raise ValueError(f"payload of {len(raw)} bytes exceeds the "
                         f"{(length - 1) * 8}-byte mailbox")
    buf = np.zeros(length, dtype=np.float64)
    buf[0] = float(len(raw))
    padded = raw + b"\0" * ((-len(raw)) % 8)
    if padded:
        buf[1:1 + len(padded) // 8] = np.frombuffer(padded, np.float64)
    return buf


def decode_payload(values: np.ndarray):
    """Inverse of :func:`encode_payload`."""
    values = np.asarray(values, np.float64)
    nbytes = int(values[0])
    if nbytes <= 0:
        return None
    raw = values[1:1 + (nbytes + 7) // 8].tobytes()[:nbytes]
    return json.loads(raw.decode())


class TcpServiceFrontend:
    """Serve a :class:`~.server.SolveServer` over TCP request slots.

    The listener thread polls every slot's inbound write-id; a fresh put
    is decoded, submitted, and answered into the outbound box when the
    request finishes.  Requests on DIFFERENT slots run through the
    scheduler concurrently (time-sliced), exactly like in-process
    submits.

    Besides plain request dicts, a slot accepts
    ``{"op": "fetch", "request_id": ...}`` — answer a (possibly
    already-finished, possibly previous-lifetime) request's record by
    id.  Unknown ids answer a structured ``unknown_request`` error.

    Telemetry ops (doc/observability.md):

    - ``{"op": "status", "request_id"?}`` — answered IMMEDIATELY with
      the scheduler's live snapshot (per-request record, or the whole
      server's per-tenant gauge rows), stamped with the server's wall
      clock so the client can record an NTP-style handshake offset.
    - ``{"op": "watch", "request_id", "cursor"}`` — a LONG POLL over
      the request's bounded progress queue: one response batch per op,
      sent as soon as events past the cursor exist (or the terminal
      latch is set, in which case the batch carries the final record).
      One batch per op fits the latest-wins mailbox transport: the
      client re-requests with the advanced cursor, so no pushed event
      can be overwritten unread.

    ``scrape_port`` (optional) additionally serves ``GET /metrics``
    (Prometheus text format + per-tenant gauges) and ``GET /status``
    on a zero-dependency HTTP endpoint (0 = ephemeral; the bound port
    is ``self.scrape_port``).
    """

    def __init__(self, server, slots: int = 4, port: int = 0,
                 bind: str = "127.0.0.1", secret: int | None = None,
                 poll_secs: float = 0.05, scrape_port: int | None = None):
        from ..runtime.tcp_window_service import TcpWindowFabric

        self.server = server
        self.fabric = TcpWindowFabric(
            spoke_lengths=[(RESP_SLOTS, REQ_SLOTS)] * slots,
            port=port, bind=bind, secret=secret)
        self.port = self.fabric.port
        self.secret = self.fabric.secret
        self.poll_secs = float(poll_secs)
        self._last_ids = {i: 0 for i in range(1, slots + 1)}
        self._pending: dict = {}           # slot -> _Tenant (object ref)
        self._watch: dict = {}             # slot -> {"rid", "cursor"}
        self._ingesting: set = set()       # rids mid-decode/ingest
        self._lock = threading.Lock()
        self._stop = False
        self._scrape = None
        self.scrape_port = None
        if scrape_port is not None:
            self._scrape = _telemetry.ScrapeServer(
                status_fn=server.status_snapshot, port=int(scrape_port),
                bind=bind)
            self.scrape_port = self._scrape.port
        _telemetry.record_clock_sync("frontend", port=self.port)
        self._thread = threading.Thread(target=self._loop,
                                        name="service-tcp", daemon=True)
        self._thread.start()

    def _handle_fetch(self, slot: int, rid: str):
        """Answer a fetch-by-id: finished records answer immediately
        (live tenants first, then the journal — which also covers
        previous server lifetimes and previously-undeliverable
        responses); an unfinished tenant registers the slot to be
        answered at completion."""
        t = self.server.lookup(rid)
        if t is not None and not t.done.is_set():
            with self._lock:
                self._pending[slot] = t
            return
        if t is not None:
            self._answer(slot, dict(t.record))
            return
        rec = self.server._journal_record(rid)
        if rec is not None:
            self._answer(slot, rec)
        else:
            self._answer(slot, {
                "request_id": rid, "status": "failed",
                "error_code": "unknown_request",
                "error": f"unknown (or fully retired) request id {rid!r}"})

    def _handle_status(self, slot: int, payload: dict):
        """Answer a status RPC immediately: the live scheduler snapshot
        (whole-server, or one request's record), stamped with the
        server's wall clock + the echo of the client's send stamp so the
        client computes the NTP-style handshake offset."""
        rid = str(payload.get("request_id") or "")
        try:
            snap = self.server.status_snapshot(rid or None)
        except Exception as e:
            self._answer(slot, {"op": "status", "request_id": rid,
                                "status": "failed",
                                "error_code": "exception",
                                "error": repr(e)})
            return
        resp = {"op": "status", "request_id": rid,
                "server_wall": time.time(), "snapshot": snap}
        if payload.get("t_wall") is not None:
            resp["t_wall"] = payload["t_wall"]
        self._answer(slot, _telemetry.json_safe(resp))

    def _watch_ready(self, rid: str, cursor: int):
        """One watch long-poll's answer when one is due, else None.
        Due = events past the cursor exist, the terminal latch is set,
        or the id resolves to no live/streamable request at all (the
        batch then carries the journaled record, or a structured
        ``unknown_request``)."""
        bus = self.server.progress
        evs, nxt, lost, done = bus.poll(rid, cursor)
        if evs or done:
            resp = {"op": "watch", "request_id": rid, "events": evs,
                    "cursor": nxt, "lost": lost, "done": done,
                    "server_wall": time.time()}
            if done:
                t = self.server.lookup(rid)
                rec = (dict(t.record) if t is not None
                       else self.server._journal_record(rid))
                if rec is not None:
                    resp["record"] = rec
            return _telemetry.json_safe(resp)
        if not bus.known(rid):
            with self._lock:
                if rid in self._ingesting:
                    return None    # ingest in flight: not unknown yet
            t = self.server.lookup(rid)
            if t is None or t.done.is_set():
                rec = (dict(t.record) if t is not None
                       else self.server._journal_record(rid)) or {
                    "request_id": rid, "status": "failed",
                    "error_code": "unknown_request",
                    "error": f"unknown (or fully retired) request id "
                             f"{rid!r}"}
                return _telemetry.json_safe(
                    {"op": "watch", "request_id": rid, "events": [],
                     "cursor": cursor, "lost": 0, "done": True,
                     "record": rec, "server_wall": time.time()})
        return None

    def _handle_watch(self, slot: int, payload: dict):
        rid = str(payload.get("request_id") or "")
        cursor = int(payload.get("cursor") or 0)
        resp = self._watch_ready(rid, cursor)
        if resp is not None:
            self._answer(slot, resp)
            return
        with self._lock:       # quiet stream: the loop answers when due
            self._watch[slot] = {"rid": rid, "cursor": cursor}

    def _submit_async(self, slot: int, data):
        """Decode + ingest + submit on a per-request thread: ingest is
        minutes of single-core numpy at reference scale, and running it
        on the listener would stall intake AND response delivery for
        every other slot.  The pending entry holds the TENANT OBJECT
        (not its id), so a ``retire_finished()`` sweep between
        completion and the next poll cannot orphan the response."""
        rid = ""
        ing = ""
        try:
            payload = decode_payload(data)
            if isinstance(payload, dict) and payload.get("op") == "fetch":
                self._handle_fetch(slot, str(payload.get("request_id")))
                return
            if isinstance(payload, dict) and payload.get("op") == "status":
                self._handle_status(slot, payload)
                return
            if isinstance(payload, dict) and payload.get("op") == "watch":
                self._handle_watch(slot, payload)
                return
            if isinstance(payload, dict):
                # mark the id mid-ingest BEFORE the (seconds-long)
                # decode+submit: a watch long-poll racing the ingest
                # must stay quiet instead of answering unknown_request
                ing = str(payload.get("request_id") or "")
                if ing:
                    with self._lock:
                        self._ingesting.add(ing)
            req = SolveRequest.from_dict(payload)
            rid = req.request_id
            rid = self.server.submit(req)
            t = self.server.lookup(rid)
            if t is None:
                # idempotent re-submit of a finished-and-retired (or
                # previous-lifetime) id: the journal has the record
                self._answer(slot, self.server._journal_record(rid) or {
                    "request_id": rid, "status": "failed",
                    "error_code": "unknown_request",
                    "error": f"request {rid!r} resolved to no record"})
                return
            with self._lock:
                self._pending[slot] = t
        except ServerOverloaded as e:      # typed fast-fail: back off
            _log.warning("slot %d: overloaded: %s", slot, e)
            self._answer(slot, {"request_id": rid, "status": "rejected",
                                "error_code": ServerOverloaded.code,
                                "error": str(e)})
        except ServerClosed as e:
            # shutting down is not the client's fault: "unavailable"
            # says retry against the restarted server, where the same
            # well-formed request would succeed — never "bad_request"
            _log.warning("slot %d: closed: %s", slot, e)
            self._answer(slot, {"request_id": rid, "status": "rejected",
                                "error_code": ServerClosed.code,
                                "error": str(e)})
        except Exception as e:             # malformed request: answer it
            _log.warning("slot %d: bad request: %r", slot, e)
            self._answer(slot, {"request_id": rid, "status": "failed",
                                "error_code": "bad_request",
                                "error": repr(e)})
        finally:
            if ing:
                with self._lock:
                    self._ingesting.discard(ing)

    def _loop(self):
        while not self._stop:
            for slot, mb in self.fabric.to_hub.items():
                try:
                    data, wid = mb.get()
                except RuntimeError:
                    continue               # transient fabric error
                if wid <= self._last_ids[slot] or wid < 0:
                    continue
                self._last_ids[slot] = wid
                threading.Thread(
                    target=self._submit_async, args=(slot, data),
                    name=f"service-ingest-{slot}", daemon=True).start()
            with self._lock:
                ready = [(slot, t) for slot, t in self._pending.items()
                         if t.done.is_set()]
                for slot, _ in ready:
                    del self._pending[slot]
            for slot, t in ready:
                self._answer(slot, dict(t.record))
            # quiet watch long-polls: answer each registered stream as
            # soon as events (or the terminal latch) show up
            with self._lock:
                watches = list(self._watch.items())
            for slot, w in watches:
                try:
                    resp = self._watch_ready(w["rid"], w["cursor"])
                except Exception as e:
                    resp = {"op": "watch", "request_id": w["rid"],
                            "events": [], "cursor": w["cursor"],
                            "lost": 0, "done": True,
                            "record": {"request_id": w["rid"],
                                       "status": "failed",
                                       "error_code": "exception",
                                       "error": repr(e)}}
                if resp is not None:
                    with self._lock:
                        self._watch.pop(slot, None)
                    self._answer(slot, resp)
            time.sleep(self.poll_secs)

    def _answer(self, slot: int, payload: dict):
        """Best-effort response put: a transient fabric error (client
        mid-reconnect, injected fault) must never kill the listener
        thread — that would silently wedge EVERY slot forever.  The
        undeliverable response is JOURNALED (``service.undelivered_
        journaled``) so a reconnecting client still fetches the result
        by request id."""
        try:
            self.fabric.to_spoke[slot].put(
                encode_payload(payload, RESP_SLOTS))
        except Exception as e:
            _log.warning("slot %d: response put failed (journaled for "
                         "fetch-by-id): %r", slot, e)
            _CTR_UNDELIVERED.inc(1)
            try:
                self.server.journal.undelivered(
                    payload.get("request_id"), payload)
            except Exception as je:
                _log.warning("slot %d: undeliverable response could not "
                             "be journaled either: %r", slot, je)

    def close(self):
        self._stop = True
        self._thread.join(timeout=10.0)
        if self._scrape is not None:
            self._scrape.close()
        self.fabric.close()


class SolveClient:
    """Remote client for one request slot of a TCP-served solve server.

    Reconnecting and idempotent: a transport failure triggers bounded
    reconnect-with-backoff (``reconnect_tries`` total dials, backoff
    from the ``TPUSPPY_TCP_BACKOFF`` knob); exhaustion raises the typed
    :class:`ServerLost` IMMEDIATELY (a dead server never costs the full
    poll timeout).  After a reconnect, re-:meth:`submit` with the same
    ``request_id`` (idempotent server-side) or :meth:`fetch` the result
    by id — including across a server restart on the same work dir.
    """

    def __init__(self, host: str, port: int, secret: int, slot: int = 1,
                 connect_timeout: float = 60.0,
                 reconnect_tries: int | None = None,
                 reconnect_backoff: float | None = None,
                 reconnect_dial_secs: float = 1.0):
        from ..runtime.tcp_window_service import TcpWindowFabric

        self.fabric = TcpWindowFabric(connect=(host, port), secret=secret,
                                      connect_timeout=connect_timeout)
        self.slot = int(slot)
        # RE-dials use a SHORT per-dial deadline: the C++ connect retries
        # until its timeout (rendezvous semantics — right for the first
        # connect, wrong mid-recovery), so redialing a dead server with
        # the full connect_timeout would multiply into minutes across
        # the retry stack before ServerLost could surface
        self.fabric.ep._connect_spec = (
            str(host), int(port), float(reconnect_dial_secs))
        # the mailbox's own transparent per-op retry is driven by the
        # SAME env knobs as _op — nested, a dead server would cost
        # (retries+1)^2 dials before ServerLost could surface.  The
        # client layer owns reconnection outright: inner ops fail fast,
        # _op backs off and redials on the short per-dial spec above
        self.fabric.ep.io_retries = 0
        self.reconnect_tries = int(
            reconnect_tries if reconnect_tries is not None
            else os.environ.get("TPUSPPY_TCP_RETRIES", "4"))
        self.reconnect_backoff = float(
            reconnect_backoff if reconnect_backoff is not None
            else os.environ.get("TPUSPPY_TCP_BACKOFF", "0.1"))
        self._last_resp = self.fabric.to_spoke[self.slot].write_id
        #: terminal record captured by the last :meth:`watch` /
        #: :meth:`wait_result` stream on this client
        self.last_record = None
        # recent solve submits (rid -> (t_put, payload)): the request
        # box is latest-wins, so an op put racing the UNREAD submit can
        # overwrite it — watch() uses this to settle before its first
        # op and to re-submit (idempotent) if the id comes back unknown
        self._inflight: dict = {}
        _telemetry.record_clock_sync("client", slot=self.slot)

    def _op(self, fn):
        """One transport op under the client-level reconnect policy (on
        top of the mailbox's own per-op retry).  Raises
        :class:`ServerLost` when every dial fails."""
        delay = self.reconnect_backoff
        for attempt in range(self.reconnect_tries + 1):
            try:
                if _faults.active():       # deterministic flaky-client
                    _faults.on_client_op(self.slot)
                return fn()
            except (RuntimeError, OSError) as e:
                if "connection lost" not in str(e):
                    raise                  # not a transport death: loud
                if attempt == self.reconnect_tries:
                    _CTR_SERVER_LOST.inc(1)
                    raise ServerLost(
                        f"server unreachable on slot {self.slot} after "
                        f"{attempt + 1} attempt(s): {e}") from e
                time.sleep(delay)
                delay = min(delay * 2.0, 5.0)
                try:
                    self.reconnect()
                except (RuntimeError, OSError):
                    continue               # keep backing off

    def reconnect(self):
        """Re-dial the server (same host/port/secret).  A RESTARTED
        server's mailboxes start at write-id 0 — the response cursor
        rewinds so the restarted lifetime's responses aren't skipped
        (responses are keyed by request id, never by cursor position)."""
        self.fabric.ep.reconnect()
        _CTR_CLIENT_RECONNECTS.inc(1)
        wid = self.fabric.to_spoke[self.slot].write_id
        self._last_resp = min(self._last_resp, wid)

    def submit(self, request: dict) -> str:
        """Send one request dict (model/num_scens/creator_kwargs/options/
        request_id/deadline_secs); returns the request id.  A missing
        ``request_id`` is assigned HERE, client-side, before the wire —
        the reconnect path below may re-run the put (connection lost
        mid-op with the first put already ingested), and only a stable
        id makes that retry resolve idempotently server-side instead of
        starting a second solve."""
        request = dict(request)
        is_op = request.get("op") is not None
        if not is_op and not request.get("request_id"):
            # not setdefault: an explicit ``request_id: None`` (natural
            # when plumbing an optional parameter) must be replaced too,
            # or the retried put starts a second solve after all
            request["request_id"] = f"req-{uuid.uuid4().hex[:10]}"
        if not is_op and not request.get("trace_id"):
            # the distributed trace starts HERE, at the outermost edge:
            # the id rides the wire payload, the journal, every batch
            # slot and every per-window event server-side
            request["trace_id"] = _telemetry.mint_trace_id()
        self._op(lambda: self.fabric.to_hub[self.slot].put(
            encode_payload(request, REQ_SLOTS)))
        rid = str(request.get("request_id") or "")
        if not is_op:
            self._inflight[rid] = (time.time(), dict(request))
            while len(self._inflight) > 8:     # bounded memory
                self._inflight.pop(next(iter(self._inflight)))
            _telemetry.tenant_instant(rid, request.get("trace_id"),
                                      "submitted",
                                      model=request.get("model"),
                                      slot=self.slot)
        return rid

    def wait(self, timeout: float = 600.0, poll_secs: float = 0.1,
             request_id: str | None = None) -> dict:
        """Block for this slot's next response; returns the SLO record.
        A dead socket raises :class:`ServerLost` as soon as bounded
        reconnection exhausts — never after silently polling out the
        full ``timeout``.

        When ``request_id`` is given, a response carrying a DIFFERENT
        (non-empty) id is consumed and discarded instead of returned:
        the reconnect path can re-run a put the server already ingested,
        and the duplicate's idempotent answer would otherwise be handed
        to the NEXT request on the slot, shifting every later response
        off by one.  Error answers the server could not attribute to an
        id (``request_id`` "") still match — a malformed-request
        rejection must not poll out the timeout."""
        t0 = time.time()
        mb = self.fabric.to_spoke[self.slot]
        while time.time() - t0 < timeout:
            data, wid = self._op(mb.get)
            if wid > self._last_resp:
                self._last_resp = wid
                payload = decode_payload(data)
                rid = str((payload or {}).get("request_id") or "")
                if (request_id is not None and rid
                        and rid != str(request_id)):
                    continue           # stale duplicate-op response
                return payload
            time.sleep(poll_secs)
        raise TimeoutError(f"no response on slot {self.slot} "
                           f"after {timeout}s")

    def fetch(self, request_id: str, timeout: float = 600.0) -> dict:
        """Retrieve a request's record by id — finished requests (even
        from a previous server lifetime, or whose original response
        delivery failed) answer from the journal; unfinished ones answer
        at completion."""
        self.submit({"op": "fetch", "request_id": str(request_id)})
        return self.wait(timeout=timeout, request_id=str(request_id))

    def _record_handshake(self, t_send: float, server_wall):
        """Bank the NTP-style (server - client) wall offset measured by
        one op round trip — ``trace_merge --align handshake`` applies it
        to place this client's ring on the server's timeline."""
        if server_wall is None:
            return
        t_recv = time.time()
        off = _telemetry.handshake_offset(t_send, t_recv, server_wall)
        _telemetry.record_clock_handshake("client", off, t_recv - t_send,
                                          slot=self.slot)

    def status(self, request_id: str | None = None,
               timeout: float = 60.0) -> dict:
        """Live scheduler snapshot via the ``status`` RPC: one request's
        ``{"request_id", "done", "status", "record"}``, or (with no id)
        the whole server's ``{"queue_depth", "requests_live",
        "batch_slots", "batch_slots_occupied", "requests": {rid: row}}``
        — the same rows the scrape endpoint renders as gauges.  Answered
        immediately (never at completion) and stamped with the server's
        wall clock, which this client records as a clock handshake for
        ``scripts/trace_merge.py``.

        Requires a telemetry-aware server for the WHOLE-SERVER form; the
        per-request form degrades gracefully on an older server (the op
        decodes as an idempotent duplicate submit of the same id and is
        answered with the original record at completion — fetch
        semantics)."""
        rid = str(request_id) if request_id else ""
        t_send = time.time()
        self.submit({"op": "status", "request_id": rid,
                     "t_wall": t_send})
        resp = self.wait(timeout=timeout, request_id=rid or None)
        if isinstance(resp, dict) and resp.get("op") == "status":
            self._record_handshake(t_send, resp.get("server_wall"))
            return resp["snapshot"]
        # legacy server: the answer IS the terminal record
        return resp

    def watch(self, request_id: str, timeout: float = 600.0,
              cursor: int = 0):
        """Stream a request's live progress events — a generator of
        event dicts ``{"seq", "t", "kind", ...}``: per-window ``gap``
        points, ``bound_update``s (with the bound-source char),
        ``running``/``parked``/``recovered`` verdicts, and the terminal
        ``done``/``failed``/``deadline`` event.  Long-polls the ``watch``
        RPC (one batch per op, cursor-advanced, so the latest-wins
        mailbox can never overwrite an unread event); the final record
        lands in ``self.last_record``.

        On an OLD server the op degrades to fetch semantics (idempotent
        duplicate submit answered at completion): the stream then yields
        ONE synthetic terminal event carrying the record.  ``timeout``
        bounds the whole stream.  A slow consumer may lose the OLDEST
        events to the server's bounded queue — each batch's ``lost``
        count is surfaced on the event dicts' ``_lost`` key."""
        rid = str(request_id)
        deadline = time.time() + float(timeout)
        cursor = int(cursor)
        sub = self._inflight.get(rid)
        if sub is not None:
            # the request box is latest-wins: an op put before the
            # frontend's poll consumed the solve submit would overwrite
            # it — give a just-submitted request a moment to land
            settle = sub[0] + 0.5 - time.time()
            if settle > 0:
                time.sleep(min(settle, 0.5))
        resubmits = 0
        record_races = 0

        def _unknown(rec):
            return (isinstance(rec, dict)
                    and rec.get("error_code") == "unknown_request")

        while True:
            t_send = time.time()
            remaining = deadline - t_send
            if remaining <= 0:
                raise TimeoutError(
                    f"watch({rid!r}) exhausted its {timeout}s budget")
            self.submit({"op": "watch", "request_id": rid,
                         "cursor": cursor, "t_wall": t_send})
            resp = self.wait(timeout=remaining, request_id=rid)
            if not isinstance(resp, dict) or resp.get("op") != "watch":
                if _unknown(resp) and sub is not None and resubmits < 4:
                    # our own solve put was overwritten unread: replay
                    # it (idempotent on the stable request id)
                    resubmits += 1
                    self.submit(dict(sub[1]))
                    time.sleep(0.25)
                    continue
                if record_races == 0:
                    # the solve's own completion answer (the slot's
                    # pending response) raced a watch batch on the
                    # latest-wins box: a telemetry-aware server still
                    # owes the drained events + done batch — re-poll
                    # once; a legacy server answers the record again
                    record_races = 1
                    self.last_record = resp
                    continue
                # legacy server: terminal record, no event stream
                self.last_record = resp
                yield {"seq": -1, "t": time.time(), "kind": "done",
                       "legacy": True, "record": resp}
                return
            self._record_handshake(t_send, resp.get("server_wall"))
            if (resp.get("done") and _unknown(resp.get("record"))
                    and sub is not None and resubmits < 4):
                resubmits += 1
                self.submit(dict(sub[1]))
                time.sleep(0.25)
                continue
            lost = int(resp.get("lost") or 0)
            for ev in resp.get("events") or []:
                if lost:
                    ev["_lost"] = lost
                yield ev
            cursor = int(resp.get("cursor") or cursor)
            if resp.get("done"):
                self.last_record = (resp.get("record")
                                    or self.last_record)
                return

    def wait_result(self, request_id: str,
                    timeout: float = 600.0) -> dict:
        """Terminal record for ``request_id`` — woken by the STREAMED
        terminal event (the ``watch`` RPC's done batch) instead of
        busy-polling ``fetch`` at ``poll_secs``; an old server degrades
        to exactly the fetch path (watch's legacy answer IS the
        record)."""
        rid = str(request_id)
        t0 = time.time()
        for _ in self.watch(rid, timeout=timeout):
            pass
        if self.last_record is not None:
            return self.last_record
        # terminal batch without a record (retired mid-stream): the
        # journal still has it — fall back to the poll path
        return self.fetch(rid, timeout=max(1.0,
                                           timeout - (time.time() - t0)))

    def solve(self, request: dict, timeout: float = 600.0) -> dict:
        rid = self.submit(request)
        return self.wait(timeout=timeout, request_id=rid or None)

    def close(self):
        self.fabric.close()
