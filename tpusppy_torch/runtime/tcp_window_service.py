"""ctypes bindings for the C++ TCP window service: mailboxes over TCP.

A copy of ``tpusppy/runtime/tcp_window_service.py`` with its own copy of
the host C++ source (``csrc/tcp_window_service.cpp``), built with ``g++`` at
first use into ``tpusppy_torch/_build/`` (never the library committed
beside the reference's source).  The server end serves the boxes
in-memory (its own accesses are local, mutex-guarded, no sockets); every
client connects by ``host:port`` and proves the fabric's shared secret.
The service tier's TCP front end (:mod:`..service.net`) carries its
request and response payloads over it.  The window services of the
multiprocess wheel spinner (the shared-memory fabric) are not ported yet.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time

import numpy as np

from ..obs import metrics as _obs_metrics
from ..obs.log import get_logger
from ..resilience import faults as _faults

_SRC = os.path.join(os.path.dirname(__file__), "csrc",
                    "tcp_window_service.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libtcp_window_service.so")
_lib = None
_lib_lock = threading.Lock()
_log = get_logger("tcp_window")

KILL_ID = -1
_LEN_ERR = -2
_IO_ERR = -4
_TIMEOUT_ERR = -5

# mid-run fault tolerance knobs (doc/resilience.md): a CLIENT endpoint
# retries a failed op with bounded exponential backoff, reconnecting
# between attempts — a transient network blip or hub restart inside the
# run no longer kills the spoke (previously only the FIRST-collective
# rendezvous skew was retried, by the connect timeout).  Servers never
# retry: their ops are local mutexed memory and an error there is a bug.
_RETRIES = int(os.environ.get("TPUSPPY_TCP_RETRIES", "4"))
_BACKOFF_BASE = float(os.environ.get("TPUSPPY_TCP_BACKOFF", "0.1"))
_BACKOFF_CAP = float(os.environ.get("TPUSPPY_TCP_BACKOFF_CAP", "5.0"))

_CTR_IO_ERRORS = _obs_metrics.counter("tcp_window.io_errors")
_CTR_RETRIES = _obs_metrics.counter("tcp_window.retries")
_CTR_RECONNECTS = _obs_metrics.counter("tcp_window.reconnects")
_CTR_OP_TIMEOUTS = _obs_metrics.counter("tcp_window.op_timeouts")


def default_op_timeout() -> float:
    """Per-op client deadline in seconds (``TPUSPPY_TCP_OP_TIMEOUT``;
    0 = block forever, the legacy behavior).  Read at endpoint
    construction, not import, so tests and the elastic wheel can arm it
    per run.  Bounds the wedged-yet-connected-server hang the plain IO
    retry path cannot see: a dead connection errors, a wedged server
    simply never replies (runtime/csrc/tcp_window_service.cpp keeps the
    server-side analogue note)."""
    return float(os.environ.get("TPUSPPY_TCP_OP_TIMEOUT", "0") or 0.0)


def load_library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        if (not os.path.exists(_LIB_PATH)
                or os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
            # built beside its final name and renamed: processes that
            # build at once never load a half-written library
            os.makedirs(_BUILD_DIR, exist_ok=True)
            tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
            subprocess.run(
                ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
                 _SRC, "-o", tmp],
                check=True, capture_output=True,
            )
            os.replace(tmp, _LIB_PATH)
        lib = ctypes.CDLL(_LIB_PATH)
        lib.tws_serve.restype = ctypes.c_void_p
        lib.tws_serve.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.c_uint64]
        lib.tws_connect.restype = ctypes.c_void_p
        lib.tws_connect.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                    ctypes.c_int64, ctypes.c_uint64]
        lib.tws_port.restype = ctypes.c_int
        lib.tws_port.argtypes = [ctypes.c_void_p]
        for fn, argt in [
            ("tws_num_boxes", [ctypes.c_void_p]),
            ("tws_length", [ctypes.c_void_p, ctypes.c_int]),
            ("tws_write_id", [ctypes.c_void_p, ctypes.c_int]),
            ("tws_kill", [ctypes.c_void_p, ctypes.c_int]),
        ]:
            getattr(lib, fn).restype = ctypes.c_int64
            getattr(lib, fn).argtypes = argt
        lib.tws_put.restype = ctypes.c_int64
        lib.tws_put.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_double),
                                ctypes.c_int64]
        lib.tws_get.restype = ctypes.c_int64
        lib.tws_get.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                ctypes.POINTER(ctypes.c_double),
                                ctypes.c_int64]
        lib.tws_set_op_timeout.restype = ctypes.c_int
        lib.tws_set_op_timeout.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.tws_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


class TcpEndpoint:
    """A server (hub) or client (spoke) handle over the box set.

    The server binds 127.0.0.1 by default; pass ``bind="0.0.0.0"`` (or a
    specific interface) to accept spokes from other hosts.  Every
    connection must present the server's ``secret`` (a random 64-bit token
    generated here unless supplied) — hand it to remote spoke launchers
    out-of-band along with host:port."""

    def __init__(self, lengths=None, port: int = 0, connect=None,
                 connect_timeout: float = 60.0, bind: str = "127.0.0.1",
                 secret: int | None = None, op_timeout: float | None = None):
        self._lib = load_library()
        self.op_timeout = (default_op_timeout() if op_timeout is None
                           else float(op_timeout))
        if connect is not None:
            host, prt = connect
            self.secret = int(secret or 0)
            self._connect_spec = (str(host), int(prt),
                                  float(connect_timeout))
            handle = self._lib.tws_connect(
                str(host).encode(), int(prt), int(connect_timeout * 1000),
                ctypes.c_uint64(self.secret))
            if not handle:
                raise RuntimeError(
                    f"cannot connect to window service at {host}:{prt} "
                    f"(down, or shared secret rejected)")
            self.port = int(prt)
            self.is_server = False
            self._handle = ctypes.c_void_p(handle)
            self._apply_op_timeout()
            return
        else:
            if secret is None:
                import secrets as _secrets

                secret = _secrets.randbits(64)
            self.secret = int(secret)
            arr = (ctypes.c_int64 * len(lengths))(*[int(x) for x in lengths])
            handle = self._lib.tws_serve(
                str(bind).encode(), int(port), len(lengths), arr,
                ctypes.c_uint64(self.secret))
            if not handle:
                raise RuntimeError(f"cannot serve window service on "
                                   f"{bind}:{port}")
            self.is_server = True
            self._handle = ctypes.c_void_p(handle)
            self.port = int(self._lib.tws_port(self._handle))

    def _apply_op_timeout(self):
        """Install the per-op deadline on the live client socket (called
        after every connect/reconnect — the C side stores it per handle,
        and a fresh handle starts blocking)."""
        if self.op_timeout and getattr(self, "_handle", None):
            self._lib.tws_set_op_timeout(
                self._handle, int(self.op_timeout * 1000))

    @property
    def num_boxes(self) -> int:
        return self._check(self._lib.tws_num_boxes(self._handle))

    def length(self, box: int) -> int:
        return self._check(self._lib.tws_length(self._handle, box))

    def _check(self, rc: int) -> int:
        if rc == _TIMEOUT_ERR:
            # connected but unresponsive: the op deadline expired and the
            # C side closed the (desynced) connection — loud by contract
            _CTR_OP_TIMEOUTS.inc(1)
            _CTR_IO_ERRORS.inc(1)
            _log.warning("window-service op timed out after %.1fs "
                         "(TPUSPPY_TCP_OP_TIMEOUT) — connection dropped",
                         self.op_timeout)
            raise RuntimeError(
                f"TCP window service op timed out after "
                f"{self.op_timeout:.1f}s (server wedged?); "
                "connection lost")
        if rc == _IO_ERR:
            _CTR_IO_ERRORS.inc(1)
            raise RuntimeError("TCP window service connection lost")
        return int(rc)

    @property
    def can_reconnect(self) -> bool:
        return not self.is_server and hasattr(self, "_connect_spec")

    def reconnect(self):
        """Tear down the (possibly dead) client connection and dial the
        server again with the original host/port/secret — the mid-run
        recovery primitive behind the mailbox retry path."""
        if not self.can_reconnect:
            raise RuntimeError("server endpoints cannot reconnect")
        host, prt, timeout = self._connect_spec
        self.close()
        handle = self._lib.tws_connect(
            host.encode(), prt, int(timeout * 1000),
            ctypes.c_uint64(self.secret))
        if not handle:
            _CTR_IO_ERRORS.inc(1)
            raise RuntimeError(
                f"reconnect to window service at {host}:{prt} failed")
        self._handle = ctypes.c_void_p(handle)
        self._apply_op_timeout()
        _CTR_RECONNECTS.inc(1)

    def drop_for_test(self):
        """Sever the connection NOW (close the handle) without touching
        the server — the deterministic 'network died' hook the reconnect
        test drives.  Subsequent ops raise connection-lost until a
        :meth:`reconnect` (the mailbox retry path does it)."""
        self.close()

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.tws_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class TcpMailbox:
    """Mailbox-API view over one box (put/get/kill/write_id, −1 sentinel).

    Client-side ops are wrapped in a bounded retry: a transient IO
    failure (dead connection, injected fault) backs off exponentially
    (``TPUSPPY_TCP_BACKOFF`` base, doubled per attempt, capped), the
    endpoint RECONNECTS, and the op re-runs — up to
    ``TPUSPPY_TCP_RETRIES`` retries, then the error propagates.  Server
    ops never retry (local memory).  All traffic is billed to the
    ``tcp_window.*`` obs counters.
    """

    KILL_ID = KILL_ID

    def __init__(self, ep: TcpEndpoint, box: int, name: str = ""):
        self.ep = ep
        self.box = int(box)
        self.name = name
        self.length = self._io("length", lambda: ep.length(self.box))

    def _io(self, opname: str, fn):
        """Run one window op under the transient-failure retry policy.
        An endpoint may pin ``io_retries`` (e.g. 0) when a HIGHER layer
        owns reconnection — :class:`..service.net.SolveClient`
        does, so its dead-server detection isn't multiplied through two
        nested retry stacks reading the same env knobs."""
        delay = _BACKOFF_BASE
        retries = getattr(self.ep, "io_retries", _RETRIES)
        for attempt in range(retries + 1):
            try:
                if _faults.active():    # deterministic drop/delay injection
                    _faults.on_tcp_io(self.name)
                if self.ep._handle is None:
                    # a severed connection: NULL handles must never reach
                    # the C side (that would be UB, not an error return)
                    _CTR_IO_ERRORS.inc(1)
                    raise RuntimeError(
                        "TCP window service connection lost")
                return fn()
            except (RuntimeError, OSError) as e:
                # injected faults count under faults.*; real IO errors are
                # already billed where they surface (_check / reconnect)
                transient = "connection lost" in str(e)
                if (not transient or not self.ep.can_reconnect
                        or attempt == retries):
                    raise
                _CTR_RETRIES.inc(1)
                time.sleep(delay)
                delay = min(delay * 2.0, _BACKOFF_CAP)
                try:
                    self.ep.reconnect()
                except RuntimeError:
                    # server still unreachable: keep backing off — the
                    # next attempt's handle-None guard re-raises cleanly
                    continue

    def put(self, values) -> int:
        values = np.ascontiguousarray(values, dtype=np.float64)
        if values.shape != (self.length,):
            raise RuntimeError(
                f"TcpMailbox {self.name}: putting length {values.shape} "
                f"into buffer of length {self.length}")
        rc = self._io("put", lambda: self.ep._check(self.ep._lib.tws_put(
            self.ep._handle, self.box,
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            self.length)))
        if rc == _LEN_ERR:
            raise RuntimeError("length mismatch in tws_put")
        return rc

    def get(self, timeout=None):
        """(values, write_id) snapshot; always immediate (server-side boxes
        are mutex-consistent — no seqlock wait states)."""
        out = np.empty(self.length, dtype=np.float64)
        wid = self._io("get", lambda: self.ep._check(self.ep._lib.tws_get(
            self.ep._handle, self.box,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            self.length)))
        if wid == _LEN_ERR:
            raise RuntimeError("length mismatch in tws_get")
        return out, int(wid)

    def kill(self):
        self._io("kill", lambda: self.ep._check(
            self.ep._lib.tws_kill(self.ep._handle, self.box)))

    @property
    def write_id(self) -> int:
        return self._io("write_id", lambda: self.ep._check(
            self.ep._lib.tws_write_id(self.ep._handle, self.box)))


class TcpWindowFabric:
    """WindowFabric API over TCP: 2 boxes per spoke (hub->spoke, spoke->hub).

    Hub side: ``TcpWindowFabric(spoke_lengths=[(h2s, s2h), ...], port=0)``
    (port 0 = kernel-assigned; read ``fabric.port``; loopback bind by
    default — pass ``bind="0.0.0.0"`` for cross-host wheels).  Spoke side
    (any host): ``TcpWindowFabric(connect=(host, port),
    secret=<hub fabric.secret>)`` — the handshake rejects missing/wrong
    secrets.
    """

    def __init__(self, spoke_lengths=None, port: int = 0, connect=None,
                 connect_timeout: float = 60.0, bind: str = "127.0.0.1",
                 secret: int | None = None, op_timeout: float | None = None):
        if connect is not None:
            self.ep = TcpEndpoint(connect=connect,
                                  connect_timeout=connect_timeout,
                                  secret=secret, op_timeout=op_timeout)
            n = self.ep.num_boxes // 2
        else:
            lengths = []
            for (h2s, s2h) in spoke_lengths:
                lengths.extend([h2s, s2h])
            self.ep = TcpEndpoint(lengths=lengths, port=port, bind=bind,
                                  secret=secret, op_timeout=op_timeout)
            n = len(spoke_lengths)
        self.port = self.ep.port
        self.secret = self.ep.secret
        self.to_spoke = {}
        self.to_hub = {}
        for i in range(1, n + 1):
            self.to_spoke[i] = TcpMailbox(self.ep, 2 * (i - 1),
                                          f"hub->spoke{i}")
            self.to_hub[i] = TcpMailbox(self.ep, 2 * (i - 1) + 1,
                                        f"spoke{i}->hub")

    @property
    def n_spokes(self) -> int:
        return len(self.to_spoke)

    def send_terminate(self):
        for mb in self.to_spoke.values():
            mb.kill()

    def close(self):
        self.ep.close()
