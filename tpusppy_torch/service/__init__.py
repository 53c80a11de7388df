"""The service tier: the persistent warm-path solve server.

Port of ``tpusppy/service/``.  :mod:`.canonical` splits model ingest from
wheel execution and fingerprints shape families; :mod:`.server` keeps the
families' captured device programs resident across requests, time-slices
concurrent wheels with preemption at the checkpoint seam, and fuses
same-family tenants into one tenant window (:mod:`.batching`);
:mod:`.journal` is the write-ahead request log that makes the server
crash-safe; :mod:`.net` serves requests over the TCP window runtime with
reconnecting, idempotent clients.
"""

from .canonical import CanonicalModel, content_fingerprint, family_key, ingest
from .journal import RequestJournal
from .server import ServerOverloaded, SolveRequest, SolveServer

__all__ = [
    "CanonicalModel", "RequestJournal", "ServerOverloaded",
    "SolveRequest", "SolveServer",
    "content_fingerprint", "family_key", "ingest",
]
