"""Deterministic fault injection: dead spokes, stale write-ids, dropped
TCP reads, dead controllers, fabric partitions, slow collectives.

A copy of ``tpusppy/resilience/faults.py``.  Recovery paths that only
real outages exercise rot unseen, so this harness injects the failures
the resilience layer handles at deterministic points (payload counts,
read counts, iteration numbers), and tests prove the recovery instead of
hoping for it::

    plan = FaultPlan(kill_spoke={"LagrangianOuterBound": 2})
    with faults.inject(plan):
        WheelSpinner(hub, spokes).spin()
    assert faults.injected_counts()["spoke_kills"] == 1

The hooks sit on hot paths (mailbox gets, spoke polls) and cost one
module-attribute check when disarmed (``_PLAN is None``).  Here the
callers are :meth:`..cylinders.spoke.Spoke.spoke_from_hub`
(:func:`on_spoke_payload`) and :meth:`..cylinders.spcommunicator.
Mailbox.get` (:func:`on_mailbox_get`); the TCP, controller, server,
client, ingest and collective hooks are ported with the module and have
no caller until the window services, the distributed wheel and the
service tier are (ROADMAP Queue 1 item 7).  Injection is process-local.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
import threading
import time

from ..obs import metrics as _metrics

KILL_ID = -1


def _self_sigkill():          # module hook so unit tests can observe the
    os.kill(os.getpid(), signal.SIGKILL)    # decision without dying


_SELF_KILL = _self_sigkill


class InjectedFault(RuntimeError):
    """Base class of every injected failure."""


class SpokeKilled(InjectedFault):
    """Raised inside a spoke's main loop to simulate its death."""


@dataclasses.dataclass
class FaultPlan:
    """What to break, and exactly when.

    kill_spoke: {spoke key: k} — raise :class:`SpokeKilled` inside the
      spoke when it receives its k-th FRESH hub payload.  Keys are strata
      ranks (int) or spoke class names (str).
    stale_mailbox: {mailbox name: n} — the next ``n`` reads of that
      mailbox report write-id 0 (as if no Put ever landed), simulating a
      stale window generation.  The kill sentinel (-1) is never masked —
      it is terminal by protocol, and masking it would turn a bounded
      test into a hang.
    drop_tcp: {mailbox name or "*": n} — the next ``n`` TCP window ops on
      that box raise a transient connection-lost error (consumed by the
      bounded retry/reconnect path of the TCP window service).
    delay_reads: {mailbox name or "*": secs} — sleep before each read
      (slow-network emulation; bounded by the caller's own timeouts).
    kill_controller: {process index (int) or "*": iteration} — SIGKILL
      THIS process (for real — no cleanup, no atexit) the moment the
      distributed wheel reaches that iteration, via the
      ``on_controller_iter`` hook in ``dist_wheel``.  The deterministic
      sibling of an external SIGKILL; drives the elastic detection and
      re-mesh path of a distributed wheel.
    partition_tcp: {mailbox/channel name or "*": True} — EVERY op on
      that channel fails with connection-lost from now on (a network
      partition, not a transient blip): the retry budget exhausts and
      the error propagates, which is how a wedged-but-reachable peer
      looks to the liveness protocol.
    delay_collectives: secs — sleep before each watchdog-guarded mesh
      collective (slow-fabric emulation; a delay under
      the mesh timeout must not trip the watchdog, over it must).
    kill_server_after_slices: k — SIGKILL THIS process (for real) the
      moment the solve server finishes its k-th scheduler slice, via the
      ``on_server_slice`` hook in ``service/server.py``.  The kill lands
      MID-TRANSITION: the slice's wheel has torn down (its terminal
      checkpoint is banked) but the park/completion has NOT been
      journaled, the window the restart-recovery path must handle.
    drop_client: {slot (int) or "*": n} — the next ``n`` SolveClient ops
      on that request slot raise a transient connection-lost error,
      consumed by the client's bounded reconnect-with-backoff path;
      exhausting it raises the typed ``ServerLost``.
    stall_ingest: secs — sleep inside ``SolveServer.submit`` before
      ingest (a slow/stuck canonicalization: admission control and the
      shutdown-race path must stay correct while ingest crawls).
    """

    kill_spoke: dict = dataclasses.field(default_factory=dict)
    stale_mailbox: dict = dataclasses.field(default_factory=dict)
    drop_tcp: dict = dataclasses.field(default_factory=dict)
    delay_reads: dict = dataclasses.field(default_factory=dict)
    kill_controller: dict = dataclasses.field(default_factory=dict)
    partition_tcp: dict = dataclasses.field(default_factory=dict)
    delay_collectives: float = 0.0
    kill_server_after_slices: int = 0
    drop_client: dict = dataclasses.field(default_factory=dict)
    stall_ingest: float = 0.0


_PLAN: FaultPlan | None = None
_LOCK = threading.Lock()
_STATS: dict = {}


def _record(kind: str):
    with _LOCK:
        _STATS[kind] = _STATS.get(kind, 0) + 1
    _metrics.inc(f"faults.{kind}")


def injected_counts() -> dict:
    with _LOCK:
        return dict(_STATS)


def arm(plan: FaultPlan):
    global _PLAN
    with _LOCK:
        _STATS.clear()
    # remaining-budget counters live on a working copy so a plan object
    # can be reused across tests without carrying decremented state
    plan = dataclasses.replace(
        plan, stale_mailbox=dict(plan.stale_mailbox),
        drop_tcp=dict(plan.drop_tcp),
        partition_tcp=dict(plan.partition_tcp),
        drop_client=dict(plan.drop_client))
    _PLAN = plan
    return plan


def disarm():
    global _PLAN
    _PLAN = None


@contextlib.contextmanager
def inject(plan: FaultPlan):
    """Arm ``plan`` for the duration; yields the live stats dict view
    (read it after the block via :func:`injected_counts` for a copy)."""
    arm(plan)
    try:
        yield _STATS
    finally:
        disarm()


# ---------------------------------------------------------------------------
# Hooks (called from instrumented seams; no-ops unless armed)
# ---------------------------------------------------------------------------
def on_spoke_payload(spoke):
    """Called by ``Spoke.spoke_from_hub`` on every FRESH payload; raises
    :class:`SpokeKilled` when the plan schedules this spoke's death at
    the current payload count."""
    plan = _PLAN
    if plan is None or not plan.kill_spoke:
        return
    k = plan.kill_spoke.get(spoke.strata_rank)
    if k is None:
        k = plan.kill_spoke.get(type(spoke).__name__)
    if k is not None and spoke._recv_count >= int(k):
        _record("spoke_kills")
        raise SpokeKilled(
            f"injected death of {type(spoke).__name__} "
            f"(strata {spoke.strata_rank}) at payload {spoke._recv_count}")


def on_mailbox_get(name: str, write_id: int) -> int:
    """Called by ``Mailbox.get``: may return a STALE write-id (0) for the
    next budgeted reads of ``name``.  Kill sentinels pass through."""
    plan = _PLAN
    if plan is None or not plan.stale_mailbox or write_id == KILL_ID:
        return write_id
    with _LOCK:
        left = plan.stale_mailbox.get(name, 0)
        if left <= 0:
            return write_id
        plan.stale_mailbox[name] = left - 1
    _record("stale_reads")
    return 0


def _budget(table: dict, name: str) -> bool:
    with _LOCK:
        for key in (name, "*"):
            left = table.get(key, 0)
            if left > 0:
                table[key] = left - 1
                return True
    return False


def on_tcp_io(name: str):
    """Called inside each TCP window op attempt: sleeps (delay plan) and
    raises a transient connection-lost error (drop plan) or a PERMANENT
    one (partition plan) so the bounded retry/backoff/reconnect path —
    and its exhaustion — is exercised on demand."""
    plan = _PLAN
    if plan is None:
        return
    if plan.delay_reads:
        secs = plan.delay_reads.get(name, plan.delay_reads.get("*"))
        if secs:
            _record("delayed_reads")
            time.sleep(float(secs))
    if plan.partition_tcp and (plan.partition_tcp.get(name)
                               or plan.partition_tcp.get("*")):
        # a partition is not a budgeted blip: every op fails until the
        # plan is disarmed — retries exhaust, the error propagates, and
        # the peer looks DEAD to liveness without any process dying
        _record("partitioned_ops")
        raise InjectedFault(
            f"TCP window service connection lost (injected partition, "
            f"box {name})")
    if plan.drop_tcp and _budget(plan.drop_tcp, name):
        _record("tcp_drops")
        raise InjectedFault(
            f"TCP window service connection lost (injected, box {name})")


def on_controller_iter(process_index: int, iteration: int):
    """Called by the distributed wheel loop at the top of every
    iteration: SIGKILLs THIS controller process when the plan schedules
    its death at (or before) ``iteration`` — a real uncatchable kill,
    exactly what the elastic recovery path must survive on the OTHER
    controllers."""
    plan = _PLAN
    if plan is None or not plan.kill_controller:
        return
    k = plan.kill_controller.get(int(process_index),
                                 plan.kill_controller.get("*"))
    if k is not None and iteration >= int(k):
        _record("controller_kills")
        _SELF_KILL()


def on_server_slice(slices_done: int):
    """Called by the solve server after each scheduler slice's wheel
    tears down (checkpoint banked, status transition NOT yet journaled):
    SIGKILLs this process when the plan schedules the server's death at
    (or before) the ``slices_done``-th slice — the deterministic sibling
    of the serving-chaos smoke's external SIGKILL."""
    plan = _PLAN
    if plan is None or not plan.kill_server_after_slices:
        return
    if int(slices_done) >= int(plan.kill_server_after_slices):
        _record("server_kills")
        _SELF_KILL()


def on_client_op(slot):
    """Called inside each SolveClient transport op: raises a budgeted
    transient connection-lost error (consumed by the client's bounded
    reconnect-with-backoff; exhaustion surfaces as the typed
    ``ServerLost``)."""
    plan = _PLAN
    if plan is None or not plan.drop_client:
        return
    if _budget(plan.drop_client, int(slot) if str(slot).isdigit()
               else slot):
        _record("client_drops")
        raise InjectedFault(
            f"TCP window service connection lost (injected client drop, "
            f"slot {slot})")


def on_ingest():
    """Called by ``SolveServer.submit`` before canonicalization: stalls
    the (unlocked) ingest for the configured seconds so the admission /
    shutdown races around a slow ingest are drivable on demand."""
    plan = _PLAN
    if plan is None or not plan.stall_ingest:
        return
    _record("ingest_stalls")
    time.sleep(float(plan.stall_ingest))


def on_collective(what: str = ""):
    """Called before each watchdog-guarded mesh collective: injects the
    configured delay (slow-fabric emulation — under the mesh timeout it
    must be absorbed, over it the watchdog must fire)."""
    plan = _PLAN
    if plan is None or not plan.delay_collectives:
        return
    _record("delayed_collectives")
    time.sleep(float(plan.delay_collectives))


def active() -> bool:
    return _PLAN is not None
