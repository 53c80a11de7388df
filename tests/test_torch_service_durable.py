"""Durable serving in the port (tpusppy_torch.service) on the CPU: the
write-ahead journal (its file format the reference's: a journal the
reference's RequestJournal wrote replays in the port into the same
records, and back), write-ahead and idempotent submits, overload, restart
recovery (submission order, cold restarts, unrecoverable obligations),
shutdown-park-recover-complete with PHIterLimit total across the restart
and bounds monotone, the serving fault hooks, the frontend's undelivered
responses, and the no-GPU rule.  The port's metrics are never reset:
counts are read as window deltas.
"""

import dataclasses
import time

import pytest
import torch

from tpusppy.service import journal as JJ
from tpusppy_torch.obs import metrics
from tpusppy_torch.resilience import checkpoint as ck
from tpusppy_torch.resilience import faults
from tpusppy_torch.service import (RequestJournal, ServerOverloaded,
                                   SolveRequest, SolveServer)
from tpusppy_torch.service import journal as J

torch.set_num_threads(1)


def _req(rid, n=3, seed=0, iters=80, deadline=None, **opts):
    return SolveRequest(model="farmer", num_scens=n, request_id=rid,
                        creator_kwargs={"seedoffset": seed},
                        deadline_secs=deadline,
                        options=dict({"PHIterLimit": iters, "device": "cpu",
                                      "in_wheel_bounds": True}, **opts))


def _write_journal(mod, path):
    """The same events through ``mod``'s RequestJournal, a torn tail
    after them."""
    j = mod.RequestJournal(path)
    j.accepted(rid="r1", seq=0, request={"model": "farmer"}, family="f1",
               checkpoint_dir="/x", deadline_at=123.0,
               record={"status": "queued"}, trace_id="tr-1")
    j.transition("r1", "running", {"status": "running", "slices": 1})
    j.accepted(rid="r2", seq=1, request={"model": "uc"}, family="f2",
               checkpoint_dir="/y")
    j.undelivered("r1", {"request_id": "r1", "status": "done"})
    j.undelivered("r9", {"request_id": "r9", "status": "rejected"})
    j.recovery_marker({"pid": 1})
    with open(path, "a") as f:
        f.write('{"ev": "status", "rid": "r1", "sta')
    return j


def test_journal_roundtrip_compaction_and_torn_tail(tmp_path):
    p = str(tmp_path / "j.jsonl")
    with metrics.window() as w:
        j = _write_journal(J, p)
        recs = j.replay()
        assert w.delta("service.journal_torn") == 1
    assert set(recs) == {"r1", "r2", "r9"}
    assert recs["r1"].status == "running"
    assert recs["r1"].record["slices"] == 1
    assert recs["r1"].deadline_at == 123.0 and recs["r1"].trace_id == "tr-1"
    assert recs["r1"].undelivered == {"request_id": "r1", "status": "done"}
    assert recs["r2"].status == "queued" and recs["r2"].seq == 1
    # an undelivered rejection without an accepted line: a finished stub
    assert recs["r9"].finished and not recs["r9"].recoverable
    with metrics.window() as w:
        j.compact(recs.values())
        assert w.delta("service.journal_compactions") == 1
    recs2 = j.replay()
    assert recs2["r1"].status == "running"
    assert recs2["r1"].undelivered is not None
    assert recs2["r2"].request == {"model": "uc"}
    assert j.compact_keep(lambda r: r.rid == "r2") == 1
    assert set(j.replay()) == {"r2"}
    assert J.replay(str(tmp_path / "nope.jsonl")) == {}
    # the memoized fold follows the file
    assert set(j.replay_cached()) == {"r2"}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_files_replay_the_same_in_both_packages(tmp_path, writer):
    p = str(tmp_path / "j.jsonl")
    _write_journal(JJ if writer == "reference" else J, p)
    ours, ref = J.replay(p), JJ.replay(p)
    assert set(ours) == set(ref)
    for rid in ref:
        assert dataclasses.asdict(ours[rid]) == dataclasses.asdict(ref[rid])
    # a compaction by one package replays the same in the other
    (J if writer == "reference" else JJ).RequestJournal(p).compact(
        (ours if writer == "reference" else ref).values())
    ours, ref = J.replay(p), JJ.replay(p)
    assert {k: dataclasses.asdict(v) for k, v in ours.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.items()}


def test_submit_write_ahead_idempotent_and_overload(tmp_path):
    srv = SolveServer(work_dir=str(tmp_path), _start_executor=False,
                      max_queue=2)
    with metrics.window() as w:
        assert srv.submit(_req("req-a")) == "req-a"
        jr = srv.journal.replay()["req-a"]
        assert jr.status == "queued" and jr.recoverable
        assert jr.request["creator_kwargs"]["seedoffset"] == 0
        assert srv.submit(_req("req-a", seed=999)) == "req-a"
        assert w.delta("service.duplicate_submits") == 1
        assert len(srv._runq) == 1
        srv.submit(_req("req-b", deadline_secs=60))
        assert srv._tenants["req-b"].deadline_at is not None
        assert srv.journal.replay()["req-b"].deadline_at is not None
        with pytest.raises(ServerOverloaded):
            srv.submit(_req("req-c"))
        assert w.delta("service.rejected_overload") == 1
    assert "req-c" not in srv.journal.replay()


def test_recovery_requeues_in_order_cold_and_unrecoverable(tmp_path):
    work = str(tmp_path)
    srv = SolveServer(work_dir=work, _start_executor=False)
    for rid, seed in (("req-1", 0), ("req-2", 7), ("req-3", 0)):
        srv.submit(_req(rid, seed=seed))
    t1 = srv._tenants["req-1"]
    srv.journal.transition("req-1", "running",
                           dict(t1.record, status="running", slices=1,
                                iters=9, ttfi_s=1.5))
    srv.journal.accepted(rid="req-x", seq=99, request={},
                         family="", checkpoint_dir="", recoverable=False)
    del srv                                   # the crash: no shutdown
    with metrics.window() as w:
        srv2 = SolveServer.recover_from(work, _start_executor=False)
        assert w.delta("service.recovered") == 3
        assert w.delta("service.recovered_cold") == 1
    assert [t.id for t in srv2._runq] == ["req-1", "req-2", "req-3"]
    t1 = srv2._tenants["req-1"]
    assert t1.record["recovered"] == "cold"
    assert t1.slices == 0 and t1.record["iters"] == 0
    assert t1.record["ttfi_s"] is None
    assert srv2._tenants["req-2"].record["recovered"] == "requeued"
    assert all(t.canonical is not None for t in srv2._runq)
    assert srv2._seq == 100
    tx = srv2._tenants["req-x"]
    assert tx.status == "failed" and tx.done.is_set()
    assert tx.record["error_code"] == "unrecoverable"
    with pytest.raises(KeyError):
        srv2.result("req-nope", timeout=0.1)


def test_shutdown_park_recover_complete_warm(tmp_path):
    work = str(tmp_path)
    limit = 60
    with SolveServer(work_dir=work, quantum_secs=600.0,
                     linger_secs=0.0) as srv:
        rid = srv.submit(_req("req-r", iters=limit, rel_gap=1e-12))
        t = srv._tenants[rid]
        deadline = time.monotonic() + 240
        while t.record["ttfi_s"] is None and time.monotonic() < deadline:
            time.sleep(0.05)
        assert t.record["ttfi_s"] is not None
        srv.shutdown(wait=False)
        assert t.status == "parked", t.status
        qw1 = t.record["queue_wait_s"]
        park_iter = t.record["iters"]
        park_outer, park_inner = t.record["outer"], t.record["inner"]
    assert park_iter < limit
    assert ck.latest_iteration(t.dir) is not None
    srv2 = SolveServer.recover_from(work, quantum_secs=600.0,
                                    linger_secs=0.0)
    try:
        rec = srv2.result("req-r", timeout=240)
        assert rec["status"] == "done" and rec["recovered"] == "warm"
        assert rec["slices"] >= 2 and rec["preemptions"] >= 1
        assert rec["iters"] == limit          # PHIterLimit is the total
        assert not rec["certified"]
        assert rec["bounds_monotone"]
        assert rec["outer"] >= park_outer - 1e-9
        assert rec["inner"] <= park_inner + 1e-9
        assert rec["queue_wait_s"] == pytest.approx(qw1, abs=1e-9)
        assert srv2.submit(_req("req-r")) == "req-r"
        # a follower of the completed family starts warm
        rec2 = srv2.result(srv2.submit(_req("req-w", seed=31)), timeout=240)
        assert rec2["status"] == "done" and rec2["certified"]
        assert rec2["warm_hit"] and rec2["aot_misses"] == 0
    finally:
        srv2.shutdown()


def test_deadline_parks_and_fails_uncertified(tmp_path):
    with SolveServer(work_dir=str(tmp_path), quantum_secs=600.0,
                     linger_secs=0.0) as srv:
        with metrics.window() as w:
            rid = srv.submit(_req("req-d", iters=100000, rel_gap=1e-12,
                                  deadline=4.0))
            rec = srv.result(rid, timeout=240)
            assert w.delta("service.deadline_failed") == 1
        assert rec["status"] == "failed" and rec["error_code"] == "deadline"
        assert not rec["certified"] and rec["iters"] > 0
        assert ck.latest_iteration(srv._tenants[rid].dir) is not None


def test_serving_fault_hooks():
    killed = []
    orig = faults._SELF_KILL
    faults._SELF_KILL = lambda: killed.append(True)
    try:
        faults.on_server_slice(5)
        faults.on_client_op(1)
        faults.on_ingest()
        assert not killed
        with faults.inject(faults.FaultPlan(kill_server_after_slices=2,
                                            drop_client={1: 1},
                                            stall_ingest=0.05)) as stats:
            faults.on_server_slice(1)
            assert not killed
            faults.on_server_slice(2)
            assert killed and stats["server_kills"] == 1
            with pytest.raises(faults.InjectedFault):
                faults.on_client_op(1)
            faults.on_client_op(1)
            assert stats["client_drops"] == 1
            t0 = time.monotonic()
            faults.on_ingest()
            assert time.monotonic() - t0 >= 0.05
            assert stats["ingest_stalls"] == 1
    finally:
        faults._SELF_KILL = orig


def test_answer_failure_journals_undelivered(tmp_path, monkeypatch):
    from tpusppy_torch.service.net import TcpServiceFrontend

    srv = SolveServer(work_dir=str(tmp_path), _start_executor=False)
    srv.submit(_req("req-u"))
    front = TcpServiceFrontend(srv, slots=1)
    try:
        def boom(values):
            raise RuntimeError("TCP window service connection lost")
        monkeypatch.setattr(front.fabric.to_spoke[1], "put", boom)
        payload = {"request_id": "req-u", "status": "done", "rel_gap": 1e-4}
        with metrics.window() as w:
            front._answer(1, payload)
            assert w.delta("service.undelivered_journaled") == 1
        assert srv.journal.replay()["req-u"].undelivered == payload
        assert srv._journal_record("req-u") == payload
    finally:
        front.close()


def test_submit_without_a_gpu_raises_unless_cpu_asked(tmp_path,
                                                      monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    srv = SolveServer(work_dir=str(tmp_path), _start_executor=False)
    req = _req("req-g")
    req.options.pop("device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        srv.submit(req)
    assert "req-g" not in srv.journal.replay()
    assert srv.submit(_req("req-c")) == "req-c"
