"""The port's request telemetry (tpusppy_torch.obs.telemetry) against the
reference's (tpusppy.obs.telemetry): the Prometheus text of the same
counters, gauges and histograms and the per-tenant gauge lines of the same
status snapshot are equal byte for byte; the request scopes and tenant
events on the port's trace ring, the clock stamps and the handshake
offset, the progress bus, the JSON scrub and the scrape endpoint; and a
served request's status and progress over the TCP front end.
"""

import json
import urllib.request

import pytest
import torch

from tpusppy.obs import metrics as jmetrics
from tpusppy.obs import telemetry as jtel
from tpusppy_torch.obs import metrics, telemetry, trace
from tpusppy_torch.service import SolveServer

torch.set_num_threads(1)


def _feed(mod):
    """The same metrics into a fresh registry of ``mod``."""
    reg = mod.Registry()
    reg.counter("service.requests").inc(3)
    reg.counter("batching.joins").inc(4)
    reg.counter("dispatch.flops").inc(1.5e12)
    reg.counter("odd-name/with spaces").inc(1)
    reg.gauge("batching.slots").set(3)
    reg.gauge("heartbeat.hub").set(1234.5)
    reg.gauge("never.set")
    h = reg.histogram("service.wall_s")
    for v in (0.5, 2.0, 1.25, float("inf"), 7.0):
        h.add(v)
    reg.histogram("service.empty_s")
    big = reg.histogram("service.ttfi_s")
    for i in range(700):                       # past the reservoir
        big.add((i * 37 % 101) / 7.0)
    return reg


SNAPSHOT = {
    "queue_depth": 2, "requests_live": 3, "batch_slots": 3,
    "batch_slots_occupied": None,
    "requests": {
        "req-b": {"status": "running", "model": "farmer", "qos": "batch",
                  "rel_gap": 0.0123, "outer": -108500.0, "inner": None,
                  "iters": 16, "deadline_headroom_s": 12.5,
                  "attributed_flops": 2.5e9, "mfu_pct": None},
        "req-a": {"status": "done", "model": 'uc"lite\\', "qos": "",
                  "rel_gap": float("inf"), "outer": float("-inf"),
                  "inner": float("nan"), "iters": 0}},
}


def test_prometheus_text_is_the_reference_byte_for_byte():
    ours = telemetry.prometheus_text(_feed(metrics))
    ref = jtel.prometheus_text(_feed(jmetrics))
    assert ours == ref
    assert "tpusppy_service_wall_s_count 5" in ours
    assert 'tpusppy_service_ttfi_s{quantile="0.95"}' in ours
    extra = ["# TYPE tpusppy_x gauge", "tpusppy_x 1"]
    assert telemetry.prometheus_text(_feed(metrics), extra) == \
        jtel.prometheus_text(_feed(jmetrics), extra)


def test_tenant_gauge_lines_are_the_reference():
    ours = telemetry.tenant_gauge_lines(SNAPSHOT)
    assert ours == jtel.tenant_gauge_lines(SNAPSHOT)
    assert any(ln.startswith("tpusppy_tenant_rel_gap{request_id=\"req-b\"")
               for ln in ours)
    for v in (float("inf"), -0.0, 1e-300, float("nan"), "x", None, 7):
        assert telemetry._prom_val(v) == jtel._prom_val(v)
    assert telemetry._prom_name("9a.b-c") == jtel._prom_name("9a.b-c")


def test_request_scope_and_tenant_events_on_the_trace_ring():
    assert telemetry.mint_trace_id().startswith("tr-")
    assert telemetry.req_track("r1") == "req:r1"
    assert telemetry.current_context() is None
    trace.enable()
    try:
        n0 = len(trace.events())
        with telemetry.request_scope("tr-x", "r1"):
            assert telemetry.current_context() == ("tr-x", "r1")
            telemetry.tenant_instant(None, None, "admitted", seq=3)
            telemetry.tenant_counter(None, None, "rel_gap", 0.5)
            with telemetry.tenant_span(None, None, "slice", slice=1):
                pass
        telemetry.tenant_instant(None, None, "dropped")   # no scope
        telemetry.record_clock_sync("scheduler")
        telemetry.record_clock_handshake("client", 0.25, 0.01)
        evs = trace.events()[n0:]
    finally:
        trace.disable()
    req = [e for e in evs if e.track == "req:r1"]
    assert [e.kind for e in req] == ["instant", "counter", "span"]
    assert all(e.payload["trace_id"] == "tr-x" and
               e.payload["request_id"] == "r1" for e in req)
    assert req[1].payload["value"] == 0.5
    clock = [e for e in evs if e.track == "clock"]
    assert [e.name for e in clock] == ["clock_sync", "clock_handshake"]
    assert telemetry.current_context() is None
    # off: nothing recorded, the shared no-op span handed out
    assert telemetry.tenant_span("r", "t", "x") is trace._NULL


def test_clock_stamp_and_handshake_offset():
    st = telemetry.clock_stamp()
    assert set(st) == {"wall", "perf"}
    for args in ((10.0, 12.0, 11.5), (0.0, 0.2, -3.0)):
        assert telemetry.handshake_offset(*args) == \
            jtel.handshake_offset(*args)
    assert telemetry.handshake_offset(10.0, 12.0, 11.5) == 0.5


def test_progress_bus_cursor_loss_and_done_latch():
    bus = telemetry.ProgressBus(maxlen=3)
    assert bus.poll("r") == ([], 0, 0, False)
    for i in range(5):
        assert bus.emit("r", "gap", i=i) == i
    evs, cur, lost, done = bus.poll("r", 0)
    assert [e["i"] for e in evs] == [2, 3, 4] and cur == 5 and lost == 2
    assert not done and bus.known("r")
    bus.mark_done("r")
    evs, cur, lost, done = bus.poll("r", cur)
    assert evs == [] and cur == 5 and lost == 0 and done
    assert bus.is_done("r")
    bus.drop("r")
    assert not bus.known("r")


def test_json_safe_and_scrape_endpoint():
    assert telemetry.json_safe({"a": float("inf"), "b": [1, float("nan")],
                                "c": (None, True)}) == \
        jtel.json_safe({"a": float("inf"), "b": [1, float("nan")],
                        "c": (None, True)})
    reg = _feed(metrics)
    scrape = telemetry.ScrapeServer(status_fn=lambda: SNAPSHOT,
                                    registry=reg)
    try:
        base = f"http://127.0.0.1:{scrape.port}"
        body = urllib.request.urlopen(base + "/metrics",
                                      timeout=10).read().decode()
        assert body == telemetry.prometheus_text(
            reg, telemetry.tenant_gauge_lines(SNAPSHOT))
        status = json.loads(urllib.request.urlopen(
            base + "/status", timeout=10).read())
        assert status["queue_depth"] == 2
        assert status["requests"]["req-a"]["rel_gap"] == "inf"
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(base + "/nope", timeout=10)
    finally:
        scrape.close()


def test_tcp_status_watch_and_scrape_of_a_served_request(tmp_path):
    from tpusppy_torch.service.net import SolveClient, TcpServiceFrontend

    with SolveServer(work_dir=str(tmp_path), quantum_secs=60.0,
                     linger_secs=0.0) as srv:
        front = TcpServiceFrontend(srv, slots=2, scrape_port=0)
        try:
            cli = SolveClient("127.0.0.1", front.port, front.secret, slot=1)
            rid = cli.submit({"model": "farmer", "num_scens": 3,
                              "options": {"PHIterLimit": 80,
                                          "device": "cpu",
                                          "in_wheel_bounds": True}})
            kinds = []
            for ev in cli.watch(rid, timeout=300):
                kinds.append(ev["kind"])
            assert kinds[0] == "queued" and "done" in kinds
            assert "gap" in kinds
            rec = cli.wait_result(rid, timeout=300)
            assert rec["status"] == "done" and rec["certified"]
            st = cli.status(rid)
            assert st["done"] and st["record"]["request_id"] == rid
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{front.scrape_port}/metrics",
                timeout=10).read().decode()
            assert "tpusppy_service_completed_total" in body
            assert f'request_id="{rid}"' in body
            cli.close()
        finally:
            front.close()
