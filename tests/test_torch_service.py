"""The port's service tier (tpusppy_torch.service) on the CPU: the shape
family algebra, the content fingerprint and the TCP payload codec against
the reference's, the canonical model bound by SPBase, and the solve server:
a warm repeat that replays the family's programs (no capture, the same
program objects), preemption with park and resume and bounds monotone,
concurrent time-slicing over two families, the three-cylinder wheel, and a
request over TCP.  The servers run hub-only certified wheels
(``in_wheel_bounds``) in float64, farmer S=3 and S=4.
"""

import numpy as np
import pytest
import torch

from tpusppy.models import farmer as jfarmer
from tpusppy.service import canonical as jcanonical
from tpusppy.service import net as jnet
from tpusppy_torch.models import farmer, uc_lite
from tpusppy_torch.obs import metrics
from tpusppy_torch.service import (SolveRequest, SolveServer, family_key,
                                   ingest)
from tpusppy_torch.service import canonical, net
from tpusppy_torch.solvers import device_loop

torch.set_num_threads(1)

EF3 = -108390.0          # farmer 3-scenario EF optimum


def _canon(n, seedoffset=0, crops=1, options=None, **kw):
    return ingest(
        farmer.scenario_names_creator(n), farmer.scenario_creator,
        dict({"num_scens": n, "seedoffset": seedoffset,
              "crops_multiplier": crops}, **kw),
        options=options or {})


# ---- canonicalization -----------------------------------------------------------
def test_family_key_isomorphic_models_match():
    a = _canon(6, seedoffset=0)
    b = _canon(6, seedoffset=1234)
    assert a.family == b.family
    assert a.family_digest == b.family_digest
    assert a.fingerprint != b.fingerprint
    assert not np.array_equal(a.batch.A, b.batch.A)


def test_family_key_differs_on_shape_settings_int_pattern_device():
    base = _canon(6)
    assert _canon(4).family != base.family
    assert _canon(6, crops=2).family != base.family
    uc = ingest(uc_lite.scenario_names_creator(6), uc_lite.scenario_creator,
                {"num_scens": 6, "num_gens": 2, "horizon": 4,
                 "relax_integers": True})
    assert uc.family != base.family
    assert _canon(6, options={"solver_options": {"eps_abs": 1e-9}}
                  ).family != base.family
    assert _canon(6, use_integer=True).family != base.family
    assert _canon(6, options={"in_wheel_bounds": True}).family \
        != base.family
    assert _canon(6, options={"device": "cpu"}).family != base.family
    # the key's prefix is the shape-family tuple
    S, n = base.batch.c.shape
    m = base.batch.cl.shape[1]
    expect = canonical.shape_family_parts(
        S, n, m, settings=canonical.make_admm_settings({}),
        a_kind=base.batch.A.ndim)
    assert base.family[:len(expect)] == expect
    assert family_key(base.batch, settings=expect[3]) == base.family


@pytest.mark.parametrize("n,kw", [(3, {}), (6, {"seedoffset": 7,
                                                "crops_multiplier": 2}),
                                  (5, {"use_integer": True})])
def test_content_fingerprint_and_digests_match_reference(n, kw):
    ours = _canon(n, **kw)
    ref = jcanonical.ingest(
        jfarmer.scenario_names_creator(n), jfarmer.scenario_creator,
        dict({"num_scens": n}, **kw), options={})
    assert ours.fingerprint == ref.fingerprint
    from tpusppy.solvers import aot as jaot

    for a in (ours.batch.is_int, ours.batch.tree.nonant_indices):
        assert canonical.array_digest(a) == jaot.array_digest(a)
    assert canonical.shape_family_parts(n, 4, 5) == \
        jaot.shape_family_parts(n, 4, 5)


def test_canonical_model_binds_spbase():
    from tpusppy_torch.spopt import SPOpt

    c = _canon(3)
    opt = SPOpt({"canonical_model": c, "device": "cpu",
                 "solver_options": {"max_iter": 50}},
                farmer.scenario_names_creator(3), farmer.scenario_creator,
                scenario_creator_kwargs={"num_scens": 3})
    assert opt.batch is c.batch and opt._batch_shared
    assert opt.all_scenario_names == c.names
    opt._ensure_private_batch()
    assert opt.batch is not c.batch


# ---- the TCP payload codec --------------------------------------------------------
@pytest.mark.parametrize("obj", [
    {"model": "farmer", "num_scens": 7, "options": {"rel_gap": 1e-3},
     "creator_kwargs": {"seedoffset": 3}},
    {"op": "fetch", "request_id": "req-é中", "x": [1.5, None]},
    {"s": "y" * 1001}])
def test_payload_codec_is_the_reference_byte_for_byte(obj):
    ours = net.encode_payload(obj, 256)
    ref = jnet.encode_payload(obj, 256)
    assert ours.tobytes() == ref.tobytes()
    assert net.decode_payload(ours) == obj == jnet.decode_payload(ref)
    with pytest.raises(ValueError):
        net.encode_payload({"x": "y" * 4096}, 16)
    assert net.decode_payload(np.zeros(16)) is None


# ---- the server ---------------------------------------------------------------------
def _req(n=3, seed=0, iters=80, **opts):
    return SolveRequest(model="farmer", num_scens=n,
                        creator_kwargs={"seedoffset": seed},
                        options=dict({"PHIterLimit": iters, "device": "cpu",
                                      "in_wheel_bounds": True}, **opts))


def _hub_programs(srv, family):
    """The program objects the family's hub owner holds."""
    tok = srv._owner(family, "hub")
    return {id(v) for v in device_loop._cache.get(tok, {}).values()}


def test_warm_repeat_replays_the_family_programs(tmp_path):
    with SolveServer(work_dir=str(tmp_path), quantum_secs=60.0,
                     linger_secs=0.0) as srv:
        r1 = srv.result(srv.submit(_req(seed=0)), timeout=300)
        assert r1["status"] == "done" and r1["certified"]
        assert not r1["warm_hit"]
        fam = r1["family"]
        progs = _hub_programs(srv, fam)
        assert progs                      # the window program is held
        with metrics.window() as w:
            r2 = srv.result(srv.submit(_req(seed=4321)), timeout=300)
            assert w.delta("device_loop.captures") == 0
        assert r2["status"] == "done" and r2["certified"]
        assert r2["warm_hit"] and r2["family"] == fam
        assert r2["aot_misses"] == 0 and r2["compile_s"] == 0.0
        # the same program objects served the second request
        assert _hub_programs(srv, fam) == progs
        r3 = srv.result(srv.submit(_req(n=4, iters=8)), timeout=300)
        assert r3["status"] == "done" and not r3["warm_hit"]
        assert r3["family"] != fam
        s = srv.slo_summary()
        assert s["completed"] == 3 and s["families"] == 2
        assert s["p50_latency_s"] is not None
        srv.retire_family(fam)
        assert not _hub_programs(srv, fam)
    # a shut-down server holds no device state
    assert not any(isinstance(k, tuple) and k[:2] == ("service", id(srv))
                   for k in device_loop._cache)


def test_preempt_park_resume_bounds_monotone(tmp_path):
    with SolveServer(work_dir=str(tmp_path), quantum_secs=600.0,
                     linger_secs=0.0) as srv:
        req = _req(iters=80)
        srv.preempt(req.request_id)           # parks at its first boundary
        rid = srv.submit(req)
        rec = srv.result(rid, timeout=300)
        assert rec["status"] == "done" and rec["certified"]
        assert rec["preemptions"] >= 1 and rec["slices"] >= 2
        assert rec["bounds_monotone"]
        # sound bounds: the inner is an ADMM evaluation (eps 1e-4 apart)
        assert rec["outer"] <= EF3 + 1e-6 * abs(EF3)
        assert rec["inner"] >= EF3 - 1e-4 * abs(EF3)
        assert rec["inner"] == pytest.approx(EF3, rel=2e-3)


def test_cold_wheel_parks_after_its_first_window(monkeypatch):
    """A park request on a wheel that has captured graphs (its family cold
    on the card) lands only after the wheel's first megastep window, so
    the family's frozen path is captured before the park; a wheel that
    captured nothing parks at its first boundary.  Each sweep loop counts
    one capture here (the CPU captures none)."""
    from tpusppy_torch.cylinders import PHHub
    from tpusppy_torch.opt.ph import PH
    from tpusppy_torch.spin_the_wheel import WheelSpinner

    def spin():
        return WheelSpinner({
            "hub_class": PHHub, "opt_class": PH,
            "opt_kwargs": {
                "options": {"defaultPHrho": 1.0, "PHIterLimit": 30,
                            "convthresh": -1.0, "device": "cpu"},
                "all_scenario_names": farmer.scenario_names_creator(3),
                "scenario_creator": farmer.scenario_creator,
                "scenario_creator_kwargs": {"num_scens": 3}},
            "hub_kwargs": {"options": {"preempt_check": lambda: True}}},
            []).spin()

    warm = spin()
    assert warm.spcomm.preempted and warm.opt._iter == 1
    assert getattr(warm.opt, "_windows_run", 0) == 0
    run = device_loop.run

    def capturing_run(*args, **kwargs):
        metrics.inc("device_loop.captures")
        return run(*args, **kwargs)

    monkeypatch.setattr(device_loop, "run", capturing_run)
    cold = spin()
    assert cold.spcomm.preempted and cold.opt._windows_run == 1
    assert 2 < cold.opt._iter < 30


def test_concurrent_time_slicing_over_two_families(tmp_path):
    with SolveServer(work_dir=str(tmp_path), quantum_secs=4.0,
                     linger_secs=0.0) as srv:
        with metrics.window() as w:
            rids = [srv.submit(r) for r in (
                _req(n=3, seed=0), _req(n=4, seed=0),
                _req(n=3, seed=77), _req(n=4, seed=1))]
            recs = [srv.result(r, timeout=600) for r in rids]
            assert w.delta("service.preemptions") >= 1
        for rec in recs:
            assert rec["status"] == "done" and rec["certified"], rec
            assert rec["bounds_monotone"], rec
            assert rec["outer"] <= rec["inner"] + 1e-6
        assert recs[0]["inner"] == pytest.approx(EF3, rel=2e-3)
        assert recs[2]["inner"] == pytest.approx(EF3, rel=2e-3)
        assert recs[2]["warm_hit"] and recs[3]["warm_hit"]
        assert sum(r["preemptions"] for r in recs) >= 1
        assert sum(r["slices"] for r in recs) > 4
        assert srv.slo_summary()["warm_hit_rate"] == 0.5


def test_three_cylinder_slice_bounds_are_sound(tmp_path):
    """Without in-wheel bounds a slice is the PH hub with the Lagrangian
    and XhatShuffle spokes, each cylinder on its family's owner token."""
    with SolveServer(work_dir=str(tmp_path), quantum_secs=60.0,
                     linger_secs=1.0) as srv:
        rec = srv.result(srv.submit(_req(iters=3, in_wheel_bounds=False)),
                         timeout=600)
        assert rec["status"] == "done", rec
        assert np.isfinite(rec["outer"]) and np.isfinite(rec["inner"])
        assert rec["outer"] <= EF3 + 1e-6 * abs(EF3)
        assert rec["inner"] >= EF3 - 1e-4 * abs(EF3)
        assert set(srv._owners[rec["family"]]) == {"hub", "lagrangian",
                                                   "xhat"}


def test_tcp_request_roundtrip(tmp_path):
    from tpusppy_torch.service.net import SolveClient, TcpServiceFrontend

    with SolveServer(work_dir=str(tmp_path), quantum_secs=60.0,
                     linger_secs=0.0) as srv:
        front = TcpServiceFrontend(srv, slots=2)
        try:
            cli = SolveClient("127.0.0.1", front.port, front.secret, slot=1)
            rec = cli.solve({"model": "farmer", "num_scens": 3,
                             "options": {"PHIterLimit": 80,
                                         "device": "cpu",
                                         "in_wheel_bounds": True}},
                            timeout=300)
            assert rec["status"] == "done" and rec["certified"]
            assert rec["rel_gap"] <= 1e-3 + 1e-12
            cli.close()
        finally:
            front.close()
