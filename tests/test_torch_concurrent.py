"""Concurrent cylinders in one process (tpusppy_torch): the launch counts,
the host-sync trackers, the captured sweep loops and the kernel operands are
safe for several threads, each on a CUDA stream of its own.

Threads run ``solve_batch`` and PH iterations at once on farmer batches of
the same shape with different objectives (and a thread that allocates and
solves batched linear systems meanwhile, so that on the card captures
overlap both); in f64 every result equals, bitwise, the same call run
alone.  A PH hub running megastep windows (captured window steps, frozen
solves carrying the window's stop word) beside a spoke thread's frozen
solves of the same shape is bitwise its solo run too, and on the card its
windows agree with the legacy loop to 1e-9.  The CPU cases hold the Python
side (counts, trackers, caches); the ``cuda`` case holds the streams and the
CUDA-graph captures and skips without a card.  This file imports no JAX.
"""

import contextlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpusppy_torch.models import farmer
from tpusppy_torch.opt.ph import PH
from tpusppy_torch.solvers import admm, cuda_kernels, device_loop, hostsync
from tpusppy_torch.spbase import build_batch

torch.set_num_threads(1)

S = 4
WORKERS = 3
KW = {"num_scens": S}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _stress(fn, workers=16):
    """Run ``fn(i)`` on ``workers`` threads at a 1 us switch interval;
    returns what each returned, in order."""
    out = [None] * workers
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=lambda i=i: out.__setitem__(i, fn(i)))
              for i in range(workers)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    return out


def test_counts_lose_no_update_and_each_thread_sees_its_own():
    cuda_kernels.reset_counts()
    n = 2000

    def work(i):
        base = cuda_kernels.counts(local=True)
        for _ in range(n):
            cuda_kernels.bump("plain_calls", "fused_sweeps")
            cuda_kernels.add_counts({("launches", "fused_sweeps"): i})
        now = cuda_kernels.counts(local=True)
        return {k: now[k] - base[k] for k in now if now[k] != base[k]}

    views = _stress(work)
    assert cuda_kernels.plain_calls["fused_sweeps"] == 16 * n
    assert cuda_kernels.launches["fused_sweeps"] == n * sum(range(16))
    for i, v in enumerate(views):
        want = {("plain_calls", "fused_sweeps"): n}
        if i:
            want[("launches", "fused_sweeps")] = n * i
        assert v == want


def test_sync_trackers_count_their_own_thread_only():
    def work(i):
        with hostsync.track() as tr:
            for _ in range(i + 1):
                hostsync.fetch(torch.zeros(2))
        return tr.count

    assert _stress(work) == [i + 1 for i in range(16)]


def test_operands_are_kept_per_owner():
    A, B = torch.ones(2, 2), torch.zeros(2, 2)
    made = []

    def make(tag):
        made.append(tag)
        return tag

    with cuda_kernels.owned_by("a"):
        assert cuda_kernels._cached("t", (A,), 0, lambda: make("a")) == "a"
    with cuda_kernels.owned_by("b"):
        assert cuda_kernels._cached("t", (A,), 0, lambda: make("b")) == "b"
    with cuda_kernels.owned_by("a"):
        # owner a's operand survived owner b's
        assert cuda_kernels._cached("t", (A,), 0, lambda: make("a2")) == "a"
        assert cuda_kernels._cached("t", (B,), 0, lambda: make("a3")) == "a3"
    assert made == ["a", "b", "a3"]
    device_loop.release("a")
    with cuda_kernels.owned_by("a"):
        assert cuda_kernels._cached("t", (B,), 0, lambda: make("a4")) == "a4"
    device_loop.release("a")
    device_loop.release("b")


class _Pool:
    """A stand-in for PyTorch's stream pool: ``n`` streams handed out in
    turn."""

    def __init__(self, n):
        self.n, self.i = n, 0

    def __call__(self):
        self.i += 1
        return type("S", (), {"cuda_stream": self.i % self.n})()


def test_claimed_streams_are_never_handed_out_twice():
    pool = _Pool(4)
    got = [device_loop.claim_stream("cuda", pool) for _ in range(4)]
    assert len({s.cuda_stream for s in got}) == 4
    with pytest.raises(RuntimeError, match="no free CUDA stream"):
        device_loop.claim_stream("cuda", pool)
    device_loop.free_stream(got[2])
    again = device_loop.claim_stream("cuda", pool)
    assert again.cuda_stream == got[2].cuda_stream
    for s in got:
        device_loop.free_stream(s)
    assert not device_loop._claimed


def test_a_solve_on_the_card_waits_for_a_capture_elsewhere():
    """``outside_capture`` on a CUDA device waits while another thread
    holds the capture lock (as a capture does); off the card it does not
    wait."""
    held, done = threading.Event(), threading.Event()
    release = threading.Event()

    def capture():
        with device_loop._capture_lock:
            held.set()
            release.wait(timeout=60)

    def solve():
        with device_loop.outside_capture(torch.device("cuda")):
            done.set()

    t = threading.Thread(target=capture)
    t.start()
    held.wait(timeout=60)
    with device_loop.outside_capture(torch.device("cpu")):
        pass
    u = threading.Thread(target=solve)
    u.start()
    assert not done.wait(timeout=0.2)
    release.set()
    assert done.wait(timeout=60)
    t.join(timeout=60)
    u.join(timeout=60)


def _problems(device):
    """Per worker: (batch arrays with a perturbed c, PH options): farmer
    batches of one shape, objectives differing by worker."""
    batch, _ = build_batch(farmer.scenario_names_creator(S),
                           farmer.scenario_creator, KW)
    rng = np.random.default_rng(7)
    out = []
    for w in range(WORKERS):
        c = batch.c * (1.0 + 0.05 * rng.standard_normal(batch.c.shape))
        out.append(((c, batch.q2, batch.A, batch.cl, batch.cu, batch.lb,
                     batch.ub), {"defaultPHrho": 1.0 + w, "PHIterLimit": 2,
                                 "convthresh": -1.0, "device": device}))
    return out


def _work(args, options, device, owner):
    """One worker's calls: an adaptive batched solve and a PH run of
    Iter0 and two iterations.  Returns every result as numpy."""
    torch.set_num_threads(1)
    with cuda_kernels.owned_by(owner):
        sol = admm.solve_batch(*args, settings=admm.ADMMSettings(),
                               device=device)
        ph = PH(options, farmer.scenario_names_creator(S),
                farmer.scenario_creator, scenario_creator_kwargs=KW)
        conv, eobj, tbound = ph.ph_main()
    out = [np.asarray(t.cpu()) for t in (sol.x, sol.y, sol.pri_res)]
    return out + [ph.W, ph.local_x, np.array([conv, eobj, tbound])]


def _disturb_until(stop, device):
    """Allocate and free, and solve a batched linear system (a call that
    fails on the card during another thread's capture unless it waits for
    the capture), on a stream of its own until ``stop`` is set, every 0.2
    ms (a busy loop would hold the interpreter lock)."""
    stream = (device_loop.claim_stream(torch.device(device))
              if device != "cpu" else None)
    M = torch.eye(72, dtype=torch.float64, device=device).repeat(64, 1, 1)
    rhs = torch.ones(64, 72, dtype=torch.float64, device=device)
    n = 0
    with (torch.cuda.stream(stream) if stream is not None
          else contextlib.nullcontext()):
        while not stop.is_set():
            t = torch.empty(1 << (10 + n % 8), device=device)
            t.fill_(1.0)
            del t
            admm._solve_linear(M, rhs)
            n += 1
            time.sleep(2e-4)
    if stream is not None:
        stream.synchronize()
        device_loop.free_stream(stream)
    return n


def _run_concurrent(device, rounds):
    probs = _problems(device)
    solo = []
    for w, (args, options) in enumerate(probs):
        solo.append(_work(args, options, device, ("solo", w)))
        device_loop.release(("solo", w))
    for r in range(rounds):
        results = [None] * WORKERS
        views = [None] * WORKERS
        errors = []
        gate = threading.Barrier(WORKERS)

        def worker(w, args, options):
            stream = (device_loop.claim_stream(torch.device(device))
                      if device != "cpu" else None)
            try:
                gate.wait(timeout=60)
                before = cuda_kernels.counts(local=True)
                if stream is None:
                    results[w] = _work(args, options, device, (r, w))
                else:
                    with torch.cuda.stream(stream):
                        results[w] = _work(args, options, device, (r, w))
                    stream.synchronize()
                    device_loop.free_stream(stream)
                after = cuda_kernels.counts(local=True)
                views[w] = {k: after[k] - before[k] for k in after
                            if after[k] != before[k]}
            except Exception as e:          # reported below
                errors.append((w, e))

        stop = threading.Event()
        alloc = threading.Thread(target=_disturb_until, args=(stop, device))
        alloc.start()
        ts = [threading.Thread(target=worker, args=(w, *probs[w]))
              for w in range(WORKERS)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=600)
        stop.set()
        alloc.join(timeout=60)
        assert not any(t.is_alive() for t in ts + [alloc])
        assert not errors, errors
        for w in range(WORKERS):
            device_loop.release((r, w))
            assert (r, w) not in device_loop._cache
            for a, b in zip(results[w], solo[w]):
                assert np.array_equal(a, b), f"round {r} worker {w}"
        yield views


def test_concurrent_solves_match_solo_on_the_cpu():
    for views in _run_concurrent("cpu", rounds=1):
        for v in views:
            assert v.get(("plain_calls", "fused_sweeps"), 0) > 0
            assert all(k[0] == "plain_calls" for k in v)


@pytest.mark.cuda
def test_concurrent_solves_match_solo_on_the_card():
    _cuda()
    for views in _run_concurrent("cuda", rounds=3):
        # each thread's view holds its own launches: fused_sweeps only
        for v in views:
            assert v.get(("launches", "fused_sweeps"), 0) > 0
            assert {k for k in v if k[0] in ("launches", "plain_calls")} \
                == {("launches", "fused_sweeps")}


#: Solver settings of the window cases: fewer restarts and sweeps.
QUICK = {"restarts": 2, "max_iter": 400}


def _hub(device):
    """A PH hub whose iterations 2-4 run as a megastep window (solo or
    beside the spoke): W, x, conv and eobj, and what its windows
    launched.  Short solves (:data:`QUICK`) keep the CPU run brief."""
    ph = PH({"defaultPHrho": 1.0, "PHIterLimit": 4, "convthresh": -1.0,
             "device": device, "solver_refresh_every": 4,
             "solver_options": QUICK},
            farmer.scenario_names_creator(S), farmer.scenario_creator,
            scenario_creator_kwargs=KW)
    with cuda_kernels.owned_by(ph):
        _, eobj, _ = ph.ph_main()
    device_loop.release(ph)
    launched = sum(ph.window_launches.values())
    return [ph.W, ph.local_x, np.array([ph.conv, eobj])], launched


def _spoke(device, owner):
    """A spoke's work: a factored solve, then frozen solves on its factors
    for objectives that drift as PH's do."""
    (args, _), = _problems(device)[:1]
    st = admm.ADMMSettings(**QUICK)
    with cuda_kernels.owned_by(owner):
        sol, fac = admm.solve_batch_factored(*args, settings=st,
                                             device=device)
        out = [np.asarray(sol.x.cpu())]
        warm = sol.raw
        for k in range(2):
            c = args[0] * (1.0 + 0.01 * (k + 1))
            sol = admm.solve_batch_frozen(c, *args[1:], fac, settings=st,
                                          warm=warm, device=device)
            warm = sol.raw
            out.append(np.asarray(sol.x.cpu()))
    device_loop.release(owner)
    return out


def _hub_beside_spoke(device):
    solo_hub, launched = _hub(device)
    solo_spoke = _spoke(device, "spoke-solo")
    results, errors = {}, []

    def run(name, fn):
        stream = (device_loop.claim_stream(torch.device(device))
                  if device != "cpu" else None)
        try:
            torch.set_num_threads(1)
            with (torch.cuda.stream(stream) if stream is not None
                  else contextlib.nullcontext()):
                results[name] = fn()
            if stream is not None:
                stream.synchronize()
                device_loop.free_stream(stream)
        except Exception as e:          # reported below
            errors.append((name, e))

    ts = [threading.Thread(target=run, args=("hub", lambda: _hub(device))),
          threading.Thread(target=run,
                           args=("spoke", lambda: _spoke(device, "spoke")))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in ts)
    assert not errors, errors
    hub, launched_c = results["hub"]
    assert launched > 0 and launched_c == launched
    for a, b in zip(hub, solo_hub):
        assert np.array_equal(a, b)
    for a, b in zip(results["spoke"], solo_spoke):
        assert np.array_equal(a, b)


def test_windows_beside_a_spoke_match_solo_on_the_cpu():
    _hub_beside_spoke("cpu")


@pytest.mark.cuda
def test_windows_beside_a_spoke_match_solo_on_the_card():
    _cuda()
    _hub_beside_spoke("cuda")


@pytest.mark.cuda
def test_windows_match_the_legacy_loop_on_the_card():
    """f64 on the card: the hub's windows against the legacy loop, W and
    xbars to 1e-9 (the objective is assembled on the device in one and on
    the host in the other)."""
    _cuda()
    runs = []
    for mega in (0, 1):
        ph = PH({"defaultPHrho": 1.0, "PHIterLimit": 12,
                 "convthresh": -1.0, "device": "cuda",
                 "solver_refresh_every": 4,
                 "solver_options": {"megastep": mega}},
                farmer.scenario_names_creator(S), farmer.scenario_creator,
                scenario_creator_kwargs=KW)
        ph.ph_main()
        runs.append(ph)
    mega, legacy = runs
    assert sum(mega.window_launches.values()) > 0
    assert not legacy.window_launches
    for name in ("W", "xbars"):
        a, b = getattr(mega, name), getattr(legacy, name)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-9 * max(1.0, np.abs(b).max()))
