#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpusppy_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--phases kernels,golden,loop,farmer,uc_lite,uc,
                                    megastep,precision,wheel,bundles,
                                    integer,resilience,service]

Run from the root of a checkout on a machine with one CUDA device and the
CUDA toolkit (nvcc).  Phases, each printing a line:

1. card: the device, with ``nvidia-smi``'s name and power limit;
2. build: every hand-written kernel from ``tpusppy_torch/csrc``, one
   ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card in
   f32 (also against the f64 plain version on the same inputs: the kernel
   may lie no further from it than twice the plain f32 does) and f64, with
   CUDA-event times and the card's bound for the same work, each mode
   checked to have run: ``fused_sweeps`` (n_sweeps=4, n_refine=2) at
   every shape its paths give it (DENSE_SHAPES: farmer-1000's main path,
   resident with two buffers; bundled farmer-1000's and netdes-1000's
   buckets; sizes S=3; sslp 10 x 50 S=50; farmer at crops_multiplier=12;
   a tall shape whose work vectors go to device memory; rows longer than
   a stage) in the mode its
   layout picks on this card, each line with the mode, cluster size,
   kernel, bound, re-stream floor and plain times and the kernel-to-plain
   ratio, and where one scenario buffer and a cluster of 2 both take the
   shape the other of the two timed on the same inputs; and at "default"
   at the paths' shapes (below),
   ``fused_sweeps_shared`` at uc_lite's defaults (m=242, n=132,
   n_sweeps=4, n_refine=2, n_extra=2, with has=1 and has=0) at S=1000
   (the main path: more tiles than the card holds clusters at once, its
   streamed mode) and at S=128 (a cluster for every tile: its
   cluster-resident mode), each also timed in the other mode, which must
   be the slower, and at a wide A (S=16, m=242, n=2000, has=1; its
   streamed mode), ``fused_sweeps_sparse`` at the full-width uc's
   (S=1000, m=4626, n=2928, kr=61, kc=10, n_sweeps=4, n_refine=1,
   n_extra=2, has=1 and has=0) in both its modes: with a dense K^-1, and
   with the structured operand (the block/Woodbury factors of the check's
   A, 30 blocks of 96 variables, 48 of one, 184 wide rows), which the uc
   paths run;
4. goldens in f64 through the kernels: farmer S=3 PH (EF optimum -108390),
   uc_lite S=3 (3 generators, 6 hours) and full-width uc S=10 (30
   generators, 24 hours) PH, each against its HiGHS EF; the uc one also
   on the tensor path, its eobj held to the kernel run's after every
   iteration, and as the hub of a wheel whose Lagrangian spoke bounds from
   donor duals alone: that outer bound at most the EF + 1e-6 |EF|;
5. loop: the sweep loop on the card (CUDA-graph replays of L blocks, the
   host reading one stop flag a replay) held against L=1 for each engine:
   an adaptive and a frozen solve at each golden's shape in f64 (the same
   sweep counts, solutions within 1e-12 relative), and a frozen solve of
   each main path in f32 (the same sweep counts; the largest difference
   printed), also at L=4; every solve's kernel launches equal the blocks
   its replays ran plus the warm-up blocks of its captures, and a frozen
   solve runs at most 2L - 1 blocks past its last sweeping block.  Then
   factors swapped between two frozen solves on the same captured graphs
   (farmer-1000, uc_lite-1000 in the streamed mode, uc_lite at S=128 in
   the cluster-resident mode, uc-1000 with its structured operand): the
   second solve captures nothing and matches a fresh capture.  Then
   three chained ``fused_sweeps`` launches captured in a CUDA graph at a
   bucket shape (f32 one buffer, f64 a cluster of 2) and at sslp's (f64,
   the streamed mode), the replay's state equal to direct launches' to
   the last bit;
6. main paths at the default solver options, so that PH runs its frozen
   iterations in megastep windows (N = 15: the refresh every 16
   iterations runs in the legacy body), each with the launch counts and
   host syncs read around
   exactly that run, then the first iterations of the same PH on the
   batched tensor path (eobj held to the kernel run's after as many
   iterations, with both runs' eobj and solve-loop decisions printed side
   by side) and, below S=1000 UC, the HiGHS EF of the same scenarios:
   farmer-1000 crops_multiplier=4 PH in f32 (100 iterations, 10 on the
   tensor path) through ``fused_sweeps`` (the dense per-scenario engine),
   uc_lite-1000 at its defaults (rho 500, 50 iterations, 3 on the tensor
   path) through ``fused_sweeps_shared`` (the shared-A engine), and
   uc-1000 at full width (rho 500 and bench_uc.py's solver settings, 15
   iterations, 1 on the tensor path; its EF is out of HiGHS's reach, so
   the S=10 golden holds the EF check) through
   ``fused_sweeps_sparse`` (the sparse and structured-KKT engine); each
   prints its kernel's launches by mode: farmer must launch only the
   resident mode, uc_lite-1000 only the streamed mode, the uc paths only
   the structured mode, and keep no dense (n, n) K^-1 in their
   factors; each prints its PH rate, flag reads (``admm.loop_checks``) and
   host syncs per PH iteration, graph replays and the capture seconds.
   Each run prints first whether it runs windows or the legacy loop;
7. megastep: each main path's windows against the same PH in the legacy
   loop (``solver_options={"megastep": 1}``): farmer-1000 and
   uc_lite-1000 eobj after as many iterations (30, 25) within 1e-4,
   uc-1000 (5) within 1e-3 (f32 rounding alone parts two uc-1000 runs by
   1.2e-4), the uc S=10 f64 golden after each of 5 iterations within
   1e-7; every run's windows, window and legacy iterations adding up to
   the iterations run, its kernel launched from inside the windows, host
   syncs an iteration by kind (flag reads, packed fetches, other) and PH
   rate under both protocols.  Then two hub-only wheels (a PHHub with
   ``in_wheel_bounds`` and no spoke): farmer-1000 (its hub in f64 at eps
   1e-5, since the host rescue runs HiGHS at its default tolerances as the
   reference's does and an f32 consensus leaves the land rows a few 1e-6
   over; 50 iterations at most, rel_gap 1e-3), whose outer bound is at
   most the EF + 1e-6 |EF|,
   inner within 1e-2 of the EF and above it less 1e-4, outer <= inner,
   with a bound pass run and no spoke thread, and the uc S=10 f64 golden,
   its outer bound at most its EF + 1e-6 |EF|; each prints which source
   supplied each bound;
8. precision: the main paths with their frozen sweeps lowered, in the
   legacy loop (the guard's full-precision re-run is the legacy frozen
   path's), against the megastep phase's legacy runs;
9. wheel: the farmer-1000 wheel through ``WheelSpinner.spin()`` (the main
   path's PH as the hub, 30 iterations at most, rel_gap 1e-3, abs_gap
   1, with the Lagrangian, XhatShuffle and XhatXbar spokes, each cylinder
   on a CUDA stream of its own): the certified outer bound at most the
   HiGHS EF + 1e-6 |EF| and above the hub's trivial bound, the inner
   bound (an f32 objective at a fixed first stage) within 1e-2 of the EF
   and above it less 1e-4, outer <= inner, the first stage within the
   land, every spoke posting a bound, every cylinder launching
   ``fused_sweeps`` and no other sweep kernel (its thread's own counts),
   distinct non-default streams, and no graph captures after the hub's
   halfway iteration; it prints the gap, the hub's PH rate in the wheel
   (its hub runs windows) beside the hub-only wheel's and the farmer
   phase's alone, where and why the hub stopped, and
   each cylinder's launches and host syncs.  Then uc-1000's hub and a
   Lagrangian spoke that bounds from donor duals alone (bench_uc.py's
   full-scale settings, the budget cut to 60 s): a finite outer bound
   above the hub's trivial bound, and at least one donor used;
10. bundles: scenario bundling and shape buckets (the kernels phase holds
   ``fused_sweeps`` at the buckets' shapes; every run here must launch
   the mode its layout picks there and no plain version): bundled
   farmer-1000 crops_multiplier=4
   (``bundles_per_rank`` 300, ``shape_buckets``: 200 bundles of 3
   scenarios and 100 of 4, two buckets) through ``ph_main()`` at the
   farmer phase's f32 settings, 4 iterations, in bucketed windows: the
   two buckets exactly, eobj within 1e-2 of the farmer-1000 EF (bundling
   keeps the EF), the trivial bound at most the EF + 1e-6 |EF|,
   ``fused_sweeps`` launched inside the windows for both buckets and no
   other sweep kernel, eobj within 1e-4 of the same PH in the legacy loop
   after as many iterations, with the PH rate, host syncs by kind,
   refused frozen iterates and launches by mode under both protocols; a
   bundled wheel (that hub, 2 iterations at most, with a Lagrangian and
   an XhatShuffle spoke in f64): outer <= EF + 1e-6 |EF|, inner >= EF -
   1e-4 |EF|, outer <= inner, each spoke posting a bound; two hub-only
   in-wheel wheels on the bucketed bound pass: bundled farmer-1000 (both
   buckets, its hub in f64, 8 iterations): a bound pass inside a window
   with ``fused_sweeps`` launched in it for both buckets, outer <= EF +
   1e-6 |EF|, inner >= EF - 1e-4 |EF|, outer <= inner; bundled netdes-1000
   (10 nodes, ``bundles_per_rank`` 300 with ``shape_buckets``, f64, 4
   iterations, the integer pass, with an XhatShuffle spoke on the bucketed
   integer evaluation): each pass's outer at least its untightened outer,
   outer <= the EF MIP's incumbent (HiGHS alongside; 357.076) and inner >=
   its best bound, outer <= inner, no host escalation raising, no plain
   version, the passes' feasible candidates, fixed slots and launches by
   bucket and evaluation printed; and hydro S=9 in 3 proper bundles in
   f64 (the reference's settings) within 1e-2 of the unbundled HiGHS EF;
11. integer: the integer families in f64 (HiGHS's EF solves in worker
   processes from the start of the bundles phase; the kernels phase holds
   ``fused_sweeps`` at the families' shapes, and each wheel's hub must
   launch the mode its layout picks: resident at netdes', a cluster of 16
   at sizes', the streamed mode at sslp's): the netdes S=3 golden hub-only
   in-wheel integer wheel
   (rho 1, 60 iterations, budget 30 s, rel_gap 0.04: gap <= 0.04, outer
   past the LP EF 376.306 and at most the MIP EF 398.333, feasible hits
   and an escalation); netdes-1000's hub-only integer wheel (outer <=
   inner, outer <= the EF MIP's incumbent and inner >= its best bound,
   HiGHS limited to 120 s; the bound passes' launches by candidate and
   mode, host syncs an iteration by kind); the sizes S=3 golden wheel (PH
   hub 40 iterations at rho 0.01, a Lagrangian and an XhatShuffle spoke
   with 20 dive rounds: outer in [218000, 230000], inner in [220000,
   240000]) and a hub-only sizes wheel (second-stage integers: its inner
   bound from host MIPs, outer <= the EF MIP's incumbent, no fixing); the
   sslp wheel (a Lagrangian spoke lifting every 4th pass, XhatShuffle on
   donor MILPs, XhatXbar on the integer ladder: outer <= inner, outer <=
   the EF MIP's incumbent, each spoke's bound and host MILP seconds).
   Every run launches ``fused_sweeps``; no plain version runs and no host
   escalation raises (``integer.escalation_errors``);
12. resilience, on farmer-1000 crops_multiplier=4 through
   ``fused_sweeps``: (c) a real kill: this script re-run as a child
   process (a private flag; it prints no result line) spins the hub-only
   wheel in f64 checkpointing every iteration, and is SIGKILLed once a
   checkpoint at iteration 15 or later exists; the wheel resumed from the
   newest checkpoint to 45 iterations in all against the same wheel run
   uninterrupted: ``resumed_from`` the checkpoint's iteration, 45
   iterations, captures that fetch nothing (``checkpoint.capture_fetches``
   0), a restore, and the expected objective within 1e-5 of the
   uninterrupted run's; twice: with lean megastep windows
   (``ph_device_state``, a capture at each window boundary after its
   boundary fetch), every capture held against the device state it was
   taken on to 1e-12 and W and xbars printed beside the uninterrupted
   run's, and with a refresh every iteration (``solver_refresh_every`` 1:
   every iterate an adaptive solve to eps, so a checkpoint's missing warm
   duals and factors leave no frozen iterate to part the runs), W and
   xbars within rtol 1e-5, atol 1e-4 of the uninterrupted run; then the
   hub's PH it/s of the uninterrupted 45-iteration wheel with a checkpoint
   every iteration against none, three alternating pairs in each posture
   (full-pack and lean windows); (d) the wheel phase's three cylinders (hub f32, Lagrangian and XhatShuffle in f64) cut at 4
   iterations with checkpoints, resumed to 10, and run uninterrupted:
   bounds monotone across the restart, outer <= EF + 1e-6 |EF|, outer <=
   inner, both rel_gaps; (e) the same wheel with the Lagrangian killed at
   its second payload (``faults.FaultPlan``): the wheel completes, the
   spoke lost with one ``SpokeKilled`` (``supervisor.spokes_lost`` 1), a
   finite inner bound, outer <= inner, ``torch.cuda.synchronize()`` clean,
   and the hub's PH it/s before and after the kill;
13. service: the solve server (``tpusppy_torch.service``) on farmer-1000
   crops_multiplier=4 in f64 (eps 1e-5) through ``fused_sweeps``, each
   part with the counts zeroed before it and read after it (the dense
   kernel only, no plain version): (a) the tenant window (K=3 slots,
   seedoffsets 0, 1000 and 2000, N=15 over two windows, slot 2 a ghost in
   the first) against each slot's solo window: eobj, W and xbars within
   1e-9, the ghost's state unchanged, ``fused_sweeps`` launched for every
   live slot, one packed fetch a window, the tenants' PH it/s against a
   solo window's; (b) ``SolveServer(batch_slots=3, in_wheel_bounds=True)``
   with requests at seedoffsets 0, 1000 and 2000 and a fourth joining
   late: each done, batched, certified at rel_gap 0.05, outer <= inner,
   the seed-0 outer <= EF + 1e-6 |EF| and inner >= EF - 1e-4 |EF|, every
   member after the leader capturing no graph (its record, each member's
   own captures, and the device's count: none after the leader's first
   window, every capture billed to a record), ``batching.joins`` >= 4;
   (c) time-slicing (no batching, quantum 2 s) over the hub, Lagrangian
   and XhatShuffle wheel: farmer-1000 seed 0, farmer-500 seed 0 and
   farmer-1000 seed 77 submitted together, each done with its bounds
   monotone and outer <= inner, at least one preemption and more than 3
   slices, the second farmer-1000 request warm, capturing nothing and
   reaching its first iteration sooner than the first; (b) and (c) print
   the server's SLO summary; (d) ``shutdown(wait=False)`` parks a running
   request once its hub has posted a finite inner bound at iteration 10
   or later, and ``SolveServer.recover_from`` completes it: PHIterLimit
   the total, recovered "warm", both bounds monotone against the finite
   parked ones; (e) a
   ``SolveClient`` solves one request through a ``TcpServiceFrontend``
   and its ``GET /metrics`` answers.

``--phases`` runs a subset; the result lines print only when all ran.
Prints a ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero before
the last line is printed.  Imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet rates (dense, at the 700 W limit): f32 outside the
# tensor cores, f64 on the tensor cores (full IEEE f64; 34 on CUDA cores);
# the lowered modes' bf16 products at the bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
BF16_PEAK_FLOPS = 989e12
#: The card's name and power limit (nvidia-smi), set at the start; every
#: line of the lowered checks and the precision phase carries it.
CARD = ""
EF_GOLDEN = -108390.0
# uc_lite S=3 golden: the repo's own settings (tests/test_models.py)
UC_GOLDEN_OPTIONS = {"defaultPHrho": 10.0, "convthresh": 1e-5}
# uc_lite-1000: rho 500, the repo's unit-commitment PH rho (bench_uc.py).
# At the golden's rho 10 the S=1000 eobj climbs toward the EF far too
# slowly to come within 1e-2 in a depth that fits the time limit.
UC_MAIN_OPTIONS = {"defaultPHrho": 500.0, "convthresh": 1e-5}
# fused_sweeps_sparse in f32 against its plain version at uc-1000's shape
SPARSE_TOL_F32 = 1e-5
# the repo's UC solver settings (bench_uc.py): 200 sweeps a solve, 2
# restarts, one refinement pass, the in-loop plateau exit
UC_SOLVER = {"max_iter": 200, "restarts": 2, "scaling_iters": 6,
             "solve_refine": 1, "sweep_plateau_rtol": 0.05,
             "sweep_plateau_window": 8}
# the full-width uc S=10 golden, 10 PH iterations: rho 10000 brings its
# eobj within 1e-2 of the EF in a few iterations; at the main path's rho 500
# it climbs toward the EF far too slowly for the time limit
UC_FULL_GOLDEN_OPTIONS = {"defaultPHrho": 10000.0, "convthresh": 1e-5}
UC_FULL_GOLDEN_ITERS = 10
# the uc S=10 golden's first 5 iterations also on the tensor path, in f64:
# the same recurrence, so the eobj agrees after every iteration (5e-14 in
# all 10, PERF.md, PR 3)
UC_FULL_TENSOR_ITERS = 5
UC_FULL_F64_TOL = 1e-7


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def cuda_time_ms(fn, reps=30, warmup=5):
    """Device time of one call: median of ``reps`` CUDA-event-timed calls
    after ``warmup`` calls.  Each call is queued behind a spin kernel,
    so the host has enqueued all of its launches before the first event
    fires and the interval holds device work only, not the host's launch
    cost.  The spin lasts four times the longest host time of a warm-up
    call after the first (what enqueueing one call can take), at least 1
    ms and at most 20 ms at the H100's 1.98 GHz.  A call slower than 1/30
    s (the longest warm-up call after the first, synchronised) is timed
    over fewer calls, about a second's worth, and at least 5."""
    import torch

    enqueue = call = 0.0
    for i in range(warmup):
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        if i:
            enqueue = max(enqueue, t1 - t0)
            call = max(call, time.perf_counter() - t0)
    cycles = int(min(max(4.0 * enqueue, 1e-3), 20e-3) * 2e9)
    reps = max(min(reps, 5), min(reps, int(1.0 / max(call, 1e-9))))
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        e0.record()
        fn()
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def sweep_case(S, m, n, dtype, seed=0):
    """Random fused_sweeps inputs on the card with a well-conditioned
    K = A' diag(rho_a) A + sigma I + diag(rho_x) and K^-1 from f64."""
    import torch

    rng = np.random.RandomState(seed)
    sigma = 1e-6
    # entries ~ 1/sqrt(n) and rho_x >= 0.5 keep cond(K) below ~10
    A = rng.randn(S, m, n) / np.sqrt(n)
    rho_a = rng.uniform(0.5, 1.0, size=(S, m))
    rho_x = rng.uniform(0.5, 1.0, size=(S, n))
    K = np.einsum("smn,sm,smk->snk", A, rho_a, A)
    K += sigma * np.eye(n)[None] + rho_x[:, :, None] * np.eye(n)[None]
    Kinv = np.linalg.inv(K)
    cl = -np.abs(rng.randn(S, m)) - 0.5
    cu = np.abs(rng.randn(S, m)) + 0.5
    x = rng.randn(S, n) * 0.1
    arrs = dict(
        q=rng.randn(S, n), A=A, Kinv=Kinv, K=K, cl=cl, cu=cu,
        lb=-2.0 * np.ones((S, n)), ub=2.0 * np.ones((S, n)),
        rho_a=rho_a, rho_x=rho_x, x=x, z=np.clip(rng.randn(S, m), cl, cu),
        zx=np.clip(x, -2.0, 2.0), y=0.1 * rng.randn(S, m),
        yx=0.1 * rng.randn(S, n), Ax=np.einsum("smn,sn->sm", A, x))
    order = ("q", "A", "Kinv", "K", "cl", "cu", "lb", "ub", "rho_a",
             "rho_x", "x", "z", "zx", "y", "yx", "Ax")
    return [torch.as_tensor(arrs[k], dtype=dtype, device="cuda")
            for k in order], sigma


def shared_sweep_case(S, m, n, dtype, has, seed=0):
    """Random fused_sweeps_shared inputs on the card: one A (entries ~
    1/sqrt(n)), rho >= 0.5 so the shared K is well conditioned, gamma in
    [0.6, 1.8], and dq2 <= 0.05, small against gamma K's diagonal, so the
    refinement contracts."""
    import torch

    rng = np.random.RandomState(seed)
    sigma = 1e-6
    A = rng.randn(m, n) / np.sqrt(n)
    rho_a = rng.uniform(0.5, 1.0, size=(1, m))
    rho_x = rng.uniform(0.5, 1.0, size=(1, n))
    K = (A.T * rho_a) @ A + sigma * np.eye(n) + np.diag(rho_x[0])
    Kinv = np.linalg.inv(K)
    cl = -np.abs(rng.randn(S, m)) - 0.5
    cu = np.abs(rng.randn(S, m)) + 0.5
    x = rng.randn(S, n) * 0.1
    arrs = dict(
        q=rng.randn(S, n), A=A, Kinv=Kinv, K=K, cl=cl, cu=cu,
        lb=-2.0 * np.ones((S, n)), ub=2.0 * np.ones((S, n)),
        rho_a=rho_a, rho_x=rho_x,
        dq2=0.05 * rng.uniform(size=(S, n)) * has,
        has=np.full((1, 1), float(has)),
        gamma=rng.uniform(0.6, 1.8, size=(S, 1)), x=x,
        z=np.clip(rng.randn(S, m), cl, cu), zx=np.clip(x, -2.0, 2.0),
        y=0.1 * rng.randn(S, m), yx=0.1 * rng.randn(S, n), Ax=x @ A.T)
    order = ("q", "A", "Kinv", "K", "cl", "cu", "lb", "ub", "rho_a",
             "rho_x", "dq2", "has", "gamma", "x", "z", "zx", "y", "yx", "Ax")
    return [torch.as_tensor(arrs[k], dtype=dtype, device="cuda")
            for k in order], sigma


def hold_kernel(label, kern, plain, args, flops, tol, dtype, ref=None,
                flops_lo=0, ref_factor=2.0, ref_slack=1e-7, exact=None,
                exact_gate=False, reps=30):
    """One kernel call against its plain version on the same inputs, then
    both timed; returns the errors, times and bound.  ``ref`` (f32 cases)
    gives the f64 plain version on the same f32-rounded inputs: the kernel
    must lie no further from it than ``ref_factor`` times the plain f32's
    distance (plus ``ref_slack``).  ``exact`` (a lowered mode) gives the
    plain version at "highest" on the same inputs, the control: with
    ``exact_gate`` the kernel must lie at most LOW_CTRL_RATIO times as far
    from the lowered plain version as from the exact one (``rms_dist``).
    ``args`` are the tensors the kernel reads (each counted once);
    ``flops`` run at the working type's peak, ``flops_lo`` (a lowered
    mode's bf16 products) at the bf16 tensor-core peak.  ``reps``: the
    timed calls of each (``cuda_time_ms``)."""
    import torch

    from tpusppy_torch.solvers.structured_kkt import KernelWoodbury

    def nbytes(a):
        if isinstance(a, KernelWoodbury):
            pat = a.pattern
            if a.lo:
                # a lowered mode reads the bf16 copies, and A xt the exact
                # wide rows
                return sum(nbytes(t) for t in (
                    *a.lo, a.wvals, pat.pos, pat.order, pat.binfo_t,
                    pat.items[4], pat.wcols, pat.wpos, pat.wtrows, pat.ncols,
                    a.nvals, pat.wrows))
            return sum(nbytes(t) for t in (
                a.mats, a.dinv, a.wvals, a.wtvals, pat.pos, pat.order,
                pat.binfo_t, pat.items[a.mats.element_size()],
                pat.wcols, pat.wpos, pat.wtrows, pat.ncols, a.nvals,
                pat.wrows))
        return a.numel() * a.element_size()

    got, want = kern(), plain()
    torch.cuda.synchronize()
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel_err = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    vs64 = ""
    if ref is not None:
        r64 = ref()
        k64, p64 = max_err(got, r64), max_err(want, r64)
        vs64 = f" kernel-f64={k64:.3e} plain-f64={p64:.3e}"
        del r64
    ctrl = ""
    if exact is not None:
        ex = exact()
        d_low, d_exact = rms_dist(got, want), rms_dist(got, ex)
        ctrl = (f" control: rms to lowered {d_low:.3e}, to exact "
                f"{d_exact:.3e} (ratio {d_low / max(d_exact, 1e-300):.3f}, "
                + (f"gate {LOW_CTRL_RATIO:.3f})" if exact_gate
                   else "not gated)"))
        del ex
    ms, plain_ms = cuda_time_ms(kern, reps), cuda_time_ms(plain, reps)
    # bound: each input read once, each output written once, over the HBM
    # rate; the arithmetic (a multiply-add counts 2) over the peak rate
    nbytes = sum(nbytes(a) for a in args) + sum(nbytes(o) for o in got)
    name = str(dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / PEAK_FLOPS[name] + flops_lo / BF16_PEAK_FLOPS) * 1e3
    res = dict(abs_err=abs_err, rel_err=rel_err, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops, flops_lo=flops_lo)
    print(f"kernel {label} {name}: max_rel_err={rel_err:.3e} "
          f"(tol {tol:.0e}) max_abs_err={abs_err:.3e}{vs64}{ctrl} "
          f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
          f"bound_ms={res['bound_ms']:.5f} "
          f"({res['bound_by']}: {nbytes} B, {flops} flop"
          + (f" + {flops_lo} bf16 flop; {CARD}" if flops_lo else "") + ")",
          flush=True)
    check(finite, f"{label} {name}: non-finite output")
    check(rel_err < tol, f"{label} {name}: kernel disagrees with plain "
          f"version ({rel_err:.3e} >= {tol:.0e})")
    if ref is not None:
        check(k64 <= ref_factor * p64 + ref_slack, f"{label} {name}: kernel "
              f"lies {k64:.3e} from the f64 plain version, the plain f32 "
              f"{p64:.3e}")
    if exact is not None:
        res.update(ctrl_lowered=d_low, ctrl_exact=d_exact)
        if exact_gate:
            check(d_low <= LOW_CTRL_RATIO * d_exact, f"{label} {name}: the "
                  f"kernel lies {d_low:.3e} from the lowered plain version "
                  f"and {d_exact:.3e} from the exact one: it did not run "
                  "the mode")
    return res


def uc_sparse_pattern():
    """The full-width uc shared A (30 generators, 24 hours): the sparsity
    pattern the main path's kernel runs on."""
    from tpusppy_torch.models import uc

    return uc.scenario_creator("Scenario0", relax_integers=True).A != 0


def sparse_sweep_case(pattern, S, dtype, has, seed=0, structured=False):
    """fused_sweeps_sparse inputs on the card on the uc A's sparsity
    pattern, with values drawn so that the check is well conditioned:
    entries of magnitude in [0.5, 1] / sqrt(kr kc) (so A'RA has norm at
    most 1), rho in [0.5, 1] (cond(K) below 4), gamma in [0.6, 1.8], and
    dq2 at most half of gamma K's smallest eigenvalue, so the refinement
    contracts.  The dense operand: K^-1 formed in f64 (torch.linalg.inv, a
    yardstick the port never calls) and rounded to ``dtype``.  With
    ``structured``, the structured operand instead: the A's block/Woodbury
    split (``detect_structure`` on uc's pattern) factored by
    ``factor_structured`` in ``dtype`` and laid out for the kernel.
    Returns (args, A, sigma) with args in the wrapper's order."""
    import torch

    from tpusppy_torch.solvers.sparse import SparseA
    from tpusppy_torch.solvers.structured_kkt import (factor_structured,
                                                      woodbury_layout)

    rng = np.random.RandomState(seed)
    m, n = pattern.shape
    kr, kc = int(pattern.sum(1).max()), int(pattern.sum(0).max())
    sigma = 1e-6
    A = np.where(pattern, rng.uniform(0.5, 1.0, (m, n))
                 * rng.choice([-1.0, 1.0], (m, n)), 0.0) / np.sqrt(kr * kc)
    sp = SparseA.from_dense(A, torch.float64, "cuda", structure=structured)
    rho_a = rng.uniform(0.5, 1.0, size=m)
    rho_x = rng.uniform(0.5, 1.0, size=n)
    t64 = lambda v: torch.as_tensor(v, dtype=torch.float64, device="cuda")
    if structured:
        spd = sp.astype(dtype)
        Kinv = woodbury_layout(factor_structured(
            spd, spd.structure, t64(rho_x).to(dtype), t64(rho_a).to(dtype),
            sigma), spd)
    else:
        Ad = sp.todense()
        K = Ad.T @ (t64(rho_a)[:, None] * Ad) + torch.diag(t64(rho_x
                                                              + sigma))
        Kinv = torch.linalg.inv(K)
    cl = -np.abs(rng.randn(S, m)) - 0.5
    cu = np.abs(rng.randn(S, m)) + 0.5
    x = rng.randn(S, n) * 0.1
    gamma = rng.uniform(0.6, 1.8, size=(S, 1))
    lo = rho_x.min() + sigma
    arrs = dict(
        q=rng.randn(S, n), Kinv=Kinv, diagK=(rho_x + sigma)[None, :],
        cl=cl, cu=cu, lb=-2.0 * np.ones((S, n)), ub=2.0 * np.ones((S, n)),
        rho_a=rho_a[None, :], rho_x=rho_x[None, :],
        dq2=0.5 * gamma * lo * rng.uniform(size=(S, n)) * has,
        has=np.full((1, 1), float(has)), gamma=gamma, x=x,
        z=np.clip(rng.randn(S, m), cl, cu), zx=np.clip(x, -2.0, 2.0),
        y=0.1 * rng.randn(S, m), yx=0.1 * rng.randn(S, n),
        Ax=sp.matvec(t64(x)))
    ell = [sp.ell.rowcols, sp.ell.rowvals.to(dtype), sp.ell.colrows,
           sp.ell.colvals.to(dtype)]
    order = ("q", "Kinv", "diagK", "cl", "cu", "lb", "ub", "rho_a", "rho_x",
             "dq2", "has", "gamma", "x", "z", "zx", "y", "yx", "Ax")
    vals = [v if k == "Kinv" and structured else
            torch.as_tensor(v, device="cuda").to(dtype).contiguous()
            for k, v in ((k, arrs[k]) for k in order)]
    return [vals[0]] + ell + vals[1:], sp, sigma


def max_err(got, want):
    """Largest difference relative to the largest entry of ``want``
    (floored at 1), over the six outputs."""
    return max(float((g.double() - w.double()).abs().max()
                     / max(float(w.double().abs().max()), 1.0))
               for g, w in zip(got, want))


def rms_dist(got, want):
    """Largest over the outputs of ||got - want|| / ||want|| (Frobenius):
    the bulk of a difference, which a few operands rounded the other way
    (``max_err``'s largest entries) hardly move."""
    return max(float((g.double() - w.double()).norm()
                     / max(float(w.double().norm()), 1e-300))
               for g, w in zip(got, want))


def f64_ref(plain, args, dtype):
    """For an f32 case, the f64 plain version on the same f32-rounded
    inputs (``hold_kernel``'s ``ref``); None in f64."""
    import torch

    if dtype != torch.float32:
        return None
    args64 = [a.double() for a in args]
    return lambda: plain(*args64)


def hold_mode(cuda_kernels, modes, mode, label, *hold_args, **hold_kw):
    """``hold_kernel`` for one mode of a kernel: the kernel's launches in
    the check must all have run ``mode`` (``modes`` is the kernel's launch
    counts by mode)."""
    before = dict(modes)
    res = hold_kernel(f"{label} [{mode}]", *hold_args, **hold_kw)
    ran = {k: modes[k] - before[k] for k in modes}
    check(ran[mode] > 0 and sum(ran.values()) == ran[mode],
          f"{label}: launched modes {ran}, wanted only {mode}")
    return res


#: The shapes the paths give ``fused_sweeps`` (label: S, m, n): farmer-1000's
#: main path, bundled farmer-1000's and bundled netdes-1000's buckets
#: (BUNDLE_BUCKETS, NETDES_BUCKETS), the integer families' (INT_SHAPES:
#: netdes-1000, sizes S=3 and sslp 10 x 50 S=50), farmer at
#: crops_multiplier=12, a tall shape whose work vectors do not fit shared
#: memory in f64 (the streamed mode's device-memory scratch), and rows
#: longer than a stage in f64 (the streamed mode's segments).
DENSE_SHAPES = {"farmer-1000": (1000, 28, 44),
                "bucket (200, 84, 108)": (200, 84, 108),
                "bucket (100, 112, 140)": (100, 112, 140),
                "bucket (200, 105, 100)": (200, 105, 100),
                "bucket (100, 140, 125)": (100, 140, 125),
                "netdes-1000": (1000, 35, 50),
                "sizes S=3": (3, 62, 150), "sslp 10x50 S=50": (50, 60, 520),
                "farmer cm=12": (64, 84, 132), "tall": (4, 60000, 44),
                "wide rows": (2, 10, 2500)}
#: Timed calls of each fused_sweeps check and its plain version: fewer than
#: the other kernels' 30, for the run's time limit
DENSE_REPS = 10


def dense_case(S, m, n, dtype):
    """``sweep_case``, and for a tall shape (m >= 100 n) bounds of 0.05 on
    z and zx: there K^-1 is small, z and zx never meet the case's wider
    bounds, and y and yx would stay at rounding noise, where a relative
    error means nothing."""
    args, sigma = sweep_case(S, m, n, dtype)
    if m >= 100 * n:
        for i, b in ((4, -0.05), (5, 0.05), (6, -0.05), (7, 0.05)):
            args[i].fill_(b)
    return args, sigma


def dense_layout_of(cuda_kernels, S, m, n, dtype, lowered=False):
    """The layout ``fused_sweeps`` launches for S scenarios of (m, n) on
    this card."""
    import torch

    return cuda_kernels.dense_launch_layout(
        S, torch.empty((1, m, n), dtype=dtype, device="cuda"), lowered)


def dense_modes_of(cuda_kernels, batch, dtype):
    """The modes ``fused_sweeps`` may launch in for this batch's shapes (a
    bucketed batch's buckets) at any scenario count: the layout's pick at
    one scenario and at a million."""
    b = batch
    shapes = ([(sub.num_rows, sub.num_vars) for _, sub in b.buckets]
              if getattr(b, "buckets", None) else [(b.num_rows, b.num_vars)])
    return {dense_layout_of(cuda_kernels, S, m, n, dtype)["mode"]
            for m, n in shapes for S in (1, 10 ** 6)}


def ran_dense_modes(launched):
    """The ``fused_sweeps`` modes a ``cuda_kernels.counts()`` delta ran."""
    return {k for (t, k), v in launched.items() if t == "dense_modes" and v}


def print_dense(label, S, m, n, dtype, lay, res, floor_ms, alt=None):
    """The line every fused_sweeps check prints: mode, C, kernel, bound,
    re-stream floor, plain and their ratio (one call)."""
    print(f"fused_sweeps {label} (S={S}, m={m}, n={n}) "
          f"{str(dtype).replace('torch.', '')}: mode {lay['mode']} C="
          f"{lay['C']} buffers={lay['buffers']}"
          + (f" hold={lay['hold']} ns={lay['ns']} vec_smem="
             f"{lay['vec_smem']}" if lay["mode"] != "resident" else "")
          + f"; kernel {res['ms']:.5f} ms, bound {res['bound_ms']:.5f} ms "
          f"({res['bound_by']}), re-stream floor {floor_ms:.5f} ms, plain "
          f"{res['plain_ms']:.5f} ms, kernel/plain "
          f"{res['ms'] / res['plain_ms']:.4f}"
          + ("" if alt is None else f"; {alt[0]} (C={alt[1]}) "
             f"{alt[2]:.5f} ms, kernel/plain {alt[2] / res['plain_ms']:.4f}")
          + f" {CARD}", flush=True)


def phase_dense_kernels(cuda_kernels):
    """``fused_sweeps`` against its plain version at every shape of
    DENSE_SHAPES in f32 (also against the f64 plain version) and f64, in
    the mode its layout picks on this card, each launch checked to have
    run that mode; where another mode takes the shape as the alternative
    (one scenario buffer against a cluster of 2), that mode is timed on
    the same inputs.  Keys: (label, dtype)."""
    import torch

    out = {}
    n_sweeps, n_refine, alpha = 4, 2, 1.6
    for label, (S, m, n) in DENSE_SHAPES.items():
        flops = 2 * S * n_sweeps * (2 * m * n + n * n * (1 + 2 * n_refine))
        for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            isz = torch.empty((), dtype=dtype).element_size()
            lay = dense_layout_of(cuda_kernels, S, m, n, dtype)
            args, sigma = dense_case(S, m, n, dtype)
            fixed = (n_sweeps, n_refine, sigma, alpha)
            res = out[(label, dtype)] = hold_mode(
                cuda_kernels, cuda_kernels.dense_modes, lay["mode"],
                f"fused_sweeps {label} S={S} m={m} n={n}",
                lambda: cuda_kernels.fused_sweeps(*args, *fixed),
                lambda: cuda_kernels.fused_sweeps_plain(*args, *fixed),
                args, flops, tol, dtype,
                ref=f64_ref(lambda *a: cuda_kernels.fused_sweeps_plain(
                    *a, *fixed), args, dtype), reps=DENSE_REPS)
            res.update(mode=lay["mode"], C=lay["C"],
                       floor_ms=cuda_kernels.dense_matrix_reads(
                           S, m, n, isz, lay, n_sweeps, n_refine)
                       / HBM_BYTES_PER_S * 1e3)
            # the alternative: one buffer a block against the least
            # cluster that takes the scenario
            other = {"resident": "cluster", "cluster": "resident"}.get(
                lay["mode"])
            olay = other and (lay["mode"] == "cluster"
                              or lay["buffers"] == 1) \
                and cuda_kernels._dense_mode_layout(m, n, isz, False, other)
            alt = None
            if olay:
                res["alt"] = alt = (other, olay["C"], cuda_time_ms(
                    lambda: cuda_kernels._launch_dense(olay, *args, *fixed),
                    DENSE_REPS))
            print_dense(label, S, m, n, dtype, lay, res, res["floor_ms"],
                        alt)
            del args
            torch.cuda.empty_cache()
    return out


def phase_kernels(cuda_kernels):
    """Each kernel against its plain version at its main path's shape, in
    f32 (also against the f64 plain version) and f64, in the mode the main
    path runs, and ``fused_sweeps`` in every mode at the shapes its paths
    give it (:func:`phase_dense_kernels`)."""
    import torch

    out = {"fused_sweeps": phase_dense_kernels(cuda_kernels),
           "fused_sweeps_shared": {}}
    n_sweeps, n_refine, alpha = 4, 2, 1.6
    # uc_lite's defaults, has=1 and has=0: at S=1000 (the main path) its
    # 125 tiles outnumber the clusters the card holds at once and the
    # streamed mode runs; at S=128 every tile has a cluster and the
    # cluster-resident mode runs.  Each is timed in the other mode too,
    # which must be the slower.  And a wide shared A (n=2000, the streamed
    # mode only) at small S.
    n_extra = 2
    for (S, m, n, mode, other, hases) in (
            (1000, 242, 132, "streamed", "resident", (1, 0)),
            (128, 242, 132, "resident", "streamed", (1, 0)),
            (16, 242, 2000, "streamed", None, (1,))):
        for has in hases:
            flops = 2 * S * n_sweeps * (
                2 * m * n + n * n * (1 + 2 * n_refine + 2 * n_extra * has))
            for dtype, tol in ((torch.float32, 1e-5),
                               (torch.float64, 1e-12)):
                args, sigma = shared_sweep_case(S, m, n, dtype, has)
                fixed = (n_sweeps, n_refine, n_extra, sigma, alpha)
                label = f"fused_sweeps_shared S={S} m={m} n={n} has={has}"
                res = hold_mode(
                    cuda_kernels, cuda_kernels.shared_modes, mode, label,
                    lambda: cuda_kernels.fused_sweeps_shared(*args, *fixed),
                    lambda: cuda_kernels.fused_sweeps_shared_plain(
                        *args, *fixed),
                    args, flops, tol, dtype,
                    ref=f64_ref(
                        lambda *a: cuda_kernels.fused_sweeps_shared_plain(
                            *a, *fixed), args, dtype))
                out["fused_sweeps_shared"][(S, dtype, has)] = res
                if other is not None:
                    res["other_ms"] = cuda_time_ms(
                        lambda: cuda_kernels.fused_sweeps_shared(
                            *args, *fixed, mode=other))
                    print(f"  {label} {dtype}: [{other}] "
                          f"{res['other_ms']:.5f} ms against [{mode}] "
                          f"{res['ms']:.5f} ms", flush=True)
                    check(res["ms"] <= res["other_ms"],
                          f"{label} {dtype}: the {mode} mode picked, "
                          f"{res['ms']:.5f} ms, is slower than the {other} "
                          f"mode, {res['other_ms']:.5f} ms")
                del args
    torch.cuda.empty_cache()
    out["fused_sweeps_sparse"] = phase_sparse_kernel(cuda_kernels)
    torch.cuda.empty_cache()
    out["lowered"] = phase_lowered_kernels(cuda_kernels)
    return out


#: Lowered kernels against their plain versions on the card (the same
#: inputs).  Where two sums of a lowered recurrence run in another order,
#: a last-digit difference can move the bf16 rounding of the next
#: product's operand to its neighbour (2^-8 of that element at "default",
#: 2^-16 at "high"), so in f32 the kernels part from their plain versions
#: at that level, not at the working type's: measured up to 7.1e-3 at
#: "default" and 1.8e-5 at "high" on an H100 (PERF.md); there the f32
#: kernel is also held against the f64 plain version (no further from it
#: than LOW_REF_FACTOR times the plain f32 is).  In f64 each kernel and its
#: plain version sum the same bf16 products in f64 (pallas_kernels'
#: preferred_element_type=dt; the structured mode's plain apply too,
#: cuda_kernels._kernel_dot), and a rounding falls the other way only where
#: an f64 sum's difference moves its f32 rounding (measured up to 5.9e-9).
LOW_TOL_F64 = 1e-7
LOW_TOL_F32 = {"default": 2e-2, "high": 2e-4}
LOW_REF_FACTOR = 3.0
LOW_REF_SLACK = 1e-5
#: The control, so that a kernel that ignores the mode cannot pass: the
#: plain version at "highest" on the same inputs, from which the kernel
#: must lie at least 1 / LOW_CTRL_RATIO times as far as from the lowered
#: plain version (``rms_dist``), in f64 at both modes and in f32 at
#: "default".  In f32 at "high" it is printed and not gated: bf16x3 keeps
#: an operand to 2^-17 of it, about what an operand's low part moves by
#: where an f32 sum's last digit does, so there a kernel and its plain
#: version part about as far as either lies from the exact version
#: (ratios measured on an H100 in PERF.md).
LOW_CTRL_RATIO = 1.0 / 3.0


def phase_lowered_kernels(cuda_kernels):
    """Each kernel at each lowered mode against its plain version at its
    main path's shape, f32 (also against the f64 plain version) and f64:
    ``fused_sweeps`` at "default" at every shape of DENSE_SHAPES (the
    streamed mode's bf16 A rows through the ring and bf16 K^-1 rows read
    from device memory too), in the mode its layout picks there,
    ``fused_sweeps_shared`` at "default" and "high" at uc_lite-1000 (has=1,
    its streamed mode, the one that takes the lowered modes), ``fused_sweeps_sparse`` at "default" and
    "high" at uc-1000 (has=1) in its structured and dense modes.  The
    bound counts the matrices at their bf16 bytes and the lowered products
    (three a multiply-add at "high") at the bf16 tensor-core peak.  Keys:
    (kernel, precision, mode, dtype)."""
    import torch

    from tpusppy_torch.solvers.structured_kkt import lowered_layout

    out = {}
    n_sweeps, n_refine, alpha = 4, 2, 1.6
    for label, (S, m, n) in DENSE_SHAPES.items():
        lo = 2 * S * n_sweeps * (2 * m * n + n * n * (1 + n_refine))
        hi = 2 * S * n_sweeps * n * n * n_refine
        for dtype in (torch.float32, torch.float64):
            isz = torch.empty((), dtype=dtype).element_size()
            lay = dense_layout_of(cuda_kernels, S, m, n, dtype, True)
            kmode = lay["mode"]
            args, sigma = dense_case(S, m, n, dtype)
            op = cuda_kernels.dense_operand(args[1], args[2], "default")
            fixed = (n_sweeps, n_refine, sigma, alpha)
            f32 = dtype == torch.float32
            res = hold_lowered(
                cuda_kernels, "fused_sweeps", "default",
                cuda_kernels.dense_modes, kmode,
                f"fused_sweeps[default] {label} S={S} m={m} n={n}",
                lambda: cuda_kernels.fused_sweeps(
                    *args, *fixed, precision="default", operand=op),
                lambda: cuda_kernels.fused_sweeps_plain(
                    *args, *fixed, precision="default", operand=op),
                [args[0], *op] + args[3:], hi, lo,
                LOW_TOL_F32["default"] if f32 else LOW_TOL_F64, dtype,
                f64_ref(lambda *a: cuda_kernels.fused_sweeps_plain(
                    *a, *fixed, precision="default"), args, dtype),
                lambda: cuda_kernels.fused_sweeps_plain(*args, *fixed),
                reps=DENSE_REPS)
            out[("fused_sweeps", "default", label, dtype)] = res
            print_dense(f"[default] {label}", S, m, n, dtype, lay, res,
                        cuda_kernels.dense_matrix_reads(
                            S, m, n, isz, lay, n_sweeps, n_refine, True)
                        / HBM_BYTES_PER_S * 1e3)
            del args, op
            torch.cuda.empty_cache()
    S, m, n, n_extra = 1000, 242, 132, 2
    n_pass = n_refine + n_extra
    for prec in ("default", "high"):
        parts = 1 if prec == "default" else 3
        lo = 2 * S * n_sweeps * (2 * m * n + (1 + n_pass) * n * n) * parts
        hi = 2 * S * n_sweeps * n_pass * n * n
        for dtype in (torch.float32, torch.float64):
            args, sigma = shared_sweep_case(S, m, n, dtype, 1)
            _, op = cuda_kernels.shared_plan(S, args[1], args[2], args[3],
                                             precision=prec)
            fixed = (n_sweeps, n_refine, n_extra, sigma, alpha)
            f32 = dtype == torch.float32
            out[("fused_sweeps_shared", prec, "streamed", dtype)] = \
                hold_lowered(
                    cuda_kernels, "fused_sweeps_shared", prec,
                    cuda_kernels.shared_modes, "streamed",
                    f"fused_sweeps_shared[{prec}] S={S} m={m} n={n} has=1",
                    lambda: cuda_kernels.fused_sweeps_shared(
                        *args, *fixed, precision=prec, operand=op),
                    lambda: cuda_kernels.fused_sweeps_shared_plain(
                        *args, *fixed, precision=prec),
                    [args[0], op, args[3]] + args[4:], hi, lo,
                    LOW_TOL_F32[prec] if f32 else LOW_TOL_F64, dtype,
                    f64_ref(lambda *a: cuda_kernels.fused_sweeps_shared_plain(
                        *a, *fixed, precision=prec), args, dtype),
                    lambda: cuda_kernels.fused_sweeps_shared_plain(
                        *args, *fixed))
            del args, op
    torch.cuda.empty_cache()
    pattern = uc_sparse_pattern()
    n_refine = 1
    n_pass = n_refine + n_extra
    n = pattern.shape[1]
    for kmode in ("structured", "dense"):
        for prec in ("default", "high"):
            parts = 1 if prec == "default" else 3
            for dtype in (torch.float32, torch.float64):
                args, sp, sigma = sparse_sweep_case(
                    pattern, S, dtype, 1, structured=kmode == "structured")
                apply = (n * n if kmode == "dense"
                         else woodbury_apply_macs(args[5], sp))
                lo = 2 * S * n_sweeps * (1 + n_pass) * apply * parts
                hi = 2 * S * n_sweeps * sp.nnz * (2 + 2 * n_pass)
                ell_t = cuda_kernels.ell_slot_major(args[1:5])
                fixed = (n_sweeps, n_refine, n_extra, sigma, alpha)
                if kmode == "structured":
                    args[5] = lowered_layout(args[5], prec)
                    op = reads = None
                else:
                    op = cuda_kernels.sparse_operand(args[5], prec)
                    reads = args[:5] + [op] + args[6:]
                f32 = dtype == torch.float32
                ref = None
                if f32:
                    args64 = [a.double() if torch.is_tensor(a)
                              and a.is_floating_point() else a for a in args]
                    if kmode == "structured":
                        args64[5] = args[5].astype(torch.float64)
                    ref = (lambda a=args64: cuda_kernels
                           .fused_sweeps_sparse_plain(*a, *fixed,
                                                      precision=prec))
                out[("fused_sweeps_sparse", prec, kmode, dtype)] = \
                    hold_lowered(
                        cuda_kernels, "fused_sweeps_sparse", prec,
                        cuda_kernels.sparse_modes, kmode,
                        f"fused_sweeps_sparse[{prec}] {kmode} has=1",
                        lambda: cuda_kernels.fused_sweeps_sparse(
                            *args, *fixed, precision=prec, ell_t=ell_t,
                            operand=op),
                        lambda: cuda_kernels.fused_sweeps_sparse_plain(
                            *args, *fixed, precision=prec),
                        reads or args, hi, lo,
                        LOW_TOL_F32[prec] if f32 else LOW_TOL_F64, dtype,
                        ref, lambda: cuda_kernels.fused_sweeps_sparse_plain(
                            *args, *fixed))
                del args, sp, ref, op
                torch.cuda.empty_cache()
    return out


def hold_lowered(cuda_kernels, kernel, prec, modes, kmode, label, kern,
                 plain, reads, flops, flops_lo, tol, dtype, ref, exact,
                 reps=30):
    """``hold_mode`` for a kernel at a lowered precision, with the control
    ``exact`` (the plain version at "highest"; gated as LOW_CTRL_RATIO
    says): its launches in the check must be counted as lowered at
    ``prec``."""
    import torch

    before = dict(cuda_kernels.lowered_launches)
    res = hold_mode(cuda_kernels, modes, kmode, label, kern, plain, reads,
                    flops, tol, dtype, ref=ref, flops_lo=flops_lo,
                    ref_factor=LOW_REF_FACTOR, ref_slack=LOW_REF_SLACK,
                    exact=exact, exact_gate=dtype == torch.float64
                    or prec == "default", reps=reps)
    ran = {k: v - before[k] for k, v in cuda_kernels.lowered_launches.items()}
    key = f"{kernel}:{prec}"
    check(ran[key] > 0 and sum(ran.values()) == ran[key],
          f"{label}: lowered launches {ran}, wanted only {key}")
    return res


def woodbury_apply_macs(lay, sp):
    """Multiply-adds of one structured K^-1 apply for one scenario: two
    passes over the blocks at their real sizes, the one-variable
    components twice, C^-1 (r x r), and A_w t and A_w' v over the wide
    rows' non-zeros."""
    import torch

    pat = lay.pattern
    blocks = sum(s * s for _, s, _, _ in pat.binfo[:-1])
    nnz_w = int(torch.isin(sp.rows, pat.wide).sum())
    return 2 * blocks + 2 * (sp.shape[1] - pat.pd) + pat.r ** 2 + 2 * nnz_w


def phase_sparse_kernel(cuda_kernels, S=1000):
    """fused_sweeps_sparse against its plain version at uc-1000's shape
    (m=4626, n=2928, kr=61, kc=10; 4 sweeps, n_refine=1 as bench_uc.py
    runs it, n_extra=2), has=1 and has=0, f32 and f64, in its structured
    mode (the uc paths') and its dense mode.  In f32 both the kernel and
    the plain version are also held against the f64 plain version on the
    same inputs.  Keys: (mode, dtype, has)."""
    import torch

    out = {}
    pattern = uc_sparse_pattern()
    n_sweeps, n_refine, n_extra, alpha = 4, 1, 2, 1.6
    n = pattern.shape[1]
    for mode in ("structured", "dense"):
        for has in (1, 0):
            n_pass = n_refine + n_extra * has
            for dtype, tol in ((torch.float32, SPARSE_TOL_F32),
                               (torch.float64, 1e-12)):
                args, sp, sigma = sparse_sweep_case(
                    pattern, S, dtype, has, structured=mode == "structured")
                # the work this data needs: each K^-1 apply (n^2 dense, or
                # the structured operator's real blocks, C^-1 and wide
                # rows), and the ELL products on the non-zeros only
                # (padding slots are no work)
                apply = (n * n if mode == "dense"
                         else woodbury_apply_macs(args[5], sp))
                flops = 2 * S * n_sweeps * ((1 + n_pass) * apply
                                            + sp.nnz * (2 + 2 * n_pass))
                ell_t = cuda_kernels.ell_slot_major(args[1:5])
                fixed = (n_sweeps, n_refine, n_extra, sigma, alpha)
                ref = None
                if dtype == torch.float32:
                    args64 = [a.double() if torch.is_tensor(a)
                              and a.is_floating_point() else a for a in args]
                    if mode == "structured":
                        args64[5] = args[5].astype(torch.float64)
                    ref = (lambda a=args64:
                           cuda_kernels.fused_sweeps_sparse_plain(*a, *fixed))
                before = dict(cuda_kernels.sparse_modes)
                out[(mode, dtype, has)] = hold_kernel(
                    f"fused_sweeps_sparse {mode} has={has}",
                    lambda: cuda_kernels.fused_sweeps_sparse(*args, *fixed,
                                                             ell_t=ell_t),
                    lambda: cuda_kernels.fused_sweeps_sparse_plain(*args,
                                                                   *fixed),
                    args, flops, tol, dtype, ref=ref)
                check(cuda_kernels.sparse_modes[mode] > before[mode],
                      f"fused_sweeps_sparse did not launch its {mode} mode")
                del args, sp, ref
                torch.cuda.empty_cache()
    return out


#: HiGHS EFs solved in a worker process from the start of the run, beside
#: the kernels' build, and read where a phase holds a run against them:
#: label -> (model, S) at its LP relaxation and default kwargs.
EF_PREFETCH = {"uc S=10": ("uc", 10), "uc_lite-1000": ("uc_lite", 1000)}
_EF_FUTURES: dict = {}


def ef_of(model, S):
    """The HiGHS EF objective of ``model`` at S scenarios (LP relaxation),
    in a worker process."""
    sys.path.insert(0, HERE)
    import importlib

    from tpusppy_torch.ef import solve_ef
    from tpusppy_torch.spbase import build_batch

    mod = importlib.import_module(f"tpusppy_torch.models.{model}")
    batch, _ = build_batch(mod.scenario_names_creator(S),
                           mod.scenario_creator,
                           {"num_scens": S, "relax_integers": True})
    return solve_ef(batch, solver="highs")[0]


def start_ef_prefetch():
    """Start :data:`EF_PREFETCH`'s solves; returns the pool (shut down by
    the caller)."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=2, mp_context=multiprocessing.get_context("spawn"))
    for label, (model, S) in EF_PREFETCH.items():
        _EF_FUTURES[label] = pool.submit(ef_of, model, S)
    return pool


def prefetched_ef(label, batch):
    """``label``'s EF objective: the prefetched solve's, else HiGHS on
    ``batch`` here."""
    from tpusppy_torch.ef import solve_ef

    fut = _EF_FUTURES.get(label)
    return (fut.result() if fut is not None
            else solve_ef(batch, solver="highs")[0])


def farmer_ph(S, cm, options, ph_class=None):
    """farmer PH; ``ph_class``: a PH subclass (:func:`clocked`)."""
    from tpusppy_torch.models import farmer
    from tpusppy_torch.opt.ph import PH

    return (ph_class or PH)(options, farmer.scenario_names_creator(S),
                            farmer.scenario_creator,
                            scenario_creator_kwargs={"num_scens": S,
                                                     "crops_multiplier": cm})


def uc_ph(S, options, ph_class=None, **kw):
    """uc_lite PH (LP relaxation) on its shared-A engine; ``kw`` goes to
    the scenario creator (num_gens, horizon)."""
    from tpusppy_torch.models import uc_lite
    from tpusppy_torch.opt.ph import PH

    ph = (ph_class or PH)(options, uc_lite.scenario_names_creator(S),
                          uc_lite.scenario_creator,
                          scenario_creator_kwargs=dict(
                              kw, num_scens=S, relax_integers=True))
    check(ph.batch.A_shared is not None, "uc_lite batch is not shared-A")
    return ph


def uc_full_ph(S, options, ph_class=None):
    """uc PH (models/uc.py at its full width, 30 generators x 24 hours; LP
    relaxation) on the structured-KKT engine: the shared A goes up as a
    SparseA with its block/Woodbury structure."""
    import torch

    from tpusppy_torch.models import uc
    from tpusppy_torch.opt.ph import PH
    from tpusppy_torch.solvers.sparse import SparseA

    ph = (ph_class or PH)(options, uc.scenario_names_creator(S),
                          uc.scenario_creator,
                          scenario_creator_kwargs={"num_scens": S,
                                                   "relax_integers": True})
    A_d = ph._device_consts(ph.admm_settings.tdtype())[0]
    check(isinstance(A_d, SparseA) and A_d.structure is not None
          and A_d.device.type == "cuda" and A_d.dtype == getattr(
              torch, ph.admm_settings.dtype),
          "the uc batch did not go up as a structured SparseA on the card")
    return ph


def phase_golden(cuda_kernels):
    from tpusppy_torch.ef import solve_ef

    ph = farmer_ph(3, 1, {"defaultPHrho": 1.0, "PHIterLimit": 100,
                          "convthresh": 1e-6})
    cuda_kernels.reset_counts()
    conv, eobj, tbound = ph.ph_main()
    launches = cuda_kernels.launches["fused_sweeps"]
    print(f"golden farmer S=3 f64 on {ph.device}: conv={conv:.3e} "
          f"eobj={eobj:.4f} tbound={tbound:.4f} (EF {EF_GOLDEN}) "
          f"launches={launches}", flush=True)
    check(launches > 0 and cuda_kernels.plain_calls["fused_sweeps"] == 0,
          "the golden run did not go through the fused_sweeps kernel")
    check(abs(eobj - EF_GOLDEN) <= 2e-3 * abs(EF_GOLDEN),
          f"golden eobj {eobj} not within 2e-3 of {EF_GOLDEN}")
    check(tbound <= EF_GOLDEN + 1e-6 * abs(EF_GOLDEN),
          f"golden trivial bound {tbound} above {EF_GOLDEN}")

    # the repo's uc_lite settings and limits (tests/test_models.py)
    ph = uc_ph(3, dict(UC_GOLDEN_OPTIONS, PHIterLimit=60), num_gens=3,
               horizon=6)
    cuda_kernels.reset_counts()
    conv, eobj, tbound = ph.ph_main()
    launches = cuda_kernels.launches["fused_sweeps_shared"]
    plain = cuda_kernels.plain_calls["fused_sweeps_shared"]
    ef_obj, _ = solve_ef(ph.batch, solver="highs")
    print(f"golden uc_lite S=3 (3 gens, 6 h) f64 on {ph.device}: "
          f"conv={conv:.3e} eobj={eobj:.4f} tbound={tbound:.4f} "
          f"(EF {ef_obj:.4f}, rel {abs(eobj - ef_obj) / abs(ef_obj):.3e}) "
          f"launches={launches} plain_calls={plain}", flush=True)
    check(launches > 0 and plain == 0, "the uc_lite golden run did not go "
          "through the fused_sweeps_shared kernel")
    check(abs(eobj - ef_obj) <= 1e-2 * abs(ef_obj),
          f"uc_lite golden eobj {eobj} not within 1e-2 of EF {ef_obj}")
    check(tbound <= ef_obj + 1e-6 * abs(ef_obj),
          f"uc_lite golden trivial bound {tbound} above EF {ef_obj}")

    # full-width uc at S=10 through fused_sweeps_sparse, f64, with the
    # repo's UC solver settings at f64's eps (bench_uc.py); then the same
    # PH's first iterations on the tensor path, held to it after each
    runs = {}
    for use_kernel, iters in (("auto", UC_FULL_GOLDEN_ITERS),
                              (False, UC_FULL_TENSOR_ITERS)):
        ph, runs[use_kernel] = run_path(
            cuda_kernels, "fused_sweeps_sparse",
            lambda o, cls: uc_full_ph(10, o, ph_class=cls), use_kernel,
            iters, UC_FULL_GOLDEN_OPTIONS, UC_SOLVER, dtype="float64",
            eps=1e-8)
    k, p = runs["auto"], runs[False]
    t0 = time.perf_counter()
    ef_obj = prefetched_ef("uc S=10", ph.batch)
    print(f"golden uc S=10 (30 gens, 24 h) f64 on {ph.device}: "
          f"conv={k['conv']:.3e} eobj={k['eobj']:.4f} "
          f"tbound={k['tbound']:.4f} iters={k['iters']} "
          f"wall_s={k['wall_s']:.2f} (EF {ef_obj:.4f} in "
          f"{time.perf_counter() - t0:.2f} s, rel "
          f"{abs(k['eobj'] - ef_obj) / abs(ef_obj):.3e}) "
          f"launches={k['launches']} plain_calls={k['plain_calls']} "
          f"modes={k['modes']}; "
          f"tensor path wall_s={p['wall_s']:.2f}", flush=True)
    rel = print_parting("golden uc S=10 f64", k, p, UC_FULL_TENSOR_ITERS)
    check(k["launches"] > 0 and k["plain_calls"] == 0, "the uc golden run "
          "did not go through the fused_sweeps_sparse kernel")
    check(p["launches"] == 0, "use_kernel=False launched the kernel")
    check(max(rel) <= UC_FULL_F64_TOL, f"uc golden f64: kernel and tensor-"
          f"path eobj differ by {max(rel):.3e} > {UC_FULL_F64_TOL:.0e}")
    check(abs(k["eobj"] - ef_obj) <= 1e-2 * abs(ef_obj),
          f"uc golden eobj {k['eobj']} not within 1e-2 of EF {ef_obj}")
    check(k["tbound"] <= ef_obj + 1e-6 * abs(ef_obj),
          f"uc golden trivial bound {k['tbound']} above EF {ef_obj}")
    # the same PH as the hub of a wheel whose Lagrangian spoke bounds from
    # donor duals alone: certified against the optimum
    ws, _, _ = uc_donor_wheel(cuda_kernels, "golden uc S=10", 10,
                              UC_FULL_GOLDEN_ITERS, UC_FULL_GOLDEN_OPTIONS,
                              "float64", 1e-8)
    print(f"golden uc S=10 wheel: outer {ws.BestOuterBound:.6f} against EF "
          f"{ef_obj:.6f}, rel {(ws.BestOuterBound - ef_obj) / abs(ef_obj):.3e}",
          flush=True)
    check(ws.BestOuterBound <= ef_obj + 1e-6 * abs(ef_obj),
          f"uc golden wheel outer bound {ws.BestOuterBound} above EF "
          f"{ef_obj}")
    return {"uc10_ef": ef_obj}


# the sweep loop's f64 solutions at L and at L=1: the same operations in
# the same order on the same data, so they agree to rounding at most
LOOP_F64_TOL = 1e-12


def loop_case(which, S, dtype):
    """Device arrays (c, q2, A, cl, cu, lb, ub), solver settings, the engine
    module and its blocks-per-replay constant, the kernel, and the PH-like
    prox q2 of one engine's case: ``farmer`` (crops_multiplier 4 at
    S=1000, 1 below; rho 1), ``uc_lite`` (defaults at S >= 128, 3
    generators and 6 hours below; rho 500, its main path's, or 10, its
    golden's) or ``uc`` (full width, a structured SparseA; rho 500 or
    10000, bench_uc.py's solver settings)."""
    import torch

    from tpusppy_torch.models import farmer, uc, uc_lite
    from tpusppy_torch.solvers import admm, shared_admm
    from tpusppy_torch.solvers.sparse import SparseA
    from tpusppy_torch.spbase import build_batch

    f32 = dtype == torch.float32
    eps = 1e-5 if f32 else 1e-8
    solver = dict(dtype=str(dtype).replace("torch.", ""), eps_abs=eps,
                  eps_rel=eps)
    if which == "farmer":
        model, mod, attr, kernel, rho = farmer, admm, "BLOCKS_PER_REPLAY", \
            "fused_sweeps", 1.0
        kw = {"num_scens": S, "crops_multiplier": 4 if S >= 1000 else 1}
    elif which == "uc_lite":
        model, mod, attr, kernel = uc_lite, shared_admm, \
            "BLOCKS_PER_REPLAY", "fused_sweeps_shared"
        rho = 500.0 if S >= 128 else 10.0
        kw = {"num_scens": S, "relax_integers": True}
        if S < 128:
            kw.update(num_gens=3, horizon=6)
    else:
        model, mod, attr, kernel = uc, shared_admm, \
            "SPARSE_BLOCKS_PER_REPLAY", "fused_sweeps_sparse"
        rho = 500.0 if S >= 1000 else 10000.0
        kw = {"num_scens": S, "relax_integers": True}
        solver.update(UC_SOLVER)
    b, _ = build_batch(model.scenario_names_creator(S), model.scenario_creator,
                       kw)

    def t(v):
        return torch.as_tensor(np.ascontiguousarray(v), dtype=dtype,
                               device="cuda")

    if b.A_shared is None:
        A = t(b.A)
    elif which == "uc":
        A = SparseA.from_dense(b.A_shared, dtype=dtype, device="cuda",
                               structure=True)
        check(A.structure is not None, "uc's A has no block structure")
    else:
        A = t(b.A_shared)
    prox = np.zeros_like(b.q2)
    prox[:, b.tree.nonant_indices] = rho
    arrs = (t(b.c), t(b.q2), A, t(b.cl), t(b.cu), t(b.lb), t(b.ub))
    st = admm.ADMMSettings(**solver)
    return arrs, st, mod, attr, kernel, t(b.q2 + prox)


def loop_solves(cuda_kernels, which, S, dtype, adaptive):
    """One engine's case solved at L=1, L=4 and the engine's L: with
    ``adaptive`` a factored solve (PH's Iter0 objective) at each L, then,
    from the factors made at the engine's L, a frozen solve of the prox
    objective at each L.  Returns {"adaptive"/"frozen": {L: (solution,
    window deltas)}}, and the engine's L."""
    import torch

    from tpusppy_torch.obs import metrics
    from tpusppy_torch.solvers import admm, device_loop, shared_admm

    arrs, st, mod, attr, kernel, q2p = loop_case(which, S, dtype)
    shared = mod is shared_admm
    factored = (shared_admm.solve_shared_factored if shared
                else admm.solve_batch_factored)
    frozen = (shared_admm.solve_shared_frozen if shared
              else admm.solve_batch_frozen)
    L = getattr(mod, attr)
    ce = max(1, st.check_every)

    def timed(fn, *a, **k):
        cuda_kernels.reset_counts()
        with metrics.window() as win:
            out = fn(*a, **k)
            torch.cuda.synchronize()
        blocks = win.delta("device_loop.blocks")
        captures = win.delta("device_loop.captures")
        warmups = win.delta("device_loop.warmups")
        launches = cuda_kernels.launches[kernel]
        check(launches == blocks + warmups
              and cuda_kernels.plain_calls[kernel] == 0,
              f"loop {which} S={S}: {launches} {kernel} launches against "
              f"{blocks:.0f} blocks replayed and {warmups:.0f} warm-up "
              f"blocks")
        return out, dict(blocks=blocks, captures=captures,
                         checks=win.delta("admm.loop_checks"),
                         replays=win.delta("device_loop.replays"))

    runs = {}
    ls = sorted({1, 4, L}, key=lambda v: v == L)
    try:
        for bpr in (ls if adaptive else (L,)):
            setattr(mod, attr, bpr)
            (sol, fac), d = timed(factored, *arrs, settings=st)
            runs.setdefault("adaptive", {})[bpr] = (sol, d)
        base = (sol, fac)
        q = arrs[0] * 1.01
        for bpr in ls:
            setattr(mod, attr, bpr)
            sol, d = timed(frozen, q, q2p, *arrs[2:], base[1], settings=st,
                           warm=base[0].raw)
            sweeping = int(sol.iters[0]) // ce
            waste = d["blocks"] - sweeping
            check(0 <= waste <= 2 * bpr - 1,
                  f"loop {which} S={S} L={bpr}: {d['blocks']:.0f} blocks "
                  f"replayed for {sweeping} sweeping blocks")
            runs.setdefault("frozen", {})[bpr] = (sol, d)
    finally:
        setattr(mod, attr, L)
        device_loop._cache.clear()
    return runs, L


def loop_diff(a, b):
    """Largest difference of two solutions' fields, relative to the
    largest entry of ``b`` (floored at 1)."""
    fields = ("x", "z", "y", "yx", "pri_res", "dua_res")
    return max_err([getattr(a, f) for f in fields],
                   [getattr(b, f) for f in fields])


def graph_vs_direct(cuda_kernels):
    """``fused_sweeps`` in its cluster and streamed modes captured in a CUDA
    graph: three chained launches at a bucket shape of bundled farmer-1000
    (f32, resident with one buffer; f64, a cluster of 2) and at sslp's
    (f64, the streamed mode) replayed, against the same three launched
    directly on the same inputs: the same state to the last bit."""
    import torch

    n_sweeps, n_refine, alpha = 4, 2, 1.6
    for S, m, n, dtype in ((200, 84, 108, torch.float32),
                           (200, 84, 108, torch.float64),
                           (50, 60, 520, torch.float64)):
        args, sigma = dense_case(S, m, n, dtype)
        stop = torch.zeros(1, dtype=torch.int32, device="cuda")
        fixed = (n_sweeps, n_refine, sigma, alpha)

        def chain():
            state = args[10:]
            for _ in range(3):
                state = list(cuda_kernels.fused_sweeps(
                    *args[:10], *state, *fixed, stop=stop))
            return state

        before = dict(cuda_kernels.dense_modes)
        direct = chain()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            chain()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = chain()
        graph.replay()
        torch.cuda.synchronize()
        ran = {k: cuda_kernels.dense_modes[k] - before[k] for k in before}
        diff = max(float((c - d).abs().max())
                   for c, d in zip(captured, direct))
        mode = dense_layout_of(cuda_kernels, S, m, n, dtype)["mode"]
        print(f"loop fused_sweeps graph replay (S={S}, m={m}, n={n}) "
              f"{str(dtype).replace('torch.', '')} [{mode}]: three launches "
              f"replayed against direct, max abs diff {diff:.3e}; modes "
              f"launched {ran}", flush=True)
        check(diff == 0.0, f"loop fused_sweeps (S={S}, m={m}, n={n}) "
              f"{dtype}: a graph replay parts from direct launches by "
              f"{diff:.3e}")
        check(ran[mode] == 9 and sum(ran.values()) == 9,
              f"loop fused_sweeps (S={S}, m={m}, n={n}): launched modes "
              f"{ran}, wanted {mode} only")
        del args, direct, captured, graph
        torch.cuda.empty_cache()


def phase_loop(cuda_kernels):
    """The sweep loop at L=1 against the engine's L: the goldens' shapes
    in f64, a frozen solve of each main path in f32, then the factor
    swap, then ``fused_sweeps`` replayed at a bucket and at sslp's shape
    against direct launches (:func:`graph_vs_direct`)."""
    import torch

    for which, S, dtype, adaptive in (
            ("farmer", 3, torch.float64, True),
            ("uc_lite", 3, torch.float64, True),
            ("uc", 10, torch.float64, True),
            ("farmer", 1000, torch.float32, False),
            ("uc_lite", 1000, torch.float32, False),
            ("uc", 1000, torch.float32, False)):
        runs, L = loop_solves(cuda_kernels, which, S, dtype, adaptive)
        name = str(dtype).replace("torch.", "")
        for kind, by_l in runs.items():
            if 1 not in by_l:
                continue    # the main paths' factors, made at the engine's L
            s1, d1 = by_l[1]
            for bpr, (sL, dL) in by_l.items():
                if bpr == 1:
                    continue
                diff = loop_diff(sL, s1)
                print(f"loop {which} S={S} {name} {kind}: iters "
                      f"{int(s1.iters[0])} (L=1) / {int(sL.iters[0])} "
                      f"(L={bpr}{', the engine' if bpr == L else ''}), max "
                      f"rel diff {diff:.3e}; flag reads {d1['checks']:.0f} "
                      f"/ {dL['checks']:.0f}, replays {d1['replays']:.0f} / "
                      f"{dL['replays']:.0f}, blocks replayed "
                      f"{d1['blocks']:.0f} / {dL['blocks']:.0f}", flush=True)
                check(int(s1.iters[0]) == int(sL.iters[0]),
                      f"loop {which} S={S} {kind}: the sweep count moved "
                      f"with L")
                check(all(bool(torch.isfinite(getattr(sL, f)).all())
                          for f in ("x", "y")), f"loop {which}: non-finite x")
                if dtype == torch.float64:
                    check(diff <= LOOP_F64_TOL, f"loop {which} S={S} "
                          f"{kind}: L={bpr} parts from L=1 by {diff:.3e}")
        torch.cuda.empty_cache()
    for which, S in (("farmer", 1000), ("uc_lite", 1000), ("uc_lite", 128),
                     ("uc", 1000)):
        swap_factors(cuda_kernels, which, S)
    graph_vs_direct(cuda_kernels)


def swap_factors(cuda_kernels, which, S):
    """Two frozen solves with different factors on one captured graph (the
    refresh factors of two prox weights): the second must match, bitwise,
    the same solve on a fresh capture."""
    import torch

    from tpusppy_torch.obs import metrics
    from tpusppy_torch.solvers import admm, device_loop, shared_admm

    arrs, st, mod, _, kernel, q2p = loop_case(which, S, torch.float32)
    shared = mod is shared_admm
    factored = (shared_admm.solve_shared_factored if shared
                else admm.solve_batch_factored)
    frozen = (shared_admm.solve_shared_frozen if shared
              else admm.solve_batch_frozen)
    q2b = 2.0 * q2p
    sol_a, fac_a = factored(arrs[0], q2p, *arrs[2:], settings=st)
    sol_b, fac_b = factored(arrs[0], q2b, *arrs[2:], settings=st)
    q = arrs[0] * 1.01
    device_loop._cache.clear()
    modes = dict(mode_counts(cuda_kernels)[kernel])
    frozen(q, q2p, *arrs[2:], fac_a, settings=st, warm=sol_a.raw)
    c0 = metrics.value("device_loop.captures")
    swapped = frozen(q, q2b, *arrs[2:], fac_b, settings=st, warm=sol_b.raw)
    captures = metrics.value("device_loop.captures") - c0
    ran = {k: v - modes[k] for k, v in mode_counts(cuda_kernels)[kernel]
           .items()}
    device_loop._cache.clear()
    fresh = frozen(q, q2b, *arrs[2:], fac_b, settings=st, warm=sol_b.raw)
    torch.cuda.synchronize()
    diff = loop_diff(swapped, fresh)
    print(f"factor swap {which} S={S} f32: captures for the second solve "
          f"{captures:.0f}, modes {ran}; swapped against fresh capture "
          f"{diff:.3e}, iters {int(swapped.iters[0])} / "
          f"{int(fresh.iters[0])}", flush=True)
    check(captures == 0, f"factor swap {which}: the second solve captured "
          f"{captures:.0f} graphs")
    want = {"fused_sweeps": "resident", "fused_sweeps_sparse": "structured",
            "fused_sweeps_shared": "resident" if S <= 128
            else "streamed"}[kernel]
    check(ran[want] > 0 and sum(ran.values()) == ran[want],
          f"factor swap {which} S={S}: launched modes {ran}, wanted {want}")
    check(int(swapped.iters[0]) == int(fresh.iters[0]) and diff == 0.0,
          f"factor swap {which} S={S}: the solve on the swapped graph "
          f"parts from a fresh capture by {diff:.3e}")


def clocked(base, on_iter):
    """A subclass of the PH class ``base`` that calls ``on_iter(opt, meas)``
    after Iter0 (``meas`` None), after each legacy iteration (None) and
    after each megastep window (its unpacked measurement).  It records
    without an extension: a PH with an extension runs the legacy loop."""

    class Clocked(base):
        def Iter0(self):
            tb = super().Iter0()
            on_iter(self, None)
            return tb

        def _iterk_one(self, k, convthresh):
            out = super()._iterk_one(k, convthresh)
            on_iter(self, None)
            return out

        def _apply_megastep_meas(self, k, meas):
            super()._apply_megastep_meas(k, meas)
            on_iter(self, meas)

    return Clocked


def run_path(cuda_kernels, kernel, make_ph, use_kernel, iters, options,
             solver=None, dtype="float32", eps=1e-5, mode=None):
    """One path's PH (f32 at eps 1e-5 unless told); returns (ph, results)
    with the launch counts and host syncs read around exactly this run, and
    eobj and the solve loop's decisions after Iter0 and every iteration.
    ``solver``: more solver options; ``mode``: the only mode the kernel
    may launch in (default its main path's, :data:`MAIN_MODES`)."""
    import torch

    from tpusppy_torch.obs import metrics
    from tpusppy_torch.opt.ph import PH

    opts = dict(options, PHIterLimit=iters,
                solver_options=dict(solver or {}, dtype=dtype,
                                    eps_abs=eps, eps_rel=eps,
                                    use_kernel=use_kernel))

    def counts():
        return (cuda_kernels.launches[kernel]
                + cuda_kernels.plain_calls[kernel],
                metrics.value("solve.frozen_rejected"),
                metrics.value("solve.rescued_scenarios"))

    def on_iter(opt, meas):
        """After Iter0 and every iteration: the eobj and the decisions that
        can part two runs: sweep blocks (a plateau or eps exit), whether
        the factors were refreshed, frozen solves refused, scenarios
        rescued (and, in Iter0, which).  A window's iterations come from
        its packed measurement: the device's eobj, its sweeps over
        check_every."""
        if meas is None and opt._iter == 0:
            torch.cuda.synchronize()
            opt.t_iter0_done = time.perf_counter()
            # a rescue leaves exactly zero residuals
            opt.iter0_rescued = np.flatnonzero((opt.pri_res == 0)
                                               & (opt.dua_res == 0))
        now = counts()
        blocks, rejected, rescued = (a - b for a, b in zip(now, opt.base))
        opt.base = now
        if meas is None:
            opt.decisions.append(dict(
                eobj=opt.Eobjective(), blocks=blocks,
                refresh=opt._factors_age == 1, rejected=rejected,
                rescued=rescued))
            return
        ce = max(1, opt.admm_settings.check_every)
        for i in range(meas["executed"]):
            opt.decisions.append(dict(
                eobj=float(meas["eobj"][i]), blocks=meas["iters"][i] / ce,
                refresh=False, rejected=0, rescued=0))

    ph = make_ph(opts, clocked(PH, on_iter))
    ph.base = counts()
    ph.decisions = []
    n_req = ph._megastep_request()
    print(f"{kernel} use_kernel={use_kernel} dtype={dtype}: "
          + (f"megastep windows of N={n_req}" if n_req else
             "the legacy per-iteration loop (megastep "
             f"{ph.admm_settings.megastep})"), flush=True)
    torch.cuda.synchronize()
    cuda_kernels.reset_counts()
    ph.base = counts()
    with metrics.window() as win:
        t0 = time.perf_counter()
        _, eobj, _ = ph.ph_main()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    t1 = ph.t_iter0_done
    launches = cuda_kernels.launches[kernel]
    plain = cuda_kernels.plain_calls[kernel]
    modes = dict(mode_counts(cuda_kernels)[kernel])
    n_it = max(ph._iter, 1)
    # every device-to-host read, the sweep loop's flag reads among them
    syncs = win.delta("host_sync.count")
    checks = win.delta("admm.loop_checks")
    megasteps = win.delta("dispatch.megasteps")
    res = dict(eobj=eobj, n_req=n_req, megasteps=megasteps,
               # the last measurement's worst residual against the frozen
               # acceptance ladder a window starts behind
               worst_residual=float(max(np.max(ph.pri_res),
                                        np.max(ph.dua_res))),
               tol_qp=ph._straggler_tols()[1],
               mega_iters=win.delta("dispatch.mega_iterations"),
               legacy_iters=ph.solves - 1,
               refresh_hits=win.delta("megastep.refresh_hits"),
               window_launches={k: v for (t, k), v in
                                ph.window_launches.items()
                                if t == "launches"},
               # host syncs an iteration: the sweep loops' flag reads, the
               # windows' packed fetches and every other fetch
               flag_reads_per_iter=checks / n_it,
               packed_fetches_per_iter=megasteps / n_it,
               other_syncs_per_iter=(syncs - checks - megasteps) / n_it, decisions=ph.decisions,
               iter0_rescued=ph.iter0_rescued, tbound=ph.trivial_bound, conv=ph.conv,
               iters=ph._iter, wall_s=t2 - t0, iter0_s=t1 - t0,
               loop_s=t2 - t1, rate=ph._iter / (t2 - t1),
               launches=launches, plain_calls=plain, modes=modes,
               launches_per_iter=launches / n_it,
               # the blocks that swept, apart from gated ones (launches
               # count every block replayed and the captures' warm-ups)
               sweep_blocks_per_iter=win.delta("solve.sweeps") / max(
                   1, ph.admm_settings.check_every) / n_it,
               syncs_per_iter=syncs / n_it,
               loop_checks_per_iter=checks / n_it,
               replays=win.delta("device_loop.replays"),
               captures=win.delta("device_loop.captures"),
               capture_s=win.delta("device_loop.capture_secs"),
               rescued=win.delta("solve.rescued_scenarios"),
               guard_trips=win.delta("precision.guard_trips"),
               lowered_solves=win.delta("precision.lowered_solves"),
               lowered_accepted=win.delta("precision.lowered_accepted"),
               lowered=dict(cuda_kernels.lowered_launches))
    if kernel == "fused_sweeps_sparse":
        check_structured(ph, res)
    elif use_kernel:
        want = mode or MAIN_MODES[kernel]
        check(modes[want] == launches,
              f"the run launched {kernel}'s modes {modes}, wanted only "
              f"{want}")
    x = ph.local_x
    check(x.shape == (ph.batch.num_scenarios, ph.batch.num_vars),
          f"local_x shape {x.shape}")
    check(bool(np.isfinite(x).all() and np.isfinite(ph.W).all()),
          "non-finite PH state")
    return ph, res


#: The mode each dense main path runs at S=1000: farmer-1000's scenarios
#: fit two buffers a block; uc_lite-1000's 125 tiles outnumber the clusters
#: of its cluster-resident mode the card holds at once.
MAIN_MODES = {"fused_sweeps": "resident", "fused_sweeps_shared": "streamed"}


def mode_counts(cuda_kernels):
    """Each kernel's launch counts by mode."""
    return {"fused_sweeps": cuda_kernels.dense_modes,
            "fused_sweeps_shared": cuda_kernels.shared_modes,
            "fused_sweeps_sparse": cuda_kernels.sparse_modes}


def check_structured(ph, res):
    """A uc run went through the structured mode only: no dense-mode
    launch, and its factors hold the kernel layout and no dense (n, n)
    K^-1."""
    import torch

    from tpusppy_torch.solvers.structured_kkt import KernelWoodbury

    modes, n = res["modes"], ph.batch.num_vars
    check(modes["dense"] == 0 and modes["structured"] == res["launches"],
          f"the uc run launched fused_sweeps_sparse's modes {modes}")
    fac = ph._factors
    check(fac is not None and isinstance(fac.Kinv_op, KernelWoodbury)
          and not any(isinstance(f, torch.Tensor) and f.shape == (n, n)
                      for f in fac),
          "the uc run's factors hold a dense K^-1, not the kernel layout")


def print_parting(label, k, p, iters):
    """The kernel run ``k`` and the tensor-path run ``p`` side by side,
    after Iter0 and each of the first ``iters`` iterations: eobj, and the
    decisions :func:`run_path` records.  Prints where the decisions first
    differ; returns the relative eobj differences, Iter0 first."""
    dk, dp = k["decisions"], p["decisions"]
    iters = min(iters, len(dk) - 1, len(dp) - 1)
    xor = np.setxor1d(k["iter0_rescued"], p["iter0_rescued"]).size
    first, rels = None, []
    for i in range(iters + 1):
        a, b = dk[i], dp[i]
        rel = abs(a["eobj"] - b["eobj"]) / max(abs(b["eobj"]), 1e-12)
        rels.append(rel)
        same = all(a[f] == b[f] for f in ("blocks", "refresh", "rejected",
                                          "rescued"))
        if first is None and not (same and (i or xor == 0)):
            first = i
        print(f"{label} it {i}: eobj {a['eobj']:.6f} / {b['eobj']:.6f} "
              f"rel {rel:.3e}; blocks {a['blocks']}/{b['blocks']} refresh "
              f"{int(a['refresh'])}/{int(b['refresh'])} rejected "
              f"{a['rejected']:.0f}/{b['rejected']:.0f} rescued "
              f"{a['rescued']:.0f}/{b['rescued']:.0f}"
              + (f" (sets differ in {xor})" if i == 0 else ""), flush=True)
    print(f"{label}: kernel and tensor-path decisions "
          + (f"first differ at iteration {first}" if first is not None
             else f"agree through iteration {iters}"), flush=True)
    return rels


def phase_main(cuda_kernels, label, kernel, make_ph, iters, tensor_iters,
               options, solver=None, ef=True):
    """A main path through ``kernel``, the same PH on the tensor path for
    its first ``tensor_iters`` iterations (the plain sweep is launch-bound
    on the host, so its depth is cut to fit the time limit), and, with
    ``ef``, the HiGHS EF of the same scenarios."""
    from tpusppy_torch.ef import solve_ef

    ph, k = run_path(cuda_kernels, kernel, make_ph, "auto", iters, options,
                     solver)
    print(f"main path {label} f32 kernel: eobj={k['eobj']:.4f} "
          f"tbound={k['tbound']:.4f} conv={k['conv']:.3e} "
          f"iters={k['iters']} wall_s={k['wall_s']:.3f} "
          f"(iter0 {k['iter0_s']:.3f}, loop {k['loop_s']:.3f}) "
          f"ph_it_per_s={k['rate']:.3f} launches={k['launches']} "
          f"launches_per_iter={k['launches_per_iter']:.2f} "
          f"sweep_blocks_per_iter={k['sweep_blocks_per_iter']:.2f} "
          f"host_syncs_per_iter={k['syncs_per_iter']:.2f} "
          f"(loop checks {k['loop_checks_per_iter']:.2f}) "
          f"graph_replays={k['replays']:.0f} captures={k['captures']:.0f} "
          f"capture_s={k['capture_s']:.3f} rescued={k['rescued']:.0f} "
          f"modes={k['modes']}",
          flush=True)
    check(k["launches"] > 0, f"the main path launched no {kernel} kernel")
    check(k["plain_calls"] == 0,
          f"the main path ran the plain sweep {k['plain_calls']} times")
    check(k["iters"] == iters, f"the main path ran {k['iters']} of {iters} "
          "PH iterations")

    _, p = run_path(cuda_kernels, kernel, make_ph, False, tensor_iters,
                    options, solver)
    print(f"main path {label} f32 tensor path: "
          f"eobj={p['eobj']:.4f} tbound={p['tbound']:.4f} "
          f"iters={p['iters']} wall_s={p['wall_s']:.3f} "
          f"ph_it_per_s={p['rate']:.3f} "
          f"host_syncs_per_iter={p['syncs_per_iter']:.2f} "
          f"graph_replays={p['replays']:.0f} "
          f"capture_s={p['capture_s']:.3f}", flush=True)
    check(p["launches"] == 0, "use_kernel=False launched the kernel")
    check(p["iters"] == tensor_iters, f"the tensor path ran {p['iters']} of "
          f"{tensor_iters} PH iterations")
    # the kernel run's eobj after the same number of iterations
    rel_kp = print_parting(label, k, p, tensor_iters)[-1]
    print(f"{label} eobj after {tensor_iters} iterations, kernel vs tensor "
          f"path rel diff {rel_kp:.3e}", flush=True)
    check(rel_kp <= 1e-4, f"kernel and tensor-path eobj differ by {rel_kp}")
    if not ef:
        return k

    t0 = time.perf_counter()
    ef_obj = prefetched_ef(label, ph.batch)
    rel_ef = abs(k["eobj"] - ef_obj) / abs(ef_obj)
    print(f"EF HiGHS {label}: {ef_obj:.4f} ({time.perf_counter() - t0:.2f} "
          f"s); kernel eobj vs EF {rel_ef:.3e}", flush=True)
    check(rel_ef <= 1e-2, f"eobj {k['eobj']} not within 1e-2 of EF {ef_obj}")
    for tag, r in (("kernel", k), ("tensor path", p)):
        check(r["tbound"] <= ef_obj + 1e-6 * abs(ef_obj),
              f"{tag} trivial bound {r['tbound']} above EF {ef_obj}")
    k["ef"] = ef_obj
    return k


#: The precision phase's runs: (label, kernel, (mode, refinement sweeps or
#: None for the default 64), PH iterations).  Depth is cut to reach frozen
#: solves (about 20-30 PH iterations; 12 for the slower uc-1000) within
#: the time limit.  At "default" with 64 refinement sweeps the guard
#: re-runs every frozen solve at "highest" on all three paths, as the
#: reference's does (tests/test_torch_precision.py); farmer-1000 runs
#: again with 400, where lowered "default" results may be taken.
PRECISION_RUNS = (("farmer-1000 cm=4", "fused_sweeps",
                   (("default", None), ("default", 400)), 30),
                  ("uc_lite-1000", "fused_sweeps_shared",
                   (("default", None), ("high", None)), 25),
                  ("uc-1000", "fused_sweeps_sparse", (("default", None),),
                   5))
#: eobj of a lowered PH run against the "highest" run after as many
#: iterations, f32.  Measured on an H100 (PERF.md): 0 where the guard
#: re-ran every lowered frozen solve at "highest" (farmer-1000,
#: uc_lite-1000 and uc-1000 at "default"), 3.5e-7 at "high" (uc_lite-1000,
#: no trips, 6 lowered results of 29 taken).  1e-4 leaves room for the
#: "default" results taken at 400 refinement sweeps.
PRECISION_EOBJ_TOL = 1e-4


def precision_path(label):
    """``(make_ph, options, solver)`` of a main path by its label."""
    if label.startswith("farmer"):
        return (lambda o, cls: farmer_ph(1000, 4, o, ph_class=cls),
                {"defaultPHrho": 1.0, "convthresh": 1e-6}, None)
    if label.startswith("uc_lite"):
        return (lambda o, cls: uc_ph(1000, o, ph_class=cls),
                UC_MAIN_OPTIONS, None)
    return (lambda o, cls: uc_full_ph(1000, o, ph_class=cls),
            UC_MAIN_OPTIONS, UC_SOLVER)


def phase_precision(cuda_kernels, main, legacy):
    """PH through ``ph_main()`` with the frozen sweeps lowered
    (``solver_options["sweep_precision"]``) on the three main paths at full
    width: farmer-1000 at "default" (with 64 and with 400 refinement
    sweeps), uc_lite-1000 at "default" and "high", uc-1000 at "default".
    Each run's launch counts are read around
    exactly that run: its kernel must have run lowered at the mode (and
    ``fused_sweeps`` at "high" runs exact, so no farmer run there), with no
    plain sweep.  Every run here is the legacy loop (megastep 1): the
    phase measures the guard, whose full-precision re-run only the legacy
    frozen path has (a megastep window sends a trip to the next refresh).
    Printed beside the same path's "highest" legacy run (``legacy``, from
    the megastep phase when it ran, else run here at the same depth; the
    EF from ``main``): the
    PH rate, lowered frozen solves, guard trips, lowered results taken,
    refinement-phase sweeps, lowered launches by mode, eobj after as many
    iterations, eobj against the HiGHS EF (farmer, uc_lite) and the
    trivial bound, which the refresh computes at full precision.  Returns
    {(label, mode): result} for the default refinement, {(label, mode,
    sweeps): result} for another."""
    from tpusppy_torch.ef import solve_ef
    from tpusppy_torch.solvers import admm

    print("precision: every run in the legacy loop (megastep 1), where "
          "the guard re-runs a tripped lowered solve at full precision",
          flush=True)
    out = {}
    for label, kernel, precs, iters in PRECISION_RUNS:
        make_ph, options, solver = precision_path(label)
        solver = dict(solver or {}, megastep=1)
        ref = legacy.get(label)
        if ref is None or len(ref["decisions"]) <= iters:
            _, ref = run_path(cuda_kernels, kernel, make_ph, "auto", iters,
                              options, solver)
        ef_obj = main.get(label, {}).get("ef")
        ref_eobj = ref["decisions"][iters]["eobj"]
        for prec, refine in precs:
            tag = prec if refine is None else f"{prec}, refine {refine}"
            more = {} if refine is None else {
                "precision_refine_iters": refine}
            admm.refinement_sweeps(reset=True)
            ph, r = run_path(cuda_kernels, kernel, make_ph, "auto", iters,
                             options, dict(solver, sweep_precision=prec,
                                           **more))
            r["refine_sweeps"] = admm.refinement_sweeps(reset=True)
            lowered = {k: v for k, v in r["lowered"].items() if v}
            rel = abs(r["eobj"] - ref_eobj) / abs(ref_eobj)
            print(f"precision {label} [{tag}] f32: "
                  f"ph_it_per_s={r['rate']:.3f} (highest "
                  f"{ref['rate']:.3f}) lowered_frozen_solves="
                  f"{r['lowered_solves']:.0f} guard_trips="
                  f"{r['guard_trips']:.0f} lowered_accepted="
                  f"{r['lowered_accepted']:.0f} "
                  f"refine_sweeps={r['refine_sweeps']} "
                  f"lowered_launches={lowered} launches={r['launches']} "
                  f"sweep_blocks_per_iter={r['sweep_blocks_per_iter']:.2f} "
                  f"eobj={r['eobj']:.4f} tbound={r['tbound']:.4f}; highest "
                  f"after {iters} iterations eobj={ref_eobj:.4f} tbound="
                  f"{ref['tbound']:.4f}, rel {rel:.3e} (tol "
                  f"{PRECISION_EOBJ_TOL:.0e}); {CARD}", flush=True)
            check(r["launches"] > 0 and r["plain_calls"] == 0,
                  f"precision {label} [{tag}]: launches {r['launches']}, "
                  f"plain sweeps {r['plain_calls']}")
            key = f"{kernel}:{prec}"
            check(lowered.get(key, 0) > 0 and set(lowered) == {key},
                  f"precision {label} [{tag}]: lowered launches {lowered}, "
                  f"wanted {key}")
            check(r["iters"] == iters, f"precision {label} [{tag}] ran "
                  f"{r['iters']} of {iters} PH iterations")
            check(r["lowered_solves"] > 0 and r["guard_trips"]
                  + r["lowered_accepted"] <= r["lowered_solves"],
                  f"precision {label} [{tag}]: {r['lowered_solves']} "
                  f"lowered frozen solves, {r['guard_trips']} guard trips, "
                  f"{r['lowered_accepted']} accepted")
            check(rel <= PRECISION_EOBJ_TOL, f"precision {label} [{tag}]: "
                  f"eobj {r['eobj']} parts from the highest run's "
                  f"{ref_eobj} by {rel:.3e}")
            if label.startswith(("farmer", "uc_lite")):
                if ef_obj is None:
                    ef_obj = solve_ef(ph.batch, solver="highs")[0]
                rel_ef = abs(r["eobj"] - ef_obj) / abs(ef_obj)
                print(f"precision {label} [{tag}]: eobj vs EF {ef_obj:.4f} "
                      f"rel {rel_ef:.3e}; {CARD}", flush=True)
                check(rel_ef <= 1e-2, f"precision {label} [{tag}]: eobj "
                      f"{r['eobj']} not within 1e-2 of EF {ef_obj}")
                check(r["tbound"] <= ef_obj + 1e-6 * abs(ef_obj),
                      f"precision {label} [{tag}]: trivial bound "
                      f"{r['tbound']} above EF {ef_obj}")
            else:
                # no EF at S=1000: the bound is the refresh's, at full
                # precision in both runs
                check(abs(r["tbound"] - ref["tbound"])
                      <= 1e-6 * abs(ref["tbound"]),
                      f"precision {label} [{tag}]: trivial bound "
                      f"{r['tbound']} against the highest run's "
                      f"{ref['tbound']}")
            out[(label, prec) if refine is None
                else (label, prec, refine)] = r
    # at "default" the guard re-runs most frozen solves at "highest", as
    # the reference's does; the eobj checks must still see lowered results
    accepted = sum(r["lowered_accepted"] for r in out.values())
    print(f"precision: {accepted:.0f} lowered frozen solves accepted over "
          f"{sum(r['lowered_solves'] for r in out.values()):.0f}; {CARD}",
          flush=True)
    check(accepted > 0, "precision: no lowered frozen solve was accepted")
    return out


#: The farmer-1000 wheel: the main path's PH (f32, eps 1e-5, rho 1) as its
#: hub, 30 iterations at most (100 before the resilience phase came, 50
#: before the service phase), with the Lagrangian,
#: XhatShuffle (3 donors a pass) and XhatXbar spokes solving in f64, on one
#: card (bench.py's wheel at the repo's full farmer size); the hub-only
#: in-wheel farmer-1000 wheel 32 (100 before the service phase).
WHEEL_ITERS = 30
HUB_ONLY_ITERS = 32
WHEEL_HUB = {"rel_gap": 1e-3, "abs_gap": 1.0, "linger_secs": 5.0}
WHEEL_SOLVER = {"dtype": "float32", "eps_abs": 1e-5, "eps_rel": 1e-5}
#: uc-1000's hub and Lagrangian spoke: the uc phase's PH, 4 iterations (10
#: before the service phase), the spoke bounding from donor duals alone
#: (bench_uc.py:442-448, the donors' budget cut from 120 to 60 s to fit the
#: time limit)
UC_WHEEL_ITERS = 4
UC_DONORS = {"k": 24, "budget_s": 60, "time_limit": 20}


def wheel_dicts(make_opt_kwargs, spokes, hub_options, hub_opt_class=None):
    """(hub_dict, spoke dicts) of a PH hub and ``spokes`` (spoke class, opt
    class, more options), each cylinder's opt built from
    ``make_opt_kwargs()``; the hub's opt is a ``hub_opt_class`` (PH by
    default)."""
    from tpusppy_torch.cylinders import PHHub
    from tpusppy_torch.opt.ph import PH

    def spoke(sc, oc, extra):
        kw = make_opt_kwargs()
        kw["options"].update(extra)
        return {"spoke_class": sc, "opt_class": oc, "opt_kwargs": kw}

    hub = {"hub_class": PHHub, "hub_kwargs": {"options": hub_options},
           "opt_class": hub_opt_class or PH, "opt_kwargs": make_opt_kwargs()}
    return hub, [spoke(*sp) for sp in spokes]


#: What :func:`wheel_clock` keeps of each window's bound pass.
PASS_KEYS = ("bound_outer", "bound_inner_obj", "bound_inner_feas",
             "bound_sweeps", "int_feas_cands", "int_best_idx",
             "int_rcfix_slots", "bound_outer_base")


def wheel_clock():
    """A hub PH class (:func:`clocked`) that stamps the end of Iter0, of
    every legacy iteration and of every window with the graph captures so
    far (all cylinders), and keeps each window's bound pass
    (:data:`PASS_KEYS`) in ``opt.passes``."""
    from tpusppy_torch.obs import metrics
    from tpusppy_torch.opt.ph import PH

    def stamp(opt, meas):
        if not hasattr(opt, "stamps"):       # the end of Iter0
            opt.stamps = []
            opt.passes = []
        opt.stamps.append((opt._iter, time.perf_counter(),
                           metrics.value("device_loop.captures")))
        if meas is not None and meas.get("bound_computed"):
            opt.passes.append({k: meas[k] for k in PASS_KEYS if k in meas})

    return clocked(PH, stamp)


def stamp_rate(stamps, t_from=None):
    """PH iterations a second over the stamps (after ``t_from``, a
    ``time.perf_counter()``, where given)."""
    if t_from is not None:
        stamps = [st for st in stamps if st[1] >= t_from]
    if len(stamps) < 2:
        return float("nan")
    return ((stamps[-1][0] - stamps[0][0])
            / max(stamps[-1][1] - stamps[0][1], 1e-9))


def spin(hub, spokes, resume=None):
    """Spin a wheel (``resume``: a checkpoint directory); returns
    (spinner, wall seconds)."""
    from tpusppy_torch.spin_the_wheel import WheelSpinner

    t0 = time.perf_counter()
    ws = WheelSpinner(hub, spokes, resume=resume).spin()
    return ws, time.perf_counter() - t0


def print_cylinders(label, ws, hub_iters):
    """Each cylinder's launches (its thread's own view), launches per hub
    iteration, host syncs, solves, host-exact straggler re-solves and
    stream."""
    for name, st in ws.stats.items():
        launches = {f"{t}:{k}": v for (t, k), v in st["launches"].items()}
        n = st["launches"].get(("launches", "fused_sweeps"), 0) + \
            st["launches"].get(("launches", "fused_sweeps_sparse"), 0)
        print(f"{label} {name}: launches={launches} "
              f"per_hub_iter={n / max(hub_iters, 1):.2f} "
              f"host_syncs={st['host_syncs']} solves={st['solves']} "
              f"rescued={st['rescued']} stream={st['stream']}",
              flush=True)


def check_cylinders(label, ws, kernel, spoke_kernel):
    """The hub launched ``kernel`` and each spoke ``spoke_kernel`` (None:
    nothing), and no other sweep kernel or plain version, each cylinder on
    a stream of its own that is not the default."""
    import torch

    streams = [st["stream"] for st in ws.stats.values()]
    check(None not in streams and len(set(streams)) == len(streams)
          and torch.cuda.default_stream().cuda_stream not in streams,
          f"{label}: the cylinders' streams {streams} are not distinct "
          "non-default streams")
    for name, st in ws.stats.items():
        want = kernel if name.startswith("hub:") else spoke_kernel
        sweep = {k: v for k, v in st["launches"].items()
                 if k[0] in ("launches", "plain_calls") and v}
        check(set(sweep) == ({("launches", want)} if want else set()),
              f"{label} {name}: launched {sweep}, wanted {want} only")
    check(not ws.spoke_errors and not ws.hung_spokes,
          f"{label}: spoke errors {ws.spoke_errors}, hung "
          f"{ws.hung_spokes}")


def farmer_wheel_kwargs(S, cm):
    from tpusppy_torch.models import farmer

    return {"options": {"defaultPHrho": 1.0, "PHIterLimit": WHEEL_ITERS,
                        "convthresh": -1.0, "batch_cache": True,
                        "xhat_looper_options": {"scen_limit": 3},
                        "solver_options": dict(WHEEL_SOLVER)},
            "all_scenario_names": farmer.scenario_names_creator(S),
            "scenario_creator": farmer.scenario_creator,
            "scenario_creator_kwargs": {"num_scens": S,
                                        "crops_multiplier": cm}}


def uc_wheel_kwargs(S, iters, options, dtype, eps):
    from tpusppy_torch.models import uc

    return {"options": dict(options, PHIterLimit=iters, batch_cache=True,
                            lagrangian_dual_donors=dict(UC_DONORS),
                            lagrangian_skip_solve=True,
                            solver_options=dict(UC_SOLVER, dtype=dtype,
                                                eps_abs=eps, eps_rel=eps)),
            "all_scenario_names": uc.scenario_names_creator(S),
            "scenario_creator": uc.scenario_creator,
            "scenario_creator_kwargs": {"num_scens": S,
                                        "relax_integers": True}}


def uc_donor_wheel(cuda_kernels, label, S, iters, options, dtype, eps):
    """uc at full width: a PH hub and a Lagrangian spoke that bounds from
    donor duals alone; returns (spinner, wall seconds, donors used)."""
    from tpusppy_torch.cylinders import LagrangianOuterBound
    from tpusppy_torch.phbase import PHBase
    from tpusppy_torch.spbase import clear_batch_cache

    clear_batch_cache()
    hub, spokes = wheel_dicts(
        lambda: uc_wheel_kwargs(S, iters, options, dtype, eps),
        [(LagrangianOuterBound, PHBase, {})], {})
    ws, wall = spin(hub, spokes)
    clear_batch_cache()
    donors = getattr(ws.spoke_comms[0].opt, "donor_duals_used", 0)
    print(f"{label} hub+Lagrangian wheel {dtype}: outer="
          f"{ws.BestOuterBound:.6e} (hub trivial bound "
          f"{ws.opt.trivial_bound:.6e}) hub eobj={ws.opt.Eobjective():.6e} "
          f"donor duals used={donors} hub iters={ws.spcomm.stopped_at} "
          f"bounds posted={ws.spoke_comms[0].bounds_posted} "
          f"wall_s={wall:.2f} gap_wall_secs={ws.gap_wall_secs:.2f}",
          flush=True)
    print_cylinders(label, ws, ws.opt._iter)
    # the spoke skips its batched solve: the donors are its bound
    check_cylinders(label, ws, "fused_sweeps_sparse", None)
    check(np.isfinite(ws.BestOuterBound)
          and ws.BestOuterBound >= ws.opt.trivial_bound,
          f"{label}: outer bound {ws.BestOuterBound} not finite and above "
          f"the trivial bound {ws.opt.trivial_bound}")
    check(donors >= 1, f"{label}: no donor dual was used")
    return ws, wall, donors


def phase_wheel(cuda_kernels, main, hub_only=None):
    """The wheel on the card: the farmer-1000 wheel (PH hub, Lagrangian,
    XhatShuffle and XhatXbar spokes, each cylinder on a CUDA stream of its
    own), held to the HiGHS EF, and the uc-1000 hub-and-Lagrangian wheel
    with donor duals.  ``main``: the main phases' results (the farmer
    phase's EF and PH rate alone, run here when it did not run);
    ``hub_only``: the megastep phase's hub-only farmer wheel, whose hub
    rate prints beside this wheel's."""
    from tpusppy_torch.cylinders import (LagrangianOuterBound,
                                         XhatShuffleInnerBound,
                                         XhatXbarInnerBound)
    from tpusppy_torch.ef import solve_ef
    from tpusppy_torch.phbase import PHBase
    from tpusppy_torch.spbase import clear_batch_cache
    from tpusppy_torch.xhat_eval import Xhat_Eval

    label, S, cm = "wheel farmer-1000 cm=4", 1000, 4
    alone = main.get("farmer-1000 cm=4")
    if alone is None:
        _, alone = run_path(cuda_kernels, "fused_sweeps",
                            lambda o, cls: farmer_ph(S, cm, o,
                                                     ph_class=cls),
                            "auto", WHEEL_ITERS,
                            {"defaultPHrho": 1.0, "convthresh": 1e-6})
    clear_batch_cache()
    # the spokes' solves are LPs (prox off; nonants fixed).  In f32 they
    # park at residuals of 1e-3 to 1e-2 at farmer-1000, the reference's
    # f32 solves as much as the port's (scripts/port_wheel_host.py, and
    # tests/test_torch_xhat.py against the reference): no candidate passes
    # the reference's 1e-3 feasibility gate, and the certified Lagrangian
    # bound of f32 duals falls far below the EF.  So the spokes solve in
    # f64, still through fused_sweeps, with the reference's defaults: the
    # 1e-3 gate and at most 64 host-exact straggler rescues a solve
    spoke_opts = {"solver_options": dict(WHEEL_SOLVER, dtype="float64")}
    hub, spokes = wheel_dicts(
        lambda: farmer_wheel_kwargs(S, cm),
        [(LagrangianOuterBound, PHBase, spoke_opts),
         (XhatShuffleInnerBound, Xhat_Eval, spoke_opts),
         (XhatXbarInnerBound, Xhat_Eval, spoke_opts)], WHEEL_HUB,
        wheel_clock())
    ws, wall = spin(hub, spokes)
    clear_batch_cache()
    ef = alone.get("ef")
    if ef is None:
        ef, _ = solve_ef(ws.opt.batch, solver="highs")
    ob, ib = ws.BestOuterBound, ws.BestInnerBound
    abs_gap, rel_gap = ws.spcomm.compute_gaps()
    stamps = ws.opt.stamps
    it_done, reason = ws.spcomm.stopped_at
    rate = (stamps[-1][0] / (stamps[-1][1] - stamps[0][1])
            if len(stamps) > 1 else float("nan"))
    half = next(c for k, _, c in stamps if k >= it_done // 2)
    print(f"{label}: outer={ob:.4f} inner={ib:.4f} EF={ef:.4f} "
          f"(outer-EF)/|EF|={(ob - ef) / abs(ef):.3e} "
          f"(inner-EF)/|EF|={(ib - ef) / abs(ef):.3e} rel_gap={rel_gap:.3e} "
          f"abs_gap={abs_gap:.4f} hub trivial bound="
          f"{ws.opt.trivial_bound:.4f}; hub stopped at iteration {it_done} "
          f"({reason}); hub PH it/s in the wheel {rate:.3f} against "
          f"{alone['rate']:.3f} alone; bounds posted "
          f"{[c.bounds_posted for c in ws.spoke_comms]}; graph captures at "
          f"hub iteration {it_done // 2}: {half:.0f}, at the end: "
          f"{stamps[-1][2]:.0f}; wall_s={wall:.2f} "
          f"gap_wall_secs={ws.gap_wall_secs:.2f} {CARD}", flush=True)
    print_cylinders(label, ws, it_done)
    if hub_only is not None:
        print(f"farmer-1000 hub PH it/s: in the three-spoke wheel {rate:.3f}, "
              f"in the hub-only in-wheel wheel {hub_only['rate']:.3f}, alone "
              f"{alone['rate']:.3f} {CARD}", flush=True)
    check_cylinders(label, ws, "fused_sweeps", "fused_sweeps")
    check(np.isfinite(ob) and ob <= ef + 1e-6 * abs(ef),
          f"{label}: outer bound {ob} not finite and at most EF {ef}")
    check(ob > ws.opt.trivial_bound, f"{label}: outer bound {ob} not above "
          f"the hub's trivial bound {ws.opt.trivial_bound}")
    # the inner bound is an ADMM objective at a fixed first stage, not a
    # certified number: held to the main path's f32 level
    check(np.isfinite(ib) and abs(ib - ef) <= 1e-2 * abs(ef)
          and ib >= ef - 1e-4 * abs(ef),
          f"{label}: inner bound {ib} not within 1e-2 of EF {ef} (and "
          "above it less 1e-4)")
    check(ob <= ib, f"{label}: outer bound {ob} above inner {ib}")
    cache = ws.local_nonant_cache
    check(cache is not None and cache[0].sum() <= 500 * cm + 1e-3,
          f"{label}: the first stage plants more than {500 * cm} acres")
    check(all(c.bounds_posted > 0 for c in ws.spoke_comms),
          f"{label}: a spoke posted no bound")
    check(stamps[-1][2] == half, f"{label}: graph captures grew from "
          f"{half} at hub iteration {it_done // 2} to {stamps[-1][2]}")
    out = {"farmer": dict(outer=ob, inner=ib, ef=ef, rel_gap=rel_gap,
                          abs_gap=abs_gap, rate=rate, alone=alone["rate"],
                          stopped=(it_done, reason), stats=ws.stats,
                          gap_wall_secs=ws.gap_wall_secs)}

    ws, wall, donors = uc_donor_wheel(
        cuda_kernels, "wheel uc-1000", 1000, UC_WHEEL_ITERS,
        UC_MAIN_OPTIONS, "float32", 1e-5)
    out["uc"] = dict(outer=ws.BestOuterBound, donors=donors,
                     trivial=ws.opt.trivial_bound, stats=ws.stats)
    return out


#: The megastep phase's legacy runs (megastep 1) of the main paths, each
#: cut to the depth the precision phase reads them at.
#: (uc_lite-1000 30 and uc-1000 12 before the resilience phase cut them,
#: with the precision phase's, to make room for it; at 15
#: uc_lite-1000's lowered eobj sits 1.057e-2 from the EF, past the
#: precision phase's 1e-2)
#: (uc-1000 8 before the service phase)
LEGACY_ITERS = {"farmer-1000 cm=4": 30, "uc_lite-1000": 25, "uc-1000": 5}
#: uc's frozen iterates never meet the frozen acceptance ladder (1e-2) at
#: bench_uc.py's settings: its refresh leaves stalled QP scenarios the host
#: rescue does not take (n = 2928 > 2000), every legacy frozen attempt is
#: refused, and so no window starts (the reference's gate too).  The uc
#: windows are run with the ladder off in both protocols.
UC_NO_LADDER = {"straggler_tol_qp": 1e30}
#: megastep against legacy, eobj after as many iterations: f32 at the main
#: paths' level; uc-1000 at 1e-3, since f32 rounding alone parts two
#: uc-1000 runs by up to 1.2e-4 (ROADMAP Queue 3, scripts/port_uc_parity.py)
#: and the window assembles the PH objective on the device in f32 where the
#: legacy loop does it on the host in f64; the f64 golden at 1e-7
MEGA_EOBJ_TOL = {"farmer-1000 cm=4": 1e-4, "uc_lite-1000": 1e-4,
                 "uc-1000": 1e-3}
MEGA_F64_TOL = 1e-7
#: The hub-only farmer-1000 wheel's solver: the main path's eps in f64.
HUB_ONLY_SOLVER = {"dtype": "float64", "eps_abs": 1e-5, "eps_rel": 1e-5}


def print_protocol(label, k):
    """A run's host syncs a PH iteration by kind, and its windows."""
    print(f"{label} [{'megastep N=%d' % k['n_req'] if k['n_req'] else 'legacy'}]"
          f": ph_it_per_s={k['rate']:.3f} host_syncs_per_iter="
          f"{k['syncs_per_iter']:.3f} (flag reads "
          f"{k['flag_reads_per_iter']:.3f}, packed fetches "
          f"{k['packed_fetches_per_iter']:.3f}, other "
          f"{k['other_syncs_per_iter']:.3f}) megasteps={k['megasteps']:.0f} "
          f"mega_iterations={k['mega_iters']:.0f} legacy_iterations="
          f"{k['legacy_iters']} refresh_hits={k['refresh_hits']:.0f} "
          f"window_launches={k['window_launches']} {CARD}", flush=True)


def hold_megastep(label, kernel, k, legacy, tol, windows=True):
    """A main path's megastep run ``k`` against its ``legacy`` run: the
    windows ran (with ``windows``; else the gate that kept them from
    starting is printed and held: the last measurement never clean),
    every iteration is counted once, the kernel launched from inside the
    windows, and eobj after as many iterations agrees."""
    print_protocol(label, k)
    print_protocol(label, legacy)
    n = legacy["iters"]
    a, b = k["decisions"][n]["eobj"], legacy["decisions"][n]["eobj"]
    rel = abs(a - b) / abs(b)
    print(f"{label}: eobj after {n} iterations, megastep {a:.6f} legacy "
          f"{b:.6f}, rel {rel:.3e} (tol {tol:.0e})", flush=True)
    check(k["n_req"] >= 2, f"{label}: the default run asked for no window")
    check(k["mega_iters"] + k["legacy_iters"] == k["iters"],
          f"{label}: {k['mega_iters']} window and {k['legacy_iters']} "
          f"legacy iterations for {k['iters']} run")
    if windows:
        check(k["megasteps"] > 0,
              f"{label}: the default run ran no megastep window")
        check(k["window_launches"].get(kernel, 0) > 0,
              f"{label}: {kernel} did not launch from inside a window "
              f"({k['window_launches']})")
    else:
        print(f"{label}: no window started: the readiness gate wants the "
              f"last measurement clean, and its worst residual "
              f"{k['worst_residual']:.3e} stays above the acceptance "
              f"ladder {k['tol_qp']:.0e} (every legacy frozen attempt is "
              "refused too), so every iteration ran the legacy body",
              flush=True)
        check(k["megasteps"] == 0 and k["worst_residual"] > k["tol_qp"],
              f"{label}: windows {k['megasteps']}, worst residual "
              f"{k['worst_residual']} against {k['tol_qp']}")
    check(legacy["megasteps"] == 0 and legacy["n_req"] == 0,
          f"{label}: the megastep 1 run ran windows")
    check(rel <= tol, f"{label}: megastep and legacy eobj differ by {rel:.3e}")
    return rel


def inwheel_wheel(cuda_kernels, label, make_opt_kwargs, kernel, iters):
    """A PH hub with in_wheel_bounds and no spoke; returns (spinner, the
    hub's PH rate, bound passes)."""
    from tpusppy_torch.obs import metrics
    from tpusppy_torch.spbase import clear_batch_cache

    def kwargs():
        kw = make_opt_kwargs()
        kw["options"].update(in_wheel_bounds=True, PHIterLimit=iters)
        return kw

    clear_batch_cache()
    hub, _ = wheel_dicts(kwargs, [], {"rel_gap": 1e-3}, wheel_clock())
    with metrics.window() as w:
        ws, wall = spin(hub, [])
        passes = w.delta("megastep.bound_passes")
        infeasible = w.delta("megastep.bound_pass_infeasible")
        rescues = w.delta("megastep.bound_rescues")
    declines = getattr(ws.opt, "_inwheel_rescue_declines", 0)
    clear_batch_cache()
    opt, stamps = ws.opt, ws.opt.stamps
    rate = (stamps[-1][0] / (stamps[-1][1] - stamps[0][1])
            if len(stamps) > 1 else float("nan"))
    it_done, reason = ws.spcomm.stopped_at
    ob, ib = ws.BestOuterBound, ws.BestInnerBound
    outer_src = ("M" if ob == getattr(opt, "inwheel_outer_bound", None)
                 else "T (the trivial bound)")
    print(f"{label} hub-only in-wheel wheel: outer={ob:.6f} (from "
          f"{outer_src}) inner={ib:.6f} (from "
          f"{getattr(opt, 'inwheel_inner_source', 'none')}) hub stopped at "
          f"iteration {it_done} ({reason}); bound passes {passes:.0f}, "
          f"infeasible evaluations {infeasible:.0f}, host rescues "
          f"{rescues:.0f} ({declines} declined); hub PH it/s {rate:.3f}; "
          f"spokes "
          f"{len(ws.spoke_comms)}; wall_s={wall:.2f} {CARD}", flush=True)
    print_cylinders(label, ws, it_done)
    check(not ws.spoke_comms and list(ws.stats) == ["hub:PHHub"],
          f"{label}: a spoke ran ({list(ws.stats)})")
    check(passes > 0, f"{label}: no in-wheel bound pass ran")
    check(ws.stats["hub:PHHub"]["launches"].get(("launches", kernel), 0)
          > 0, f"{label}: the hub launched no {kernel}")
    return ws, rate


def phase_megastep(cuda_kernels, main, golden):
    """The megastep against the legacy loop on every path, the window's
    host syncs, each kernel launched from inside windows, and hub-only
    wheels certified by the windows' own bound passes.  ``main``: the
    main phases' runs (megastep auto), ``golden``: the uc S=10 golden's
    EF.  uc's windows run with the acceptance ladder off
    (:data:`UC_NO_LADDER`).  Returns the legacy runs and the hub-only
    farmer wheel's results."""
    from tpusppy_torch.ef import solve_ef

    out = {"legacy": {}}
    paths = (("farmer-1000 cm=4", "fused_sweeps",
              lambda o, cls: farmer_ph(1000, 4, o, ph_class=cls),
              {"defaultPHrho": 1.0, "convthresh": 1e-6}, None, 100),
             ("uc_lite-1000", "fused_sweeps_shared",
              lambda o, cls: uc_ph(1000, o, ph_class=cls), UC_MAIN_OPTIONS,
              None, 50),
             ("uc-1000", "fused_sweeps_sparse",
              lambda o, cls: uc_full_ph(1000, o, ph_class=cls),
              UC_MAIN_OPTIONS, UC_SOLVER, 20))
    for label, kernel, make_ph, options, solver, iters in paths:
        k = main.get(label)
        if k is None:
            _, k = run_path(cuda_kernels, kernel, make_ph, "auto", iters,
                            options, solver)
        _, legacy = run_path(cuda_kernels, kernel, make_ph, "auto",
                             LEGACY_ITERS[label], options,
                             dict(solver or {}, megastep=1))
        out["legacy"][label] = legacy
        hold_megastep(label, kernel, k, legacy, MEGA_EOBJ_TOL[label],
                      windows=kernel != "fused_sweeps_sparse")

    # uc's windows, the ladder off in both protocols: uc-1000 in f32, and
    # the f64 golden after each of its first iterations
    make1000 = paths[2][2]
    runs = [run_path(cuda_kernels, "fused_sweeps_sparse", make1000, "auto",
                     LEGACY_ITERS["uc-1000"], UC_MAIN_OPTIONS | UC_NO_LADDER,
                     dict(UC_SOLVER, megastep=mega))[1] for mega in (0, 1)]
    hold_megastep("uc-1000, ladder off", "fused_sweeps_sparse", *runs,
                  MEGA_EOBJ_TOL["uc-1000"])
    make10 = (lambda o, cls: uc_full_ph(10, o, ph_class=cls))
    g, legacy = (run_path(cuda_kernels, "fused_sweeps_sparse", make10,
                          "auto", UC_FULL_TENSOR_ITERS,
                          UC_FULL_GOLDEN_OPTIONS | UC_NO_LADDER,
                          dict(UC_SOLVER, megastep=mega), dtype="float64",
                          eps=1e-8)[1] for mega in (0, 1))
    rels = [abs(a["eobj"] - b["eobj"]) / abs(b["eobj"])
            for a, b in zip(g["decisions"][1:], legacy["decisions"][1:])]
    print(f"golden uc S=10 f64, ladder off: megastep against legacy eobj "
          f"rel diff after each of iterations 1-{UC_FULL_TENSOR_ITERS}: "
          f"{['%.3e' % r for r in rels]} (tol {MEGA_F64_TOL:.0e})",
          flush=True)
    hold_megastep("golden uc S=10 f64, ladder off", "fused_sweeps_sparse",
                  g, legacy, MEGA_F64_TOL)
    check(len(rels) == UC_FULL_TENSOR_ITERS and max(rels) <= MEGA_F64_TOL,
          f"golden uc S=10 f64: megastep and legacy eobj differ by {rels}")

    # hub-only wheels: the windows' bound passes certify with no spoke.
    # The farmer hub solves in f64 (HUB_ONLY_SOLVER): the host rescue runs
    # HiGHS at its default tolerances, as the reference's does, and an f32
    # consensus leaves the land rows a few 1e-6 over, where every rescue
    # declines; an f64 consensus meets HiGHS's tolerance on some rescues
    # (the device evaluation misses the 1e-3 gate in f64 too)
    label, S, cm = "megastep farmer-1000 cm=4 f64 hub", 1000, 4
    ef = main.get("farmer-1000 cm=4", {}).get("ef")

    def hub_only_kwargs():
        kw = farmer_wheel_kwargs(S, cm)
        kw["options"]["solver_options"] = dict(HUB_ONLY_SOLVER)
        return kw

    ws, rate = inwheel_wheel(cuda_kernels, label, hub_only_kwargs,
                             "fused_sweeps", HUB_ONLY_ITERS)
    if ef is None:
        ef, _ = solve_ef(ws.opt.batch, solver="highs")
    ob, ib = ws.BestOuterBound, ws.BestInnerBound
    print(f"{label} hub-only wheel against EF {ef:.4f}: (outer-EF)/|EF|="
          f"{(ob - ef) / abs(ef):.3e} (inner-EF)/|EF|="
          f"{(ib - ef) / abs(ef):.3e}", flush=True)
    check(np.isfinite(ob) and ob <= ef + 1e-6 * abs(ef),
          f"{label}: outer bound {ob} not finite and at most EF {ef}")
    check(np.isfinite(ib) and abs(ib - ef) <= 1e-2 * abs(ef)
          and ib >= ef - 1e-4 * abs(ef),
          f"{label}: inner bound {ib} not within 1e-2 of EF {ef} (and "
          "above it less 1e-4)")
    check(ob <= ib, f"{label}: outer bound {ob} above inner {ib}")
    out["farmer_wheel"] = dict(outer=ob, inner=ib, ef=ef, rate=rate)

    ef10 = golden.get("uc10_ef")
    ws, _ = inwheel_wheel(
        cuda_kernels, "megastep golden uc S=10 f64, ladder off",
        lambda: uc_wheel_kwargs(10, UC_FULL_GOLDEN_ITERS,
                                UC_FULL_GOLDEN_OPTIONS | UC_NO_LADDER,
                                "float64", 1e-8),
        "fused_sweeps_sparse", UC_FULL_GOLDEN_ITERS)
    if ef10 is None:
        ef10, _ = solve_ef(ws.opt.batch, solver="highs")
    ob = ws.BestOuterBound
    print(f"megastep golden uc S=10 hub-only wheel: outer {ob:.6f} against "
          f"EF {ef10:.6f}, rel {(ob - ef10) / abs(ef10):.3e}", flush=True)
    check(ob <= ef10 + 1e-6 * abs(ef10),
          f"golden uc S=10 in-wheel outer bound {ob} above EF {ef10}")
    return out


#: Bundled farmer-1000 (crops_multiplier=4): 300 bundles, np.array_split's
#: 100 of 4 scenarios and 200 of 3, two shape buckets: (S_b, m, n).
BUNDLE_OPTIONS = {"bundles_per_rank": 300, "shape_buckets": True}
BUNDLE_BUCKETS = ((200, 84, 108), (100, 112, 140))
#: Bundled netdes-1000 (10 nodes) in the same 300 bundles: its buckets
NETDES_BUCKETS = ((200, 105, 100), (100, 140, 125))
#: The bundled PH's and the bundled wheel's depths, cut to keep the whole
#: run near 1000 s (20 and 8 until the integer phase came, 12 and 4 until
#: the resilience phase came, 6 and 2 until the service phase came)
BUNDLE_ITERS = 4
BUNDLE_WHEEL_ITERS = 2
BUNDLE_MEGA_TOL = 1e-4
#: The bucketed in-wheel wheels (hub-only, bound pass in each window):
#: bundled farmer-1000 with its hub in f64 (the megastep phase's hub-only
#: solver) and bundled netdes-1000 (the integer pass; f64) with an
#: XhatShuffle spoke on the bucketed evaluation; their PH depths
BUNDLE_INWHEEL_ITERS = 8
BUNDLE_NETDES_ITERS = 4
#: netdes-1000's EF MIP optimum (10 nodes, seed 0; PERF.md §6)
NETDES_1000_MIP = 357.076
#: hydro S=9 in 3 proper bundles at the reference's settings
#: (tests/test_rho_bundles_io.py): f64, rho 1, convthresh 1e-5
HYDRO_BUNDLE_OPTIONS = {"defaultPHrho": 1.0, "PHIterLimit": 60,
                        "convthresh": 1e-5, "bundles_per_rank": 3}


def bundled_farmer_ph(options, ph_class=None):
    return farmer_ph(1000, 4, dict(options, **BUNDLE_OPTIONS), ph_class)


def phase_bundles(cuda_kernels, main):
    """Scenario bundling and shape buckets on the card: ``fused_sweeps`` at
    both bucket shapes against its plain version; bundled farmer-1000
    through ``ph_main()`` at the default options (bucketed windows) against
    the farmer EF and against the same PH in the legacy loop; a bundled
    wheel (PH hub, Lagrangian and XhatShuffle spokes in f64); and the
    hydro golden in 3 proper bundles.  ``main``: the main phases' runs
    (the farmer EF, computed here when the farmer phase did not run)."""
    import torch

    from tpusppy_torch.cylinders import (LagrangianOuterBound,
                                         XhatShuffleInnerBound)
    from tpusppy_torch.ef import solve_ef
    from tpusppy_torch.ir import BucketedBatch, ScenarioBatch
    from tpusppy_torch.models import farmer, hydro
    from tpusppy_torch.opt.ph import PH
    from tpusppy_torch.phbase import PHBase
    from tpusppy_torch.spbase import clear_batch_cache
    from tpusppy_torch.xhat_eval import Xhat_Eval

    # the mode fused_sweeps' layout picks at each bucket (the kernels
    # phase holds it there against its plain version): the runs below must
    # launch that mode only
    modes32 = {dense_layout_of(cuda_kernels, S, m, n, torch.float32)["mode"]
               for S, m, n in BUNDLE_BUCKETS}
    check(len(modes32) == 1, f"the buckets' f32 modes differ: {modes32}")
    mode32 = modes32.pop()
    modes64 = {dense_layout_of(cuda_kernels, S, m, n, torch.float64)["mode"]
               for S, m, n in BUNDLE_BUCKETS + NETDES_BUCKETS}
    print(f"bundled buckets' fused_sweeps modes: f32 {mode32}, f64 "
          f"{sorted(modes64)}", flush=True)

    ef = main.get("farmer-1000 cm=4", {}).get("ef")
    if ef is None:
        from tpusppy_torch.spbase import build_batch

        b, _ = build_batch(farmer.scenario_names_creator(1000),
                           farmer.scenario_creator,
                           {"num_scens": 1000, "crops_multiplier": 4})
        ef, _ = solve_ef(b, solver="highs")
    label = "bundled farmer-1000 cm=4"
    options = {"defaultPHrho": 1.0, "convthresh": 1e-6}
    ph, k = run_path(cuda_kernels, "fused_sweeps",
                     lambda o, cls: bundled_farmer_ph(o, cls), "auto",
                     BUNDLE_ITERS, options, mode=mode32)
    other = {name: cuda_kernels.launches[name]
             for name in ("fused_sweeps_shared", "fused_sweeps_sparse")}
    b = ph.batch
    buckets = [(int(idx.size), sub.num_rows, sub.num_vars)
               for idx, sub in getattr(b, "buckets", [])]
    a_mb = sum(S * m * n for S, m, n in buckets) * 4 / 1e6
    per_bucket = [d.get(("launches", "fused_sweeps"), 0)
                  for d in ph.bucket_window_launches]
    refused = sum(d["rejected"] for d in k["decisions"])
    print(f"{label}: buckets (S_b, m, n) {buckets}, bookkeeping "
          f"{b.c.shape}, A {a_mb:.2f} MB in f32; eobj={k['eobj']:.4f} "
          f"EF={ef:.4f} rel {abs(k['eobj'] - ef) / abs(ef):.3e} "
          f"tbound={k['tbound']:.4f} ph_it_per_s={k['rate']:.3f} "
          f"sweep_blocks_per_iter={k['sweep_blocks_per_iter']:.2f} "
          f"refused frozen iterates {refused:.0f} (refresh hits "
          f"{k['refresh_hits']:.0f}) window launches by bucket "
          f"{per_bucket} modes={k['modes']} other sweep kernels {other} "
          f"{CARD}", flush=True)
    check(isinstance(b, BucketedBatch) and buckets == list(BUNDLE_BUCKETS),
          f"{label}: the batch's buckets are {buckets}, wanted "
          f"{list(BUNDLE_BUCKETS)}")
    check(abs(k["eobj"] - ef) <= 1e-2 * abs(ef),
          f"{label}: eobj {k['eobj']} not within 1e-2 of EF {ef}")
    check(k["tbound"] <= ef + 1e-6 * abs(ef),
          f"{label}: trivial bound {k['tbound']} above EF {ef}")
    check(k["launches"] > 0 and k["plain_calls"] == 0,
          f"{label}: fused_sweeps launched {k['launches']} times, its "
          f"plain version ran {k['plain_calls']}")
    check(not any(other.values()), f"{label}: other sweep kernels ran "
          f"{other}")
    check(len(per_bucket) == 2 and all(v > 0 for v in per_bucket),
          f"{label}: fused_sweeps did not launch inside the windows for "
          f"both buckets ({per_bucket})")
    _, legacy = run_path(cuda_kernels, "fused_sweeps",
                         lambda o, cls: bundled_farmer_ph(o, cls), "auto",
                         BUNDLE_ITERS, options, {"megastep": 1},
                         mode=mode32)
    lrefused = sum(d["rejected"] for d in legacy["decisions"])
    print(f"{label} legacy: refused frozen iterates {lrefused:.0f} "
          f"modes={legacy['modes']} sweep_blocks_per_iter="
          f"{legacy['sweep_blocks_per_iter']:.2f}", flush=True)
    hold_megastep(label, "fused_sweeps", k, legacy, BUNDLE_MEGA_TOL)

    # the bundled wheel: the hub (this PH, 2 iterations at most) with the
    # bucketed dual bound (Lagrangian) and evaluation (XhatShuffle) in f64
    def kwargs():
        kw = farmer_wheel_kwargs(1000, 4)
        kw["options"].update(BUNDLE_OPTIONS, PHIterLimit=BUNDLE_WHEEL_ITERS)
        return kw

    clear_batch_cache()
    spoke_opts = {"solver_options": dict(WHEEL_SOLVER, dtype="float64")}
    hub, spokes = wheel_dicts(
        kwargs, [(LagrangianOuterBound, PHBase, spoke_opts),
                 (XhatShuffleInnerBound, Xhat_Eval, spoke_opts)],
        WHEEL_HUB, wheel_clock())
    ws, wall = spin(hub, spokes)
    clear_batch_cache()
    ob, ib = ws.BestOuterBound, ws.BestInnerBound
    it_done, reason = ws.spcomm.stopped_at
    print(f"bundled wheel farmer-1000: outer={ob:.4f} inner={ib:.4f} "
          f"EF={ef:.4f} (outer-EF)/|EF|={(ob - ef) / abs(ef):.3e} "
          f"(inner-EF)/|EF|={(ib - ef) / abs(ef):.3e}; hub stopped at "
          f"iteration {it_done} ({reason}); bounds posted "
          f"{[c.bounds_posted for c in ws.spoke_comms]}; wall_s={wall:.2f} "
          f"{CARD}", flush=True)
    print_cylinders("bundled wheel", ws, it_done)
    check_cylinders("bundled wheel", ws, "fused_sweeps", "fused_sweeps")
    # the hub (f32) launches its buckets' mode; the spokes' (f64) printed
    for name, st in ws.stats.items():
        ran = ran_dense_modes(st["launches"])
        print(f"bundled wheel {name}: fused_sweeps modes {sorted(ran)}",
              flush=True)
        if name.startswith("hub:"):
            check(ran == {mode32}, f"bundled wheel {name}: fused_sweeps "
                  f"modes {sorted(ran)}, wanted {mode32}")
    check(np.isfinite(ob) and ob <= ef + 1e-6 * abs(ef),
          f"bundled wheel: outer bound {ob} not finite and at most EF {ef}")
    check(np.isfinite(ib) and ib >= ef - 1e-4 * abs(ef),
          f"bundled wheel: inner bound {ib} not finite and above EF less "
          "1e-4")
    check(ob <= ib, f"bundled wheel: outer bound {ob} above inner {ib}")
    check(all(c.bounds_posted > 0 for c in ws.spoke_comms),
          "bundled wheel: a spoke posted no bound")

    # the bucketed in-wheel bound pass: bundled farmer-1000 (plain), then
    # bundled netdes-1000 (integer) with HiGHS's EF MIP alongside
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    try:
        netdes_ef = pool.submit(ef_solves, "netdes", 1000,
                                {"num_scens": 1000,
                                 "relax_integers": False})
        inwheel = bundled_inwheel_farmer(cuda_kernels, ef, modes64)
        netdes = bundled_netdes_wheel(cuda_kernels, netdes_ef)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)

    # the hydro golden in f64: 3 proper bundles against the unbundled EF
    names = hydro.scenario_names_creator(9)
    hph = PH(dict(HYDRO_BUNDLE_OPTIONS, solver_options={"dtype": "float64"}),
             names, hydro.scenario_creator)
    cuda_kernels.reset_counts()
    _, heobj, htb = hph.ph_main()
    hef, _ = solve_ef(ScenarioBatch.from_problems(
        [hydro.scenario_creator(nm) for nm in names]), solver="highs")
    print(f"golden hydro S=9 in 3 proper bundles f64: eobj={heobj:.6f} "
          f"tbound={htb:.6f} EF={hef:.6f} rel "
          f"{abs(heobj - hef) / abs(hef):.3e} iterations {hph._iter} "
          f"launches={cuda_kernels.launches['fused_sweeps']}", flush=True)
    check(hph.batch.num_scenarios == 3 and hph.tree.num_stages == 2,
          "the hydro bundles are not a two-stage batch of 3")
    check(cuda_kernels.launches["fused_sweeps"] > 0
          and cuda_kernels.plain_calls["fused_sweeps"] == 0,
          "the hydro golden did not go through fused_sweeps")
    check(abs(heobj - hef) <= 1e-2 * abs(hef),
          f"hydro golden eobj {heobj} not within 1e-2 of EF {hef}")
    check(htb <= hef + 1e-6 * abs(hef),
          f"hydro golden trivial bound {htb} above EF {hef}")
    return {"ph": k, "legacy": legacy, "wheel": (ob, ib, ef),
            "inwheel": inwheel, "netdes": netdes}


def print_bucket_passes(label, opt):
    """The bound passes' launches by bucket, then by evaluation (the
    integer pass's ladder candidates and the re-certification)."""
    bpl = opt.bound_pass_launches
    print(f"{label}: fused_sweeps launches inside bound passes by bucket "
          + "; ".join(
              f"bucket {bi}: " + ", ".join(
                  str(ev.get(("launches", "fused_sweeps"), 0)) for ev in rec)
              for bi, rec in enumerate(bpl))
          + f"; passes {opt.passes}", flush=True)
    check(len(bpl) == 2 and all(
        ev.get(("launches", "fused_sweeps"), 0) > 0
        for rec in bpl for ev in rec),
        f"{label}: fused_sweeps did not launch in the bound pass for both "
        f"buckets ({bpl})")
    return bpl


def bundled_inwheel_farmer(cuda_kernels, ef, modes64):
    """Bundled farmer-1000 (both buckets) as a hub-only in-wheel wheel,
    its hub in f64: the bucketed bound pass in every window; outer <= EF
    + 1e-6 |EF|, inner >= EF - 1e-4 |EF|, outer <= inner."""
    from tpusppy_torch.ir import BucketedBatch
    from tpusppy_torch.obs import metrics
    from tpusppy_torch.spbase import clear_batch_cache

    label = "bundled farmer-1000 cm=4 f64 hub-only in-wheel"

    def kwargs():
        kw = farmer_wheel_kwargs(1000, 4)
        kw["options"].update(BUNDLE_OPTIONS, in_wheel_bounds=True,
                             PHIterLimit=BUNDLE_INWHEEL_ITERS,
                             solver_options=dict(HUB_ONLY_SOLVER))
        return kw

    clear_batch_cache()
    hub, _ = wheel_dicts(kwargs, [], {"rel_gap": 1e-3}, wheel_clock())
    cuda_kernels.reset_counts()
    with metrics.window() as w:
        ws, wall = spin(hub, [])
        d = {k: w.delta(k) for k in (
            "megastep.bound_passes", "megastep.bound_pass_infeasible",
            "megastep.bound_rescues", "dispatch.megasteps")}
    launched = dict(cuda_kernels.launches)
    plain = dict(cuda_kernels.plain_calls)
    ran = {k for k, v in cuda_kernels.dense_modes.items() if v}
    clear_batch_cache()
    check(ran and ran <= modes64, f"{label}: fused_sweeps ran the modes "
          f"{sorted(ran)}, its layout picks {sorted(modes64)} at the "
          "buckets in f64")
    opt = ws.opt
    b = opt.batch
    buckets = [(int(idx.size), sub.num_rows, sub.num_vars)
               for idx, sub in getattr(b, "buckets", [])]
    ob, ib = ws.BestOuterBound, ws.BestInnerBound
    it_done, reason = ws.spcomm.stopped_at
    rate = stamp_rate(opt.stamps)
    print(f"{label}: buckets {buckets}; outer={ob:.6f} (from "
          f"{getattr(opt, 'inwheel_outer_source', '-')}) inner={ib:.6f} "
          f"(from {getattr(opt, 'inwheel_inner_source', '-')}) EF={ef:.4f}"
          f" (outer-EF)/|EF|={(ob - ef) / abs(ef):.3e} (inner-EF)/|EF|="
          f"{(ib - ef) / abs(ef):.3e}; hub stopped at iteration {it_done} "
          f"({reason}); windows {d['dispatch.megasteps']:.0f}, bound passes "
          f"{d['megastep.bound_passes']:.0f} (infeasible "
          f"{d['megastep.bound_pass_infeasible']:.0f}, host rescues "
          f"{d['megastep.bound_rescues']:.0f}); hub PH it/s {rate:.3f}; "
          f"launches {launched} plain {plain}; wall_s={wall:.2f} {CARD}",
          flush=True)
    bpl = print_bucket_passes(label, opt)
    check(isinstance(b, BucketedBatch) and buckets == list(BUNDLE_BUCKETS),
          f"{label}: buckets {buckets}")
    check(d["megastep.bound_passes"] > 0 and opt.passes,
          f"{label}: no bound pass ran inside a window")
    check(launched["fused_sweeps"] > 0 and not any(plain.values())
          and not launched["fused_sweeps_shared"]
          and not launched["fused_sweeps_sparse"],
          f"{label}: launches {launched}, plain versions {plain}")
    check(np.isfinite(ob) and ob <= ef + 1e-6 * abs(ef),
          f"{label}: outer bound {ob} not finite and at most EF {ef}")
    check(np.isfinite(ib) and ib >= ef - 1e-4 * abs(ef),
          f"{label}: inner bound {ib} not finite and above EF less 1e-4")
    check(ob <= ib, f"{label}: outer bound {ob} above inner {ib}")
    return dict(outer=ob, inner=ib, ef=ef, rate=rate, passes=opt.passes,
                bound_pass_launches=bpl, deltas=d, wall=wall)


def bundled_netdes_wheel(cuda_kernels, ef_future):
    """Bundled netdes-1000 (``bundles_per_rank`` 300, ``shape_buckets``,
    f64) with ``in_wheel_bounds``: the bucketed integer pass in every
    window, and an XhatShuffle spoke evaluating through the bucketed
    integer evaluation.  Each pass's tightened outer at least its
    untightened one; outer <= the EF MIP's incumbent, inner >= its best
    bound, outer <= inner; no host escalation raises and no plain version
    runs (:func:`int_wheel`)."""
    from tpusppy_torch.cylinders import XhatShuffleInnerBound
    from tpusppy_torch.ir import BucketedBatch
    from tpusppy_torch.xhat_eval import Xhat_Eval

    label = "bundled netdes-1000 f64 in-wheel integer"
    kw = {"num_scens": 1000, "relax_integers": False}
    opts = dict(NETDES_HUB_ONLY, PHIterLimit=BUNDLE_NETDES_ITERS,
                **BUNDLE_OPTIONS)
    cuda_kernels.reset_counts()
    ws, r = int_wheel(label, lambda: integer_kwargs("netdes", 1000, kw,
                                                   opts),
                      [(XhatShuffleInnerBound, Xhat_Eval, {})],
                      {"rel_gap": NETDES_GAP})
    opt = ws.opt
    b = opt.batch
    buckets = [(int(idx.size), sub.num_rows, sub.num_vars)
               for idx, sub in getattr(b, "buckets", [])]
    bpl = print_bucket_passes(label, opt)
    ef = ef_future.result()
    ob, ib = r["outer"], r["inner"]
    shuffle = ws.spoke_comms[0]
    print(f"{label}: buckets {buckets}; EF MIP status {ef['status']} "
          f"incumbent {ef['incumbent']:.6f} best bound "
          f"{ef['dual_bound']:.6f} ({ef['mip_s']:.1f} s; golden "
          f"{NETDES_1000_MIP}); XhatShuffle bound {shuffle.bound:.6f}, "
          f"posted {shuffle.bounds_posted}", flush=True)
    check(isinstance(b, BucketedBatch) and buckets == list(NETDES_BUCKETS),
          f"{label}: buckets {buckets}, wanted {list(NETDES_BUCKETS)}")
    check(opt._inwheel_int_sweep_on() and opt.passes,
          f"{label}: no integer bound pass ran")
    check(all(p["bound_outer"] >= p["bound_outer_base"] - 1e-9
              for p in opt.passes),
          f"{label}: a tightened outer bound fell below its base "
          f"({opt.passes})")
    check(np.isfinite(ob)
          and ob <= ef["incumbent"] + 1e-6 * abs(ef["incumbent"]),
          f"{label}: outer {ob} above the EF MIP {ef['incumbent']}")
    check(np.isfinite(ib)
          and ib >= ef["dual_bound"] - 1e-6 * abs(ef["dual_bound"]),
          f"{label}: inner {ib} below the EF MIP's best bound "
          f"{ef['dual_bound']}")
    check(ob <= ib, f"{label}: outer {ob} above inner {ib}")
    check(ws.stats["spoke1:XhatShuffleInnerBound"]["launches"].get(
        ("launches", "fused_sweeps"), 0) > 0,
        f"{label}: the XhatShuffle spoke launched no fused_sweeps")
    return dict(r, ef=ef, passes=opt.passes, bound_pass_launches=bpl,
                buckets=buckets)


#: The integer families' fused_sweeps shapes (S, m, n): netdes-1000 (10
#: nodes), sizes S=3 (10 sizes), sslp 10 servers x 50 clients S=50 (the
#: shape of SIPLIB's sslp_10_50_50); each builds A per scenario (dense
#: engine).
INT_SHAPES = {"netdes-1000": (1000, 35, 50), "sizes S=3": (3, 62, 150),
              "sslp 10x50 S=50": (50, 60, 520)}
#: netdes S=3 golden (tests/test_integer.py::TestWheelCertifies): the LP EF,
#: the MIP EF, the hub's rel_gap
NETDES_LP_EF, NETDES_MIP_EF, NETDES_GAP = 376.306, 398.333, 0.04
NETDES_HUB_ONLY = {"defaultPHrho": 1.0, "PHIterLimit": 60,
                   "convthresh": -1.0, "in_wheel_bounds": True,
                   "integer_escalation_budget_s": 30.0}
#: netdes-1000's hub-only wheel: the same options, the EF MIP's time limit
NETDES_1000_ITERS = 60
EF_MIP_SECS = 120.0
#: sizes S=3 (tests/test_mip_incumbents.py::
#: test_integer_sizes_wheel_certified_gap): the spokes' 60 iterations, the
#: hub's 40, its bands; and the hub-only in-wheel sizes wheel
SIZES_OPTIONS = {"defaultPHrho": 0.01, "convthresh": -1.0,
                 "xhat_dive_rounds": 20,
                 "xhat_looper_options": {"scen_limit": 2}}
SIZES_OUTER_BAND, SIZES_INNER_BAND = (218000.0, 230000.0), (220000.0,
                                                           240000.0)
SIZES_HUB_ONLY_ITERS = 16      # 30 before the service phase came
SIZES_HUB_ONLY_BUDGET_S = 15.0
#: sslp 10 x 50, S=50: rho 1, 15 hub iterations; the Lagrangian spoke
#: lifts every 4th pass, the XhatShuffle spoke takes donor MILPs and
#: evaluates them by host MILPs (the dive rounds assignments up into the
#: Dummy overflow at 1000 a unit, in the reference as in the port: ROADMAP
#: Queue 3), the XhatXbar spoke its default integer ladder through the dive,
#: each within host budgets
SSLP_KW = {"num_servers": 10, "num_clients": 50, "relax_integers": False}
SSLP_ITERS = 8       # 30 before the resilience phase, 15 the service phase
SSLP_LIFT = {"every": 4, "budget_s": 10.0, "time_limit": 5.0}
SSLP_SHUFFLE = {"donor_milp": True, "donor_milp_time": 5.0, "scen_limit": 2}


def integer_kwargs(model, S, kw, options):
    """A cylinder's opt kwargs for an integer family, in f64 (the
    reference's integer tests run in f64; f32 evaluations park above the
    1e-3 gate, ROADMAP Queue 3)."""
    import importlib

    mod = importlib.import_module(f"tpusppy_torch.models.{model}")
    return {"options": dict(options, batch_cache=True,
                            solver_options={"dtype": "float64"}),
            "all_scenario_names": mod.scenario_names_creator(S),
            "scenario_creator": mod.scenario_creator,
            "scenario_creator_kwargs": dict(kw)}


def ef_solves(model, S, kw, mip_gap=None, time_limit=EF_MIP_SECS):
    """HiGHS on the EF of an integer family, in a worker process beside
    the card's runs: the LP EF, then the MIP EF (time-limited): status,
    incumbent, best bound, seconds."""
    sys.path.insert(0, HERE)
    import importlib

    from tpusppy_torch.ef import build_ef
    from tpusppy_torch.solvers import scipy_backend
    from tpusppy_torch.spbase import build_batch

    mod = importlib.import_module(f"tpusppy_torch.models.{model}")
    batch, _ = build_batch(mod.scenario_names_creator(S),
                           mod.scenario_creator, dict(kw))
    ef = build_ef(batch)
    t0 = time.perf_counter()
    lp = scipy_backend.solve_lp(ef.c, ef.A, ef.cl, ef.cu, ef.lb, ef.ub,
                                const=ef.const)
    t1 = time.perf_counter()
    mip = scipy_backend.solve_lp(ef.c, ef.A, ef.cl, ef.cu, ef.lb, ef.ub,
                                 is_int=ef.is_int, const=ef.const,
                                 mip_rel_gap=mip_gap, time_limit=time_limit)
    return {"lp": lp.obj, "lp_s": t1 - t0, "status": mip.status,
            "incumbent": mip.obj if mip.feasible else float("inf"),
            "dual_bound": (mip.dual_bound if mip.dual_bound is not None
                           else float("-inf")),
            "mip_s": time.perf_counter() - t1}


def int_wheel(label, make_kwargs, spokes, hub_options):
    """Spin an integer wheel (hub PH class :func:`wheel_clock`) with the
    integer counters, host syncs and launches read around it; returns
    (spinner, results).  Every ``fused_sweeps`` launch must run a mode its
    layout picks for the hub batch's shapes (the cylinders solve in f64),
    and no plain version may run."""
    import torch

    from tpusppy_torch.obs import metrics
    from tpusppy_torch.solvers import cuda_kernels
    from tpusppy_torch.spbase import clear_batch_cache

    clear_batch_cache()
    hub, sp = wheel_dicts(make_kwargs, spokes, hub_options, wheel_clock())
    names = ("integer.candidates", "integer.feasible_hits",
             "integer.rcfix_slots", "integer.escalations",
             "integer.escalation_lifts", "integer.escalation_secs",
             "integer.escalation_errors", "megastep.bound_passes",
             "megastep.bound_pass_infeasible", "megastep.bound_rescues",
             "host_sync.count", "admm.loop_checks", "dispatch.megasteps",
             "dispatch.mega_iterations")
    before = cuda_kernels.counts()
    with metrics.window() as w:
        ws, wall = spin(hub, sp)
        deltas = {k: w.delta(k) for k in names}
    after = cuda_kernels.counts()
    clear_batch_cache()
    launched = {k: after[k] - before[k] for k in after
                if after[k] != before[k]}
    stamps = ws.opt.stamps
    rate = (stamps[-1][0] / (stamps[-1][1] - stamps[0][1])
            if len(stamps) > 1 else float("nan"))
    it_done, reason = ws.spcomm.stopped_at
    ob, ib = ws.BestOuterBound, ws.BestInnerBound
    iters = max(ws.opt._iter, 1)
    syncs = deltas["host_sync.count"]
    flags, fetches = deltas["admm.loop_checks"], deltas["dispatch.megasteps"]
    res = dict(outer=ob, inner=ib, rate=rate, wall=wall, deltas=deltas,
               launched=launched, stopped=(it_done, reason),
               rel_gap=(ib - ob) / abs(ob) if np.isfinite(ob)
               and ob != 0 else float("inf"),
               syncs=(syncs / iters, flags / iters, fetches / iters,
                      (syncs - flags - fetches) / iters))
    ints = {k.split(".", 1)[1]: round(v, 3) for k, v in deltas.items()
            if k.startswith("integer.")}
    print(f"{label}: outer={ob:.6f} (from "
          f"{getattr(ws.opt, 'inwheel_outer_source', '-')}) inner={ib:.6f} "
          f"(from {getattr(ws.opt, 'inwheel_inner_source', '-')}) "
          f"rel_gap={res['rel_gap']:.4e}; hub stopped at iteration "
          f"{it_done} ({reason}); hub PH it/s {rate:.3f}; windows "
          f"{deltas['dispatch.megasteps']:.0f} "
          f"({deltas['dispatch.mega_iterations']:.0f} iterations), bound "
          f"passes "
          f"{deltas['megastep.bound_passes']:.0f} (infeasible "
          f"{deltas['megastep.bound_pass_infeasible']:.0f}, host rescues "
          f"{deltas['megastep.bound_rescues']:.0f}); integer {ints}; host "
          f"syncs an iteration {res['syncs'][0]:.2f} (flag reads "
          f"{res['syncs'][1]:.2f}, packed fetches {res['syncs'][2]:.3f}, "
          f"other {res['syncs'][3]:.2f}); launches "
          f"{ {f'{a}:{b}': v for (a, b), v in launched.items()} }; "
          f"wall_s={wall:.2f} {CARD}", flush=True)
    print_cylinders(label, ws, it_done)
    check(not ws.spoke_errors and not ws.hung_spokes,
          f"{label}: spoke errors {ws.spoke_errors}, hung {ws.hung_spokes}")
    check(launched.get(("launches", "fused_sweeps"), 0) > 0,
          f"{label}: fused_sweeps never launched")
    want = dense_modes_of(cuda_kernels, ws.opt.batch, torch.float64)
    for name, st in ws.stats.items():
        ran = ran_dense_modes(st["launches"])
        print(f"{label} {name}: fused_sweeps modes {sorted(ran)} (the "
              f"layout picks {sorted(want)} at the hub's shapes)", flush=True)
        if name.startswith("hub:"):
            check(ran and ran <= want, f"{label} {name}: fused_sweeps ran "
                  f"the modes {sorted(ran)}; its layout picks "
                  f"{sorted(want)}")
    check(not any(v for (t, _), v in launched.items()
                  if t == "plain_calls"),
          f"{label}: a plain version ran on the card ({launched})")
    check(deltas["integer.escalation_errors"] == 0,
          f"{label}: {deltas['integer.escalation_errors']:.0f} host "
          "escalations raised")
    return ws, res


#: The integer families' creator kwargs (integers kept).
INTEGER_NETDES_KW = {"relax_integers": False}
INTEGER_SIZES_KW = {"scenario_count": 3, "relax_integers": False}


def start_integer_efs():
    """Start the integer phase's HiGHS EF solves in worker processes
    (``main`` starts them before the bundles phase, so the integer phase
    finds them done: the sslp MIP runs its EF_MIP_SECS limit); returns the
    pool (shut down by the caller) and the futures."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=3, mp_context=multiprocessing.get_context("spawn"))
    efs = {
        "netdes-3": pool.submit(ef_solves, "netdes", 3,
                                dict(INTEGER_NETDES_KW, num_scens=3)),
        "netdes-1000": pool.submit(ef_solves, "netdes", 1000,
                                   dict(INTEGER_NETDES_KW, num_scens=1000)),
        "sslp": pool.submit(ef_solves, "sslp", 50, SSLP_KW),
        "sizes": pool.submit(ef_solves, "sizes", 3, INTEGER_SIZES_KW,
                             mip_gap=0.02),
    }
    return pool, efs


def phase_integer(cuda_kernels, efs):
    """The integer families on the card, all in f64: fused_sweeps at the
    three families' shapes against its plain version; the netdes S=3
    golden and netdes-1000 hub-only in-wheel integer wheels; the sizes S=3
    golden spoke wheel and a hub-only sizes wheel; the sslp 10 x 50 S=50
    spoke wheel.  ``efs``: HiGHS's EF solves
    (:func:`start_integer_efs`)."""
    return _integer_runs(cuda_kernels, efs, INTEGER_NETDES_KW,
                         INTEGER_SIZES_KW)


def _integer_runs(cuda_kernels, efs, netdes_kw, sizes_kw):
    """:func:`phase_integer`'s runs; ``efs``: the EF solves' futures."""
    import torch

    from tpusppy_torch.cylinders import (LagrangianOuterBound,
                                         XhatShuffleInnerBound,
                                         XhatXbarInnerBound)
    from tpusppy_torch.obs import metrics
    from tpusppy_torch.phbase import PHBase
    from tpusppy_torch.xhat_eval import Xhat_Eval

    t_phase = time.perf_counter()
    # the modes fused_sweeps' layout picks at the families' shapes (the
    # kernels phase holds it there); each wheel checks its launches ran them
    print("integer families' fused_sweeps modes (f64): " + ", ".join(
        f"{name} {dense_layout_of(cuda_kernels, S, m, n, torch.float64)['mode']}"
        for name, (S, m, n) in INT_SHAPES.items()), flush=True)
    cuda_kernels.reset_counts()
    out = {}
    with metrics.window() as phase_w:
        # 1. the netdes S=3 golden: the hub-only in-wheel integer wheel
        label = "integer netdes S=3 golden"
        ws, r = int_wheel(label, lambda: integer_kwargs(
            "netdes", 3, dict(netdes_kw, num_scens=3), NETDES_HUB_ONLY), [],
            {"rel_gap": NETDES_GAP})
        ef3 = efs["netdes-3"].result()
        ob, ib, d = r["outer"], r["inner"], r["deltas"]
        print(f"{label}: LP EF {ef3['lp']:.6f}, MIP EF {ef3['incumbent']:.6f}"
              f" (HiGHS status {ef3['status']})", flush=True)
        check(abs(ef3["lp"] - NETDES_LP_EF) <= 1e-3
              and abs(ef3["incumbent"] - NETDES_MIP_EF) <= 1e-3,
              f"{label}: the EFs {ef3['lp']}, {ef3['incumbent']} are not "
              f"the goldens {NETDES_LP_EF}, {NETDES_MIP_EF}")
        check(r["rel_gap"] <= NETDES_GAP, f"{label}: gap {r['rel_gap']}")
        check(ob > NETDES_LP_EF, f"{label}: outer {ob} not past the LP EF")
        check(ob <= ef3["incumbent"] + 1e-6 * abs(ef3["incumbent"]),
              f"{label}: outer {ob} above the MIP EF {ef3['incumbent']}")
        check(d["integer.feasible_hits"] > 0 and d["integer.escalations"] >= 1,
              f"{label}: feasible hits {d['integer.feasible_hits']}, "
              f"escalations {d['integer.escalations']}")
        out["netdes-3"] = r

        # 2. netdes-1000: the slice's full-size path
        label = "integer netdes-1000"
        ws, r = int_wheel(label, lambda: integer_kwargs(
            "netdes", 1000, dict(netdes_kw, num_scens=1000),
            dict(NETDES_HUB_ONLY, PHIterLimit=NETDES_1000_ITERS)), [],
            {"rel_gap": NETDES_GAP})
        bpl = ws.opt.bound_pass_launches
        print(f"{label}: fused_sweeps launches inside bound passes by "
              "candidate (the ladder 0.5, 0.35, 0.25, SLAM-up, SLAM-down, "
              "then the reduced-cost re-certification): "
              + "; ".join(
                  f"{i}: " + ", ".join(f"{a}:{b}={v}" for (a, b), v in
                                       sorted(dd.items()))
                  for i, dd in enumerate(bpl)), flush=True)
        ef = efs["netdes-1000"].result()
        ob, ib = r["outer"], r["inner"]
        print(f"{label}: EF LP {ef['lp']:.6f} ({ef['lp_s']:.1f} s), EF MIP "
              f"status {ef['status']} incumbent {ef['incumbent']:.6f} best "
              f"bound {ef['dual_bound']:.6f} ({ef['mip_s']:.1f} s, limit "
              f"{EF_MIP_SECS:.0f} s); outer past the LP EF: "
              f"{ob > ef['lp']} (outer-LP)/|LP| "
              f"{(ob - ef['lp']) / abs(ef['lp']):.3e}", flush=True)
        check(ob <= ib, f"{label}: outer {ob} above inner {ib}")
        check(ob <= ef["incumbent"] + 1e-6 * abs(ef["incumbent"]),
              f"{label}: outer {ob} above the EF incumbent "
              f"{ef['incumbent']}")
        check(ib >= ef["dual_bound"] - 1e-6 * abs(ef["dual_bound"]),
              f"{label}: inner {ib} below the EF best bound "
              f"{ef['dual_bound']}")
        check(r["deltas"]["megastep.bound_passes"] > 0,
              f"{label}: no bound pass ran")
        check(all(dd.get(("launches", "fused_sweeps"), 0) > 0 for dd in bpl),
              f"{label}: an evaluation of the bound pass launched no "
              "fused_sweeps")
        out["netdes-1000"] = dict(r, ef=ef, bound_pass_launches=bpl,
                                  S_it=1000)
        print(f"[{time.perf_counter() - t_phase:.1f} s into the phase]",
              flush=True)

        # 3. sizes S=3: the golden spoke wheel, then a hub-only sizes wheel
        label = "integer sizes S=3 golden"
        ws, r = int_wheel(label, lambda: integer_kwargs(
            "sizes", 3, sizes_kw, dict(SIZES_OPTIONS, PHIterLimit=40)), [
            (LagrangianOuterBound, PHBase, {"PHIterLimit": 60}),
            (XhatShuffleInnerBound, Xhat_Eval, {"PHIterLimit": 60})],
            {"rel_gap": 0.02})
        ob, ib = r["outer"], r["inner"]
        check(SIZES_OUTER_BAND[0] <= ob <= SIZES_OUTER_BAND[1]
              and SIZES_INNER_BAND[0] <= ib <= SIZES_INNER_BAND[1],
              f"{label}: outer {ob} or inner {ib} outside the bands")
        check(ob <= ib + 1e-6, f"{label}: outer {ob} above inner {ib}")
        out["sizes"] = r
        label = "integer sizes S=3 hub-only"
        ws, r = int_wheel(label, lambda: integer_kwargs(
            "sizes", 3, sizes_kw, dict(
                NETDES_HUB_ONLY, defaultPHrho=0.01,
                PHIterLimit=SIZES_HUB_ONLY_ITERS,
                integer_escalation_budget_s=SIZES_HUB_ONLY_BUDGET_S)), [],
            {"rel_gap": 0.02})
        ef = efs["sizes"].result()
        print(f"{label}: EF LP {ef['lp']:.4f}, EF MIP (gap 2%) status "
              f"{ef['status']} incumbent {ef['incumbent']:.4f} best bound "
              f"{ef['dual_bound']:.4f} ({ef['mip_s']:.1f} s)", flush=True)
        check(not ws.opt._inwheel_inner_ok(), f"{label}: second-stage "
              "integers not seen")
        check(r["outer"] <= ef["incumbent"] + 1e-6 * abs(ef["incumbent"]),
              f"{label}: outer {r['outer']} above the MIP EF "
              f"{ef['incumbent']}")
        check(r["deltas"]["integer.rcfix_slots"] == 0,
              f"{label}: reduced-cost fixing ran on second-stage integers")
        out["sizes-hub"] = dict(r, ef=ef)
        print(f"[{time.perf_counter() - t_phase:.1f} s into the phase]",
              flush=True)

        # 4. sslp 10 x 50, S=50: the three spokes, each within its budget
        label = "integer sslp 10x50 S=50"
        ws, r = int_wheel(label, lambda: integer_kwargs(
            "sslp", 50, SSLP_KW, {"defaultPHrho": 1.0,
                                  "PHIterLimit": SSLP_ITERS,
                                  "convthresh": -1.0}),
            [(LagrangianOuterBound, PHBase,
              {"lagrangian_milp_lift": dict(SSLP_LIFT)}),
             (XhatShuffleInnerBound, Xhat_Eval,
              {"xhat_looper_options": dict(SSLP_SHUFFLE),
               "xhat_integer_strategy": "milp"}),
             (XhatXbarInnerBound, Xhat_Eval, {})], {"rel_gap": 1e-3})
        ef = efs["sslp"].result()
        spokes = []
        for c in ws.spoke_comms:
            secs = (getattr(c, "milp_secs", 0.0)
                    + getattr(c.opt, "host_milp_secs", 0.0))
            spokes.append((type(c).__name__, c.bound, secs))
        print(f"{label}: EF LP {ef['lp']:.4f}, EF MIP status {ef['status']}"
              f" incumbent {ef['incumbent']:.4f} best bound "
              f"{ef['dual_bound']:.4f} ({ef['mip_s']:.1f} s); spokes "
              + ", ".join(f"{n} bound {b:.4f} host MILP s {s:.2f}"
                          for n, b, s in spokes), flush=True)
        check(r["outer"] <= r["inner"], f"{label}: outer {r['outer']} above "
              f"inner {r['inner']}")
        check(r["outer"] <= ef["incumbent"] + 1e-6 * abs(ef["incumbent"]),
              f"{label}: outer {r['outer']} above the EF incumbent "
              f"{ef['incumbent']}")
        out["sslp"] = dict(r, ef=ef, spokes=spokes)
        errors = phase_w.delta("integer.escalation_errors")
    check(errors == 0, f"integer phase: {errors:.0f} host escalations raised")
    check(all(v == 0 for v in cuda_kernels.plain_calls.values()),
          f"integer phase: plain versions ran {cuda_kernels.plain_calls}")
    print(f"integer phase: {time.perf_counter() - t_phase:.1f} s {CARD}",
          flush=True)
    return out


#: The resilience phase: farmer-1000 cm=4.  (c) a hub-only wheel in f64
#: at the solver's defaults (eps 1e-8) checkpointing every iteration, in a
#: child process killed once a checkpoint at RES_KILL_AT or later exists,
#: then resumed to RES_TOTAL iterations in all, against the same run
#: uninterrupted; the reference test's tolerances
#: (tests/test_resilience.py:188-193).  The child's iteration limit is far
#: past RES_TOTAL, so only the kill ends it.
RES_KILL_AT, RES_TOTAL = 15, 45
RES_CHILD_ITERS = 10 * RES_TOTAL
RES_CHILD_SECS = 600.0
RES_RTOL, RES_ATOL = 1e-5, 1e-4
#: (c)'s solver tolerance (f64 eps_abs = eps_rel: the solver's default),
#: acceptance ladder for PH's QP subproblems (``straggler_tol_qp``, None:
#: the default 1e-2) and refresh cadence (``solver_refresh_every``, None:
#: the default 16).  A checkpoint holds no warm duals and no factors (as
#: the reference's), so a resumed run's frozen iterates carry other solver
#: errors than the uninterrupted run's, and PH carries them on: at the
#: defaults the two farmer-1000 runs part by 8.5e-2 in W, beyond the
#: tolerances, where with a refresh every iteration (every iterate an
#: adaptive solve to eps, no frozen one) they agree to 5.6e-5 (PERF.md §6;
#: ``scripts/port_resume_parity.py``).  So (c) runs twice: with windows
#: (a capture at each window boundary; the W gap printed) and with
#: RES_PARITY_REFRESH, held to the tolerances.  Both hold the resumed
#: run's expected objective within RES_EOBJ_RTOL of the uninterrupted
#: run's (3.5e-7 measured with windows).  The windows pass runs the lean
#: posture (``ph_device_state``): full-pack windows install W and xbars
#: on the host every window, so only lean windows leave host mirrors a
#: capture could read stale, and there every capture is held against the
#: device state it was taken on to RES_CAPTURE_ATOL.
RES_EPS, RES_QP_TOL, RES_REFRESH = 1e-8, None, None
RES_PARITY_REFRESH = 1
RES_EOBJ_RTOL = 1e-5
RES_CAPTURE_ATOL = 1e-12
#: The cost of checkpointing: the uninterrupted RES_TOTAL-iteration
#: hub-only wheel with a checkpoint every iteration and with none, in
#: RES_COST_PAIRS alternating pairs (off, on, on, off, ...) for each
#: posture (full-pack and lean windows).
RES_COST_PAIRS = 3
#: (d) the three-cylinder wheel (the wheel phase's: hub f32, Lagrangian
#: and XhatShuffle in f64) cut at RES_WHEEL_CUT with checkpoints, resumed
#: to RES_WHEEL_ITERS in all, and run uninterrupted; (e) the same wheel
#: with the Lagrangian killed at its RES_KILL_PAYLOAD-th payload.  Linger
#: cut to RES_LINGER s.
RES_WHEEL_CUT, RES_WHEEL_ITERS = 4, 10
RES_KILL_PAYLOAD = 2
RES_LINGER = 1.0


def resilience_hub(iters, hub_options=None, eps=RES_EPS, qp_tol=RES_QP_TOL,
                   refresh=RES_REFRESH, lean=False):
    """(c)'s hub-only farmer-1000 wheel in f64 at ``eps``, hub class
    :func:`wheel_clock`; ``qp_tol``: ``straggler_tol_qp`` (None: the
    default ladder); ``refresh``: ``solver_refresh_every`` (None: the
    default, 16); ``lean``: ``ph_device_state`` (lean windows)."""
    def kwargs():
        kw = farmer_wheel_kwargs(1000, 4)
        kw["options"].update(PHIterLimit=iters, ph_device_state=lean,
                             solver_options={"dtype": "float64",
                                             "eps_abs": eps, "eps_rel": eps})
        if qp_tol is not None:
            kw["options"]["straggler_tol_qp"] = qp_tol
        if refresh is not None:
            kw["options"]["solver_refresh_every"] = refresh
        return kw

    hub, _ = wheel_dicts(kwargs, [], dict(hub_options or {}), wheel_clock())
    return hub


def checkpointing(ckdir):
    """Hub options: a checkpoint each iteration (each window boundary)."""
    return {"checkpoint_dir": ckdir, "checkpoint_every_iters": 1,
            "checkpoint_every_secs": None}


def resilience_child(ckdir, eps, qp_tol, refresh, lean) -> int:
    """The killed run of (c), in a process of its own: the hub-only wheel
    checkpointing every iteration until its parent's SIGKILL.  Prints no
    result line."""
    import torch

    if not torch.cuda.is_available():
        return 2
    sys.path.insert(0, HERE)
    from tpusppy_torch.solvers import cuda_kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda_kernels.build()          # the parent's libraries: nothing to build
    spin(resilience_hub(RES_CHILD_ITERS, checkpointing(ckdir), eps, qp_tol,
                        refresh, lean), [])
    return 0


def child_command(ckdir, eps, qp_tol, refresh, lean):
    return [sys.executable, os.path.abspath(__file__), "--resilience-child",
            ckdir, repr(eps), repr(qp_tol), repr(refresh), repr(lean)]


class capture_audit:
    """Within the block, each checkpoint capture whose opt holds a lean
    window's device state is held against that state: after the capture
    returns (outside its fetch billing) the device W and xbars are read
    and compared with the snapshot.  ``diffs``: (iteration, max |W diff|,
    max |xbars diff|) a capture."""

    def __enter__(self):
        from tpusppy_torch.resilience import checkpoint

        self._mod, self._mgr = checkpoint, checkpoint.CheckpointManager
        self._ph, self._cap = checkpoint.capture_ph, self._mgr.capture
        self.diffs, taken = [], []
        orig_ph, orig_cap = self._ph, self._cap

        def capture_ph(opt, hub=None):
            snap = orig_ph(opt, hub=hub)
            taken.append((opt, snap))
            return snap

        def capture(mgr, iteration, snapshot_fn):
            taken.clear()
            ok = orig_cap(mgr, iteration, snapshot_fn)
            for opt, snap in taken:
                st = getattr(opt, "_dev_state", None)
                if snap is None or st is None:
                    continue
                W = st.W.detach().cpu().numpy()
                xb = st.xbars.detach().cpu().numpy()
                self.diffs.append((int(iteration),
                                   float(np.abs(snap.W - W).max()),
                                   float(np.abs(snap.xbars - xb).max())))
            return ok

        checkpoint.capture_ph, self._mgr.capture = capture_ph, capture
        return self

    def __exit__(self, *exc):
        self._mod.capture_ph, self._mgr.capture = self._ph, self._cap
        return False


def kill_and_resume(cuda_kernels, workdir, eps=RES_EPS, qp_tol=RES_QP_TOL,
                    refresh=RES_REFRESH, lean=False, hold=True):
    """(c): a real kill.  The child checkpoints every iteration; at the
    first checkpoint at RES_KILL_AT or later the parent SIGKILLs it, then
    resumes from the newest checkpoint to RES_TOTAL iterations in all
    (checkpointing on) and runs the same wheel uninterrupted (off): W and
    xbars agree to the reference test's tolerances (``hold``; else only
    printed), the expected objective to RES_EOBJ_RTOL, and captures fetch
    nothing.  ``lean``: lean windows, each capture of the resumed run held
    against the device state (:class:`capture_audit`) after a boundary
    fetch.  ``eps``, ``qp_tol`` and ``refresh``: the runs' solver
    tolerance, ``straggler_tol_qp`` and ``solver_refresh_every`` (None:
    the defaults)."""
    import signal

    from tpusppy_torch.obs import metrics
    from tpusppy_torch.resilience import checkpoint
    from tpusppy_torch.spbase import clear_batch_cache

    label = (f"resilience (c) farmer-1000 f64 eps {eps:g} hub-only kill, "
             f"straggler_tol_qp {qp_tol or 'default'}, solver_refresh_every "
             f"{refresh or 'default'}, {'lean' if lean else 'full-pack'} "
             "windows")
    tag = f"{eps}_{qp_tol}_{refresh}_{lean}"
    ckdir = os.path.join(workdir, f"kill_{tag}")
    log_path = os.path.join(workdir, f"child_{tag}.log")
    t0 = time.perf_counter()
    with open(log_path, "w") as log:
        proc = subprocess.Popen(child_command(ckdir, eps, qp_tol, refresh,
                                              lean),
                                stdout=log,
                                stderr=subprocess.STDOUT, cwd=HERE)
        seen = None
        try:
            while True:
                seen = checkpoint.latest_iteration(ckdir) \
                    if os.path.isdir(ckdir) else None
                if seen is not None and seen >= RES_KILL_AT:
                    break
                if proc.poll() is not None or \
                        time.perf_counter() - t0 > RES_CHILD_SECS:
                    break
                time.sleep(0.05)
        finally:
            if proc.poll() is None:
                os.kill(proc.pid, signal.SIGKILL)
            proc.wait()
    t_kill = time.perf_counter() - t0
    with open(log_path) as f:
        tail = f.read()[-3000:]
    ck_it = checkpoint.latest_iteration(ckdir)
    print(f"{label}: child killed after {t_kill:.1f} s (rc "
          f"{proc.returncode}), newest checkpoint at iteration {ck_it} "
          f"(seen {seen})", flush=True)
    check(proc.returncode == -signal.SIGKILL,
          f"{label}: the child ended by itself (rc {proc.returncode}); its "
          f"log ends:\n{tail}")
    check(ck_it is not None and RES_KILL_AT <= ck_it < RES_TOTAL,
          f"{label}: newest checkpoint {ck_it}")
    ck = checkpoint.load_latest(ckdir)

    clear_batch_cache()
    cuda_kernels.reset_counts()
    with metrics.window() as w, capture_audit() as audit:
        ws_res, wall_res = spin(resilience_hub(
            RES_TOTAL, checkpointing(ckdir), eps, qp_tol, refresh, lean), [],
            resume=ckdir)
        d = {k: w.delta(k) for k in (
            "checkpoint.captures", "checkpoint.capture_fetches",
            "checkpoint.restores", "checkpoint.writes",
            "checkpoint.write_errors", "phstate.boundary_fetches")}
    launched = dict(cuda_kernels.launches)
    plain = dict(cuda_kernels.plain_calls)
    clear_batch_cache()
    ws_ref, wall_ref = spin(resilience_hub(RES_TOTAL, None, eps, qp_tol,
                                           refresh, lean), [])
    clear_batch_cache()
    W, Wr = np.asarray(ws_res.opt.W), np.asarray(ws_ref.opt.W)
    xb, xbr = np.asarray(ws_res.opt.xbars), np.asarray(ws_ref.opt.xbars)

    def worst(a, b):
        """The largest |a - b| - atol - rtol |b| (<= 0 within tolerance)
        and the largest |a - b|."""
        diff = np.abs(a - b)
        return (float((diff - RES_ATOL - RES_RTOL * np.abs(b)).max()),
                float(diff.max()))

    wW, wx = worst(W, Wr), worst(xb, xbr)
    e_res, e_ref = ws_res.opt.Eobjective(), ws_ref.opt.Eobjective()
    e_rel = abs(e_res - e_ref) / abs(e_ref)
    cap_W = max((a for _, a, _ in audit.diffs), default=float("nan"))
    cap_x = max((b for _, _, b in audit.diffs), default=float("nan"))
    print(f"{label}: resumed from {ws_res.resumed_from} to iteration "
          f"{ws_res.opt._iter}; max |W| {np.abs(Wr).max():.3e}, max |xbars| "
          f"{np.abs(xbr).max():.3e}; W max |diff| {wW[1]:.3e} (excess over "
          f"tolerance {wW[0]:.3e}), xbars {wx[1]:.3e} ({wx[0]:.3e}); eobj "
          f"resumed {e_res:.6f} uninterrupted {e_ref:.6f} rel {e_rel:.3e}; "
          f"checkpoint counters {d}; captures held against the device "
          f"state {len(audit.diffs)} at iterations "
          f"{[it for it, _, _ in audit.diffs]}, max |W diff| {cap_W:.3e} "
          f"max |xbars diff| {cap_x:.3e}; wall_s resumed {wall_res:.2f} "
          f"uninterrupted {wall_ref:.2f}; launches {launched} {CARD}",
          flush=True)
    check(ws_res.resumed_from == ck.iteration == ck_it,
          f"{label}: resumed_from {ws_res.resumed_from}, checkpoint {ck_it}")
    check(ws_res.opt._iter == RES_TOTAL and ws_ref.opt._iter == RES_TOTAL,
          f"{label}: iterations {ws_res.opt._iter}, {ws_ref.opt._iter}")
    check(not hold or (wW[0] <= 0 and wx[0] <= 0),
          f"{label}: W or xbars outside rtol {RES_RTOL} atol {RES_ATOL} of "
          "the uninterrupted run")
    check(e_rel <= RES_EOBJ_RTOL,
          f"{label}: eobj {e_res} vs uninterrupted {e_ref}, rel {e_rel:.3e} "
          f"above {RES_EOBJ_RTOL}")
    check(not lean or (any(it < RES_TOTAL for it, _, _ in audit.diffs)
                       and d["phstate.boundary_fetches"] > 0
                       and cap_W <= RES_CAPTURE_ATOL
                       and cap_x <= RES_CAPTURE_ATOL),
          f"{label}: captures against the device state {audit.diffs}, "
          f"boundary fetches {d['phstate.boundary_fetches']}")
    check(d["checkpoint.capture_fetches"] == 0
          and d["checkpoint.restores"] >= 1 and d["checkpoint.captures"] > 0,
          f"{label}: checkpoint counters {d}")
    check(launched["fused_sweeps"] > 0 and not any(plain.values()),
          f"{label}: launches {launched}, plain versions {plain}")
    return dict(ck_it=ck_it, W=wW, xbars=wx, deltas=d, kill_s=t_kill,
                eobj=(e_res, e_ref), captures=audit.diffs)


def checkpoint_cost(workdir):
    """The hub's PH it/s with a checkpoint every iteration against none:
    the uninterrupted RES_TOTAL-iteration wheel of (c), RES_COST_PAIRS
    alternating pairs in each posture (full-pack, then lean windows, where
    a due capture also forces the window's boundary fetch); medians and
    the spread of each side."""
    from tpusppy_torch.spbase import clear_batch_cache

    out = {}
    for lean in (False, True):
        posture = "lean" if lean else "full-pack"
        rates = {"off": [], "on": []}
        walls = {"off": [], "on": []}
        order = ["off", "on", "on", "off"] * RES_COST_PAIRS
        for i, side in enumerate(order[:2 * RES_COST_PAIRS]):
            ckdir = os.path.join(workdir, f"cost_{posture}_{i}")
            ws, wall = spin(resilience_hub(
                RES_TOTAL, checkpointing(ckdir) if side == "on" else None,
                lean=lean), [])
            check(ws.opt._iter == RES_TOTAL,
                  f"checkpoint cost {posture} {side}: {ws.opt._iter} "
                  "iterations")
            rates[side].append(stamp_rate(ws.opt.stamps))
            walls[side].append(wall)
        med = {k: float(np.median(v)) for k, v in rates.items()}
        print(f"resilience checkpoint cost, farmer-1000 f64 hub-only "
              f"{RES_TOTAL} iterations, {posture} windows: hub PH it/s "
              f"checkpointing every iteration median {med['on']:.3f} "
              f"(runs {[round(r, 3) for r in rates['on']]}), off median "
              f"{med['off']:.3f} (runs {[round(r, 3) for r in rates['off']]})"
              f", on/off {med['on'] / med['off']:.4f}; wall_s on "
              f"{[round(t, 2) for t in walls['on']]} off "
              f"{[round(t, 2) for t in walls['off']]} {CARD}", flush=True)
        out[posture] = dict(rates=rates, walls=walls, median=med)
    clear_batch_cache()
    return out


def resilience_wheel(iters, hub_extra=None, resume=None):
    """(d)/(e)'s wheel: the wheel phase's farmer-1000 hub (f32) with a
    Lagrangian and an XhatShuffle spoke in f64, the linger cut."""
    from tpusppy_torch.cylinders import (LagrangianOuterBound,
                                         XhatShuffleInnerBound)
    from tpusppy_torch.phbase import PHBase
    from tpusppy_torch.spbase import clear_batch_cache
    from tpusppy_torch.xhat_eval import Xhat_Eval

    def kwargs():
        kw = farmer_wheel_kwargs(1000, 4)
        kw["options"].update(PHIterLimit=iters)
        return kw

    spoke_opts = {"solver_options": dict(WHEEL_SOLVER, dtype="float64")}
    clear_batch_cache()
    hub, spokes = wheel_dicts(
        kwargs, [(LagrangianOuterBound, PHBase, spoke_opts),
                 (XhatShuffleInnerBound, Xhat_Eval, spoke_opts)],
        {**WHEEL_HUB, "linger_secs": RES_LINGER, **(hub_extra or {})},
        wheel_clock())
    ws, wall = spin(hub, spokes, resume=resume)
    clear_batch_cache()
    return ws, wall


def rel_gap(ws):
    ob, ib = ws.BestOuterBound, ws.BestInnerBound
    return ((ib - ob) / abs(ob) if np.isfinite(ob) and np.isfinite(ib)
            and ob != 0 else float("inf"))


def wheel_resume(cuda_kernels, workdir, ef):
    """(d): the three-cylinder wheel cut at RES_WHEEL_CUT iterations with
    checkpoints, resumed to RES_WHEEL_ITERS in all, and run uninterrupted:
    bounds monotone across the restart, outer <= EF + 1e-6 |EF|, outer <=
    inner."""
    from tpusppy_torch.resilience import checkpoint

    label = "resilience (d) farmer-1000 three-cylinder wheel"
    ckdir = os.path.join(workdir, "wheel")
    ws_cut, wall_cut = resilience_wheel(
        RES_WHEEL_CUT, dict(checkpointing(ckdir), linger_secs=0.0))
    ck = checkpoint.load_latest(ckdir)
    check(ck is not None and ck.iteration >= RES_WHEEL_CUT,
          f"{label}: no checkpoint at iteration {RES_WHEEL_CUT}")
    cuda_kernels.reset_counts()
    ws_res, wall_res = resilience_wheel(RES_WHEEL_ITERS, resume=ckdir)
    launched = dict(cuda_kernels.launches)
    plain = dict(cuda_kernels.plain_calls)
    ws_ref, wall_ref = resilience_wheel(RES_WHEEL_ITERS)
    ob, ib = ws_res.BestOuterBound, ws_res.BestInnerBound
    print(f"{label}: cut at {ws_cut.opt._iter} (checkpoint {ck.iteration}: "
          f"outer {ck.best_outer:.4f} inner {ck.best_inner:.4f}, spoke "
          f"bounds {ck.spoke_bounds}); resumed from {ws_res.resumed_from}: "
          f"outer {ob:.4f} inner {ib:.4f} rel_gap {rel_gap(ws_res):.4e} "
          f"(hub to iteration {ws_res.opt._iter}); uninterrupted: outer "
          f"{ws_ref.BestOuterBound:.4f} inner {ws_ref.BestInnerBound:.4f} "
          f"rel_gap {rel_gap(ws_ref):.4e}; EF {ef:.4f}; wall_s cut "
          f"{wall_cut:.2f} resumed {wall_res:.2f} uninterrupted "
          f"{wall_ref:.2f}; launches {launched} {CARD}", flush=True)
    print_cylinders(label + " resumed", ws_res, ws_res.opt._iter)
    check(ws_res.resumed_from == ck.iteration,
          f"{label}: resumed_from {ws_res.resumed_from}")
    check(ob >= ck.best_outer - 1e-9 and ib <= ck.best_inner + 1e-9,
          f"{label}: bounds not monotone across the restart (outer {ob} "
          f"from {ck.best_outer}, inner {ib} from {ck.best_inner})")
    check(np.isfinite(ob) and ob <= ef + 1e-6 * abs(ef),
          f"{label}: outer {ob} not finite and at most EF {ef}")
    check(ob <= ib, f"{label}: outer {ob} above inner {ib}")
    check(not ws_res.spoke_errors and not ws_ref.spoke_errors,
          f"{label}: spoke errors {ws_res.spoke_errors} "
          f"{ws_ref.spoke_errors}")
    check(launched["fused_sweeps"] > 0 and not any(plain.values()),
          f"{label}: launches {launched}, plain versions {plain}")
    return dict(ck_it=ck.iteration, rel_gap=rel_gap(ws_res),
                rel_gap_ref=rel_gap(ws_ref), outer=ob, inner=ib)


def dead_spoke(cuda_kernels):
    """(e): the Lagrangian killed at its RES_KILL_PAYLOAD-th payload: the
    wheel completes with the spoke lost and one SpokeKilled, a finite
    inner bound, outer <= inner, a clean synchronize; the hub's PH it/s
    before and after the kill."""
    import torch

    from tpusppy_torch.obs import metrics
    from tpusppy_torch.resilience import faults

    label = "resilience (e) farmer-1000 dead spoke"
    hook = faults.on_spoke_payload
    killed_at = []

    def timed_hook(spoke):
        try:
            hook(spoke)
        except faults.SpokeKilled:
            killed_at.append(time.perf_counter())
            raise

    faults.on_spoke_payload = timed_hook
    cuda_kernels.reset_counts()
    try:
        with metrics.window() as w:
            with faults.inject(faults.FaultPlan(
                    kill_spoke={"LagrangianOuterBound": RES_KILL_PAYLOAD})):
                ws, wall = resilience_wheel(RES_WHEEL_ITERS)
            lost = w.delta("supervisor.spokes_lost")
        kills = faults.injected_counts().get("spoke_kills", 0)
    finally:
        faults.on_spoke_payload = hook
    torch.cuda.synchronize()
    launched = dict(cuda_kernels.launches)
    plain = dict(cuda_kernels.plain_calls)
    ob, ib = ws.BestOuterBound, ws.BestInnerBound
    stamps = ws.opt.stamps
    t_kill = killed_at[0] if killed_at else float("nan")
    before = stamp_rate([st for st in stamps if st[1] <= t_kill])
    after = stamp_rate(stamps, t_kill) if killed_at else float("nan")
    print(f"{label}: lost {ws.lost_spokes}, errors "
          f"{[(n, type(e).__name__) for n, e in ws.spoke_errors]}, "
          f"supervisor.spokes_lost {lost:.0f}, kills {kills}; outer "
          f"{ob:.4f} inner {ib:.4f} rel_gap {rel_gap(ws):.4e}; hub "
          f"stopped at {ws.spcomm.stopped_at}; hub PH it/s before the kill "
          f"{before:.3f}, after {after:.3f}; wall_s {wall:.2f}; "
          f"torch.cuda.synchronize() clean; launches {launched} {CARD}",
          flush=True)
    print_cylinders(label, ws, ws.opt._iter)
    check(ws.spun and kills == 1 and lost == 1,
          f"{label}: kills {kills}, spokes lost {lost}")
    check(any("LagrangianOuterBound" in s for s in ws.lost_spokes),
          f"{label}: lost_spokes {ws.lost_spokes}")
    check(len(ws.spoke_errors) == 1
          and isinstance(ws.spoke_errors[0][1], faults.SpokeKilled),
          f"{label}: spoke errors {ws.spoke_errors}")
    check(np.isfinite(ib) and ob <= ib,
          f"{label}: inner {ib} not finite or below outer {ob}")
    check(launched["fused_sweeps"] > 0 and not any(plain.values()),
          f"{label}: launches {launched}, plain versions {plain}")
    return dict(rate_before=before, rate_after=after, outer=ob, inner=ib,
                lost=ws.lost_spokes)


def phase_resilience(cuda_kernels, main):
    """Checkpoint and resume, and a dead spoke, on farmer-1000 through
    ``fused_sweeps``: (c) a real kill of a checkpointing process and the
    resume, (d) a three-cylinder wheel cut and resumed, (e) a dead
    spoke.  ``main``: the main phases' runs (the farmer EF, computed here
    when the farmer phase did not run)."""
    import shutil
    import tempfile

    from tpusppy_torch.ef import solve_ef
    from tpusppy_torch.models import farmer
    from tpusppy_torch.spbase import build_batch

    t_phase = time.perf_counter()
    ef = main.get("farmer-1000 cm=4", {}).get("ef")
    if ef is None:
        b, _ = build_batch(farmer.scenario_names_creator(1000),
                           farmer.scenario_creator,
                           {"num_scens": 1000, "crops_multiplier": 4})
        ef, _ = solve_ef(b, solver="highs")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        out = {"kill_windows": kill_and_resume(cuda_kernels, workdir,
                                               lean=True, hold=False),
               "kill": kill_and_resume(cuda_kernels, workdir,
                                       refresh=RES_PARITY_REFRESH)}
        out["cost"] = checkpoint_cost(workdir)
        print(f"[{time.perf_counter() - t_phase:.1f} s into the phase]",
              flush=True)
        out["wheel"] = wheel_resume(cuda_kernels, workdir, ef)
        print(f"[{time.perf_counter() - t_phase:.1f} s into the phase]",
              flush=True)
        out["dead"] = dead_spoke(cuda_kernels)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"resilience phase: {time.perf_counter() - t_phase:.1f} s {CARD}",
          flush=True)
    return out


# ---- phase service: the solve server on farmer-1000 -------------------------
#: The service phase's farmer-1000 family and its requests' settings: the
#: hub-only wheel's f64 solver, rel_gap 0.05 (farmer-1000's certified
#: outer bound sits 3-4% below the EF).
SERVICE_S = 1000
SERVICE_KW = {"num_scens": SERVICE_S, "crops_multiplier": 4}
SERVICE_GAP = 0.05
SERVICE_DEVICE = "cuda"
#: Frozen PH iterations of one tenant window in (a).
SERVICE_WINDOW = 15
#: (b) the batched requests' iteration budget; (c) the time-sliced
#: three-cylinder requests' and quantum; (d) the restarted request's.  A
#: cold wheel parks no earlier than the end of its first window
#: (iterations 2-16: one refresh, then 15 frozen), so (c)'s 17 leave a
#: cold request one iteration to run after its park.
SERVICE_BATCH_ITERS = 60
SERVICE_SLICE_ITERS = 17
SERVICE_QUANTUM = 2.0
SERVICE_RESTART_ITERS = 60
#: (d) parks its request once the hub has posted a finite inner bound at
#: this iteration or later, so both parked bounds are real ones.
SERVICE_PARK_FROM = 10


def service_request(seed, iters, S=SERVICE_S, **opts):
    """A farmer ``S`` request (``crops_multiplier`` 4, ``seedoffset``
    ``seed``) at the service phase's settings, its device left to the
    server's default (the card)."""
    from tpusppy_torch.service import SolveRequest

    return SolveRequest(
        model="farmer", num_scens=S,
        creator_kwargs={"seedoffset": seed, "crops_multiplier": 4},
        options=dict({"PHIterLimit": iters, "rel_gap": SERVICE_GAP,
                      "device": SERVICE_DEVICE,
                      "solver_options": dict(HUB_ONLY_SOLVER)}, **opts))


def service_launches(cuda_kernels, label):
    """The sweep kernels launched since the counts were zeroed: the
    dense kernel only, and no plain version."""
    sweep = {f"{t}:{k}": v for (t, k), v in cuda_kernels.counts().items()
             if t in ("launches", "plain_calls") and v}
    check(set(sweep) == {"launches:fused_sweeps"},
          f"service {label}: sweep launches {sweep}, wanted fused_sweeps "
          "only")
    return sweep["launches:fused_sweeps"]


def print_slo(label, srv):
    """The server's SLO summary, with the cold and warm requests' time to
    the first iteration and the graph captures a request."""
    recs = [r for r in srv.slo_records() if r["status"] == "done"]
    s = srv.slo_summary()
    cold = [r["ttfi_s"] for r in recs if not r["warm_hit"]]
    warm = [r["ttfi_s"] for r in recs if r["warm_hit"]]
    print(f"service {label} slo: p50 latency {s['p50_latency_s']:.3f} s, "
          f"p95 {s['p95_latency_s']:.3f} s, p50 queue wait "
          f"{s['p50_queue_wait_s']:.3f} s, p95 {s['p95_queue_wait_s']:.3f} "
          f"s, cold ttfi {[round(v, 3) for v in cold]} s, warm ttfi "
          f"{[round(v, 3) for v in warm]} s, captures a request "
          f"{[int(r['aot_misses']) for r in recs]}, preemptions "
          f"{s['preemptions']}, warm hit rate {s['warm_hit_rate']} {CARD}",
          flush=True)


def service_window(cuda_kernels):
    """(a) K=3 farmer-1000 tenants (seedoffsets 0, 1000, 2000) in one
    tenant window against each slot's solo window, slot 2 a ghost in the
    first window; returns the per-tenant and solo PH rates."""
    import torch

    from tpusppy_torch.models import farmer
    from tpusppy_torch.obs import metrics
    from tpusppy_torch.parallel import sharded
    from tpusppy_torch.solvers import hostsync
    from tpusppy_torch.spbase import build_batch, make_admm_settings
    from tpusppy_torch.spopt import mega_arrays_for_batch

    st = make_admm_settings({"solver_options": dict(HUB_ONLY_SOLVER)})
    dev = torch.device(SERVICE_DEVICE)
    N, K = SERVICE_WINDOW, 3
    names = farmer.scenario_names_creator(SERVICE_S)
    arrs, states, factors = [], [], []
    with cuda_kernels.owned_by("service-prep"):
        for seed in (0, 1000, 2000):
            b, _ = build_batch(names, farmer.scenario_creator,
                               dict(SERVICE_KW, seedoffset=seed))
            idx = b.tree.nonant_indices
            refresh, _ = sharded.make_ph_step_pair(idx, st)
            arr = mega_arrays_for_batch(b, torch.float64, dev)
            s, _, _ = refresh(sharded.init_state(arr, 1.0, st), arr, 0.0)
            s, _, f = refresh(s, arr, 1.0)
            arrs.append(arr)
            states.append(s)
            factors.append(f)
    tenant = sharded.make_tenant_megastep(idx, st, n_iters=N)
    solo = sharded.make_wheel_megastep(idx, st, n_iters=N, pack="lean")
    S = SERVICE_S

    def run_tenant(sts, live, n_live, launches):
        torch.cuda.synchronize()
        with metrics.window() as w:
            t0 = time.perf_counter()
            out, packed = tenant(tuple(sts), tuple(arrs), 1.0,
                                 tuple(factors), [-1.0] * K, n_live,
                                 np.inf, live, slot_launches=launches)
            inside = (w.delta("host_sync.count")
                      - w.delta("admm.loop_checks"))
            meas = sharded.tenant_megastep_unpack(hostsync.fetch(packed),
                                                  N, S, K)
            wall = time.perf_counter() - t0
            fetches = (w.delta("host_sync.count")
                       - w.delta("admm.loop_checks"))
        check(inside == 0 and fetches == 1,
              f"service (a): {inside} fetches inside the window, {fetches} "
              "with its packed fetch (wanted 0 and 1)")
        return out, meas, wall

    def run_solo(s, t, n_live):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with cuda_kernels.owned_by("service-solo"):
            out, packed = solo(s, arrs[t], 1.0, factors[t], -1.0, n_live,
                               np.inf)
            meas = sharded.megastep_unpack(hostsync.fetch(packed), N, S,
                                           0, 0, pack="lean")
        return out, meas, time.perf_counter() - t0

    def close(got, ref):
        got = got.double().cpu().numpy() if hasattr(got, "cpu") else got
        ref = ref.double().cpu().numpy() if hasattr(ref, "cpu") else ref
        got, ref = np.asarray(got, float), np.asarray(ref, float)
        scale = max(1.0, float(np.max(np.abs(ref))))
        return float(np.max(np.abs(got - ref))) / scale

    # one refresh's worth of frozen iterations (N) over the two windows,
    # every iterate accepted (the parity, not the acceptance test, is held):
    # window 1 runs slots 0 and 1 for N // 2 with slot 2 a ghost, window 2
    # runs them on to N and slot 2 for N
    n1 = [N // 2, N // 2, 0]
    n2 = [N - N // 2, N - N // 2, N]
    cuda_kernels.reset_counts()
    launches = [{} for _ in range(K)]
    with cuda_kernels.owned_by("service-window"):
        s1, m1, _ = run_tenant(states, [True, True, False], n1, launches)
        check(all(torch.equal(getattr(s1[2], k), getattr(states[2], k))
                  for k in sharded.PHState._fields),
              "service (a): the ghost slot's state changed")
        check(m1["executed"][2] == 0 and not launches[2],
              f"service (a): the ghost ran ({m1['executed'][2]} "
              f"iterations, launches {launches[2]})")
        s2, m2, wall_k = run_tenant(list(s1[:2]) + [states[2]],
                                    [True] * K, n2, launches)
    n_launch = service_launches(cuda_kernels, "(a)")
    worst = 0.0
    solo_walls = []
    for t in range(K):
        ref_s, chain = states[t], []
        for n_live in ((n1[t], n2[t]) if t < 2 else (n2[t],)):
            ref_s, ref_m, wall = run_solo(ref_s, t, n_live)
            chain.append(ref_m)
            solo_walls.append((wall, ref_m["executed"]))
        got_m = (m1, m2) if t < 2 else (m2,)
        for gm, rm in zip(got_m, chain):
            check(gm["executed"][t] == rm["executed"],
                  f"service (a) slot {t}: executed {gm['executed'][t]}, "
                  f"solo {rm['executed']}")
            worst = max(worst, close(gm["eobj"][t], rm["eobj"]))
        for k in ("W", "xbars"):
            worst = max(worst, close(getattr(s2[t], k), getattr(ref_s, k)))
        sl = launches[t].get(("launches", "fused_sweeps"), 0)
        check(sl > 0 and not any(k[0] == "plain_calls"
                                 for k in launches[t]),
              f"service (a) slot {t}: launches {launches[t]}")
    ex = m2["executed"]
    check(worst <= 1e-9, f"service (a): a slot parts from its solo window "
          f"by {worst:.3e} (relative to the largest entry) > 1e-9")
    solo_rate = np.mean([e / w for w, e in solo_walls])
    check(all(e > 0 for e in m1["executed"][:2]) and min(ex) > 0,
          f"service (a): executed {m1['executed']}, {ex}")
    print(f"service (a) tenant window K={K} N={N} farmer-1000 f64: each "
          f"slot within {worst:.3e} of its solo window (eobj, W, xbars); "
          f"ghost unchanged; fused_sweeps launches by slot "
          f"{[lc.get(('launches', 'fused_sweeps'), 0) for lc in launches]} "
          f"({n_launch} in both windows), one packed fetch a window; "
          f"executed {m1['executed']} then {ex}; window {wall_k:.3f} s: "
          f"{[round(e / wall_k, 3) for e in ex]} PH it/s a tenant "
          f"({sum(ex) / wall_k:.3f} in all) against a solo window's "
          f"{solo_rate:.3f} {CARD}", flush=True)
    from tpusppy_torch.solvers import device_loop

    for tok in ("service-prep", "service-window", "service-solo"):
        device_loop.release(tok)
    return {"tenant_rate": sum(ex) / wall_k / K, "solo_rate": solo_rate}


def service_batched(cuda_kernels, workdir, ef):
    """(b) SolveServer(batch_slots=3, in_wheel_bounds=True): seedoffsets
    0, 1000, 2000, then a fourth request that joins late."""
    from tpusppy_torch.obs import metrics
    from tpusppy_torch.service import SolveServer

    cuda_kernels.reset_counts()
    t0 = time.perf_counter()
    with metrics.window() as w, SolveServer(
            work_dir=workdir, batch_slots=3, in_wheel_bounds=True,
            quantum_secs=600.0, linger_secs=0.0) as srv:
        rids = [srv.submit(service_request(seed, SERVICE_BATCH_ITERS))
                for seed in (0, 1000, 2000)]
        lead = srv._tenants[rids[0]]
        # the leader's first window ends: every graph the batch binds is
        # captured by then, so nothing after it may capture
        while (w.delta("batching.windows") < 1
               and not lead.done.is_set()):
            time.sleep(0.01)
        caps_first = w.delta("device_loop.captures")
        rids.append(srv.submit(service_request(3000, SERVICE_BATCH_ITERS)))
        recs = [srv.result(r, timeout=600) for r in rids]
        caps_end = w.delta("device_loop.captures")
        joins = w.delta("batching.joins")
        windows = w.delta("batching.windows")
        print_slo("(b) batched", srv)
    wall = time.perf_counter() - t0
    n_launch = service_launches(cuda_kernels, "(b)")
    for i, r in enumerate(recs):
        print(f"service (b) request {i} (seedoffset {1000 * i}): "
              f"{r['status']} batched={r['batched']} certified="
              f"{r['certified']} outer={r['outer']:.6f} inner="
              f"{r['inner']:.6f} rel_gap={r['rel_gap']:.3e} iters="
              f"{r['iters']} warm={r['warm_hit']} captures="
              f"{int(r['aot_misses'])} capture_s={r['compile_s']:.3f} "
              f"ttfi={r['ttfi_s']:.3f} s wall={r['wall_s']:.3f} s "
              f"attributed_flops={r['attributed_flops']:.4g} {CARD}",
              flush=True)
        check(r["status"] == "done" and r["batched"] and r["certified"]
              and r["outer"] <= r["inner"],
              f"service (b) request {i}: {r}")
        if i:
            check(r["aot_misses"] == 0,
                  f"service (b) request {i} captured {r['aot_misses']} "
                  "graphs (a member after the leader must capture none)")
    # the device's count: no capture after the leader's first window (the
    # joiners, the late fourth request too), and the records bill every
    # capture of (b) to the member that ran it
    billed = sum(r["aot_misses"] for r in recs)
    check(caps_end == caps_first and billed == caps_end,
          f"service (b): {caps_first:.0f} graph captures by the end of the "
          f"leader's first window, {caps_end:.0f} at the end, {billed:.0f} "
          "billed to the records")
    r0 = recs[0]
    check(r0["outer"] <= ef + 1e-6 * abs(ef)
          and r0["inner"] >= ef - 1e-4 * abs(ef),
          f"service (b) seed 0: outer {r0['outer']} inner {r0['inner']} "
          f"against the EF {ef}")
    check(joins >= 4, f"service (b): {joins} joins (wanted >= 4)")
    print(f"service (b) batched: joins {joins:.0f}, windows {windows:.0f}, "
          f"graph captures {caps_first:.0f} by the end of the leader's "
          f"first window and {caps_end:.0f} in all, "
          f"fused_sweeps launches {n_launch}, seed-0 outer "
          f"{(r0['outer'] - ef) / abs(ef):.3e} and inner "
          f"{(r0['inner'] - ef) / abs(ef):.3e} from the EF {ef:.6f}; "
          f"{wall:.1f} s {CARD}", flush=True)
    return recs


def service_sliced(cuda_kernels, workdir):
    """(c) time-slicing over the hub, Lagrangian and XhatShuffle wheel:
    farmer-1000 seed 0, farmer-500 seed 0 and farmer-1000 seed 77."""
    from tpusppy_torch.obs import metrics
    from tpusppy_torch.service import SolveServer

    cuda_kernels.reset_counts()
    t0 = time.perf_counter()
    with metrics.window() as w, SolveServer(
            work_dir=workdir, quantum_secs=SERVICE_QUANTUM,
            linger_secs=5.0) as srv:
        reqs = [service_request(0, SERVICE_SLICE_ITERS),
                service_request(0, SERVICE_SLICE_ITERS, S=SERVICE_S // 2),
                service_request(77, SERVICE_SLICE_ITERS)]
        rids = [srv.submit(r) for r in reqs]
        recs = [srv.result(r, timeout=900) for r in rids]
        preempts = w.delta("service.preemptions")
        print_slo("(c) time-sliced", srv)
    wall = time.perf_counter() - t0
    n_launch = service_launches(cuda_kernels, "(c)")
    for label, r in zip(("farmer-1000 seed 0", "farmer-500 seed 0",
                         "farmer-1000 seed 77"), recs):
        print(f"service (c) {label}: {r['status']} certified="
              f"{r['certified']} outer={r['outer']:.6f} inner="
              f"{r['inner']:.6f} rel_gap={r['rel_gap']:.3e} iters="
              f"{r['iters']} slices={r['slices']} preemptions="
              f"{r['preemptions']} monotone={r['bounds_monotone']} warm="
              f"{r['warm_hit']} captures={int(r['aot_misses'])} "
              f"capture_s={r['compile_s']:.3f} ttfi={r['ttfi_s']:.3f} s "
              f"wall={r['wall_s']:.3f} s {CARD}", flush=True)
        check(r["status"] == "done" and r["bounds_monotone"]
              and np.isfinite(r["outer"]) and r["outer"] <= r["inner"],
              f"service (c) {label}: {r}")
    slices = sum(r["slices"] for r in recs)
    check(preempts >= 1 and slices > 3,
          f"service (c): {preempts:.0f} preemptions, {slices} slices")
    check(recs[2]["warm_hit"] and recs[2]["aot_misses"] == 0
          and recs[2]["ttfi_s"] < recs[0]["ttfi_s"],
          f"service (c): the second farmer-1000 request warm="
          f"{recs[2]['warm_hit']}, {recs[2]['aot_misses']} captures, ttfi "
          f"{recs[2]['ttfi_s']} against {recs[0]['ttfi_s']}")
    print(f"service (c) time-sliced: {preempts:.0f} preemptions, {slices} "
          f"slices, fused_sweeps launches {n_launch}; {wall:.1f} s {CARD}",
          flush=True)
    return recs


def service_restart(cuda_kernels, workdir):
    """(d) shutdown(wait=False) parks a running farmer-1000 request and a
    server recovered over the same work directory completes it."""
    from tpusppy_torch.service import SolveServer

    cuda_kernels.reset_counts()
    t0 = time.perf_counter()
    kw = dict(in_wheel_bounds=True, quantum_secs=600.0, linger_secs=0.0)
    limit = SERVICE_RESTART_ITERS
    with SolveServer(work_dir=workdir, **kw) as srv:
        rid = srv.submit(service_request(0, limit, rel_gap=1e-12))
        t = srv._tenants[rid]
        cursor, posted = 0, None
        t_wait = time.perf_counter()
        while posted is None and not t.done.is_set():
            check(time.perf_counter() - t_wait < 300.0,
                  "service (d): no finite inner bound in 300 s")
            evs, cursor, _, _ = srv.progress.poll(rid, cursor)
            for ev in evs:
                if (ev["kind"] == "bound_update"
                        and np.isfinite(ev["inner"])
                        and ev["iteration"] >= SERVICE_PARK_FROM):
                    posted = ev
            time.sleep(0.01)
        srv.shutdown(wait=False)
        park = dict(t.record)
    check(t.status == "parked" and park["iters"] < limit
          and np.isfinite(park["outer"]) and np.isfinite(park["inner"]),
          f"service (d): {t.status} at iteration {park['iters']} (outer "
          f"{park['outer']}, inner {park['inner']}; bound posted {posted})")
    srv2 = SolveServer.recover_from(workdir, **kw)
    try:
        rec = srv2.result(rid, timeout=600)
    finally:
        srv2.shutdown()
    n_launch = service_launches(cuda_kernels, "(d)")
    print(f"service (d) restart: parked at iteration {park['iters']} "
          f"(outer {park['outer']:.6f}, inner {park['inner']:.6f}); "
          f"recovered {rec['recovered']}: {rec['status']} at iteration "
          f"{rec['iters']}, outer {rec['outer']:.6f}, inner "
          f"{rec['inner']:.6f}, slices {rec['slices']}, preemptions "
          f"{rec['preemptions']}; fused_sweeps launches {n_launch}; "
          f"{time.perf_counter() - t0:.1f} s {CARD}", flush=True)
    check(rec["status"] == "done" and rec["iters"] == limit
          and rec["recovered"] == "warm" and rec["bounds_monotone"]
          and rec["outer"] >= park["outer"] - 1e-9
          and rec["inner"] <= park["inner"] + 1e-9,
          f"service (d): {rec} after the park {park}")
    return rec


def service_tcp(cuda_kernels, workdir):
    """(e) one farmer-1000 request through a TcpServiceFrontend, and its
    scrape endpoint."""
    import urllib.request

    from tpusppy_torch.service import SolveServer
    from tpusppy_torch.service.net import SolveClient, TcpServiceFrontend

    cuda_kernels.reset_counts()
    t0 = time.perf_counter()
    with SolveServer(work_dir=workdir, in_wheel_bounds=True,
                     quantum_secs=600.0, linger_secs=0.0) as srv:
        front = TcpServiceFrontend(srv, slots=2, scrape_port=0)
        try:
            cli = SolveClient("127.0.0.1", front.port, front.secret, slot=1)
            try:
                rec = cli.solve(service_request(0, SERVICE_BATCH_ITERS)
                                .to_dict(), timeout=600)
            finally:
                cli.close()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{front.scrape_port}/metrics",
                    timeout=30) as resp:
                code, body = resp.status, resp.read().decode()
        finally:
            front.close()
    n_launch = service_launches(cuda_kernels, "(e)")
    print(f"service (e) tcp: {rec['status']} certified={rec['certified']} "
          f"rel_gap={rec['rel_gap']:.3e} outer={rec['outer']:.6f} inner="
          f"{rec['inner']:.6f}; GET /metrics {code}, {len(body)} bytes; "
          f"fused_sweeps launches {n_launch}; "
          f"{time.perf_counter() - t0:.1f} s {CARD}", flush=True)
    check(rec["status"] == "done" and code == 200
          and "tpusppy_service_completed_total" in body,
          f"service (e): {rec['status']}, /metrics {code}")
    return rec


def phase_service(cuda_kernels, main):
    """The service tier on farmer-1000 crops_multiplier=4 through
    ``fused_sweeps``: (a) the tenant window against solo windows, (b)
    batched serving, (c) time-slicing with preemption over the
    three-cylinder wheel, (d) restart recovery, (e) the TCP front end.
    ``main``: the main phases' runs (the farmer EF, computed here when the
    farmer phase did not run)."""
    import shutil
    import tempfile

    from tpusppy_torch.ef import solve_ef
    from tpusppy_torch.models import farmer
    from tpusppy_torch.spbase import build_batch

    t_phase = time.perf_counter()
    ef = main.get("farmer-1000 cm=4", {}).get("ef")
    if ef is None:
        b, _ = build_batch(farmer.scenario_names_creator(SERVICE_S),
                           farmer.scenario_creator, dict(SERVICE_KW))
        ef, _ = solve_ef(b, solver="highs")
    out = {"window": service_window(cuda_kernels)}
    for part, fn in (("batched", service_batched), ("sliced",
                                                     service_sliced),
                     ("restart", service_restart), ("tcp", service_tcp)):
        workdir = tempfile.mkdtemp(prefix=f"chip_smoke_{part}_")
        try:
            out[part] = (fn(cuda_kernels, workdir, ef) if part == "batched"
                         else fn(cuda_kernels, workdir))
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(f"[{time.perf_counter() - t_phase:.1f} s into the phase]",
              flush=True)
    print(f"service phase: {time.perf_counter() - t_phase:.1f} s {CARD}",
          flush=True)
    return out


def kernel_line(name, source, replaces, launches, res):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": res["abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None}


PHASES = ("kernels", "golden", "loop", "farmer", "uc_lite", "uc",
          "megastep", "precision", "wheel", "bundles", "integer",
          "resilience", "service")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                         + "; the result lines print only when all ran")
    # the resilience phase's killed process (prints no result line)
    ap.add_argument("--resilience-child", nargs=5,
                    metavar=("DIR", "EPS", "QP_TOL", "REFRESH", "LEAN"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.resilience_child:
        ckdir, eps, tol, refresh, lean = args.resilience_child
        return resilience_child(ckdir, float(eps),
                                None if tol == "None" else float(tol),
                                None if refresh == "None" else int(refresh),
                                lean == "True")
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}")
    if not os.path.isdir(os.path.join(HERE, "tpusppy_torch")):
        print("FAIL: tpusppy_torch/ not found beside chip_smoke.py; run it "
              "from a checkout of the repository", flush=True)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false; chip_smoke.py "
              "needs one CUDA device", flush=True)
        return 2
    sys.path.insert(0, HERE)
    from tpusppy_torch.solvers import cuda_kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()
    ef_pool = start_ef_prefetch() if phases & {"golden", "uc_lite"} else None
    int_pool = int_efs = None
    global CARD
    main_runs = {}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(smi, flush=True)
        CARD = f"[{smi}]"
        print(f"card: {torch.cuda.get_device_name(0)} x "
              f"{torch.cuda.device_count()}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}", flush=True)
        t0 = time.perf_counter()
        cuda_kernels.build()
        print(f"build: {', '.join(cuda_kernels.build_log)} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for name, log in cuda_kernels.build_log.items():
            regs = [int(w) for line in log.splitlines()
                    if "registers" in line
                    for w, nxt in zip(line.split(), line.split()[1:])
                    if nxt == "registers,"]
            spills = [line.strip() for line in log.splitlines()
                      if "spill stores" in line
                      and not line.strip().startswith("0 bytes stack")]
            print(f"  {name}: {len(regs)} kernels, at most "
                  f"{max(regs, default=0)} registers a thread, "
                  f"{len(spills)} with a stack or spills"
                  + (f" (largest: {max(spills, key=len)})" if spills
                     else ""), flush=True)
        if "kernels" in phases:
            kres = phase_kernels(cuda_kernels)
            print(f"[{time.perf_counter() - t_all:.1f} s] kernels done",
                  flush=True)
        golden, mega = {}, {"legacy": {}}
        if "golden" in phases:
            golden = phase_golden(cuda_kernels)
            print(f"[{time.perf_counter() - t_all:.1f} s] goldens done",
                  flush=True)
        if "loop" in phases:
            phase_loop(cuda_kernels)
            print(f"[{time.perf_counter() - t_all:.1f} s] loop done",
                  flush=True)
        if "farmer" in phases:
            farmer = main_runs["farmer-1000 cm=4"] = phase_main(
                cuda_kernels, "farmer-1000 cm=4", "fused_sweeps",
                lambda o, cls: farmer_ph(1000, 4, o, ph_class=cls), 100,
                10, {"defaultPHrho": 1.0, "convthresh": 1e-6})
        if "uc_lite" in phases:
            uc_lite = main_runs["uc_lite-1000"] = phase_main(
                cuda_kernels, "uc_lite-1000", "fused_sweeps_shared",
                lambda o, cls: uc_ph(1000, o, ph_class=cls), 50, 3,
                UC_MAIN_OPTIONS)
        if "uc" in phases:
            uc = main_runs["uc-1000"] = phase_main(
                cuda_kernels, "uc-1000", "fused_sweeps_sparse",
                lambda o, cls: uc_full_ph(1000, o, ph_class=cls), 15,
                1, UC_MAIN_OPTIONS, solver=UC_SOLVER,
                ef=False)
        if phases & {"farmer", "uc_lite", "uc"}:
            print(f"[{time.perf_counter() - t_all:.1f} s] main paths done",
                  flush=True)
        if "megastep" in phases:
            mega = phase_megastep(cuda_kernels, main_runs, golden)
            print(f"[{time.perf_counter() - t_all:.1f} s] megastep done",
                  flush=True)
        if "precision" in phases:
            prec = phase_precision(cuda_kernels, main_runs, mega["legacy"])
            print(f"[{time.perf_counter() - t_all:.1f} s] precision done",
                  flush=True)
        if "wheel" in phases:
            phase_wheel(cuda_kernels, main_runs, mega.get("farmer_wheel"))
            print(f"[{time.perf_counter() - t_all:.1f} s] wheel done",
                  flush=True)
        if "integer" in phases:
            int_pool, int_efs = start_integer_efs()
        if "bundles" in phases:
            t0 = time.perf_counter()
            phase_bundles(cuda_kernels, main_runs)
            print(f"[{time.perf_counter() - t_all:.1f} s] bundles done "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if "integer" in phases:
            t0 = time.perf_counter()
            phase_integer(cuda_kernels, int_efs)
            print(f"[{time.perf_counter() - t_all:.1f} s] integer done "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if "resilience" in phases:
            t0 = time.perf_counter()
            phase_resilience(cuda_kernels, main_runs)
            print(f"[{time.perf_counter() - t_all:.1f} s] resilience done "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
        if "service" in phases:
            t0 = time.perf_counter()
            phase_service(cuda_kernels, main_runs)
            print(f"[{time.perf_counter() - t_all:.1f} s] service done "
                  f"({time.perf_counter() - t0:.1f} s)", flush=True)
    except PhaseError as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    finally:
        if ef_pool is not None:
            ef_pool.shutdown(wait=False, cancel_futures=True)
        if int_pool is not None:
            int_pool.shutdown(wait=True, cancel_futures=True)
    print(f"total: {time.perf_counter() - t_all:.1f} s", flush=True)
    if phases != set(PHASES):
        return 0
    f32 = torch.float32
    print(json.dumps({"kernels": [
        kernel_line("fused_sweeps", "tpusppy_torch/csrc/fused_sweeps.cu",
                    "tpusppy/solvers/pallas_kernels.py:57",
                    farmer["launches"],
                    kres["fused_sweeps"][("farmer-1000", f32)]),
        kernel_line("fused_sweeps_shared",
                    "tpusppy_torch/csrc/fused_sweeps_shared.cu",
                    "tpusppy/solvers/pallas_kernels.py:265",
                    uc_lite["launches"],
                    kres["fused_sweeps_shared"][(1000, f32, 1)]),
        kernel_line("fused_sweeps_sparse",
                    "tpusppy_torch/csrc/fused_sweeps_sparse.cu",
                    "tpusppy/solvers/pallas_kernels.py:423",
                    uc["launches"],
                    kres["fused_sweeps_sparse"][("structured", f32, 1)]),
    ] + [
        # each kernel at each lowered mode, on its main path's mode: the
        # launches of the precision phase's run at that mode
        kernel_line(f"{name}[{mode}]", f"tpusppy_torch/csrc/{name}.cu",
                    f"tpusppy/solvers/pallas_kernels.py:{line}",
                    prec[(label, mode)]["lowered"][f"{name}:{mode}"],
                    kres["lowered"][(name, mode, kmode, f32)])
        for name, mode, kmode, label, line in (
            ("fused_sweeps", "default", "farmer-1000", "farmer-1000 cm=4",
             90),
            ("fused_sweeps_shared", "default", "streamed", "uc_lite-1000",
             276),
            ("fused_sweeps_shared", "high", "streamed", "uc_lite-1000",
             276),
            ("fused_sweeps_sparse", "default", "structured", "uc-1000",
             469))
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
