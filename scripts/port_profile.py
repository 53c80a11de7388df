#!/usr/bin/env python3
"""Where a PH iteration of the PyTorch/CUDA port spends its time on the card.

    python3 scripts/port_profile.py [--model farmer|uc_lite|uc|wheel]
                                    [--scens 1000] [--crops-multiplier 4]
                                    [--warm-iters 20] [--iters 5]
                                    [--megastep 0|1] [--in-wheel]
                                    [--no-ladder] [--bundles 300]
                                    [--spoke-dtype float64]
                                    [--lagrangian-rescue-cap 64]

Runs PH (float32, eps 1e-5) through ``tpusppy_torch`` on one CUDA device,
on farmer (``--crops-multiplier``; rho 1, the dense engine), on uc_lite at
its defaults (LP relaxation; rho 500, the shared-A engine) or on uc at its
full width (30 generators x 24 hours, LP relaxation; rho 500 and
bench_uc.py's solver settings, the structured-KKT engine): Iter0 and
``--warm-iters`` iterations, then ``--iters`` iterations timed on the host
clock, then ``--iters`` more under ``torch.profiler``, each window through
``iterk_loop`` at ``--megastep`` (0, the default: megastep windows of 15
between the refreshes, every 16 iterations; 1: the legacy loop), so
``--warm-iters 16 --iters 16`` times one refresh and one whole window.
uc's frozen iterates never meet the frozen acceptance ladder at these
settings, so its windows never start (chip_smoke.py, phase ``megastep``):
``--no-ladder`` turns the ladder off (``straggler_tol_qp`` 1e30) in either
protocol.  ``--bundles N`` (farmer) bundles the scenarios into N bundle EFs
with shape buckets (``bundles_per_rank`` N, ``shape_buckets``): at S=1000
and N=300, 200 bundles of 3 scenarios and 100 of 4, two buckets, every
iteration one frozen solve a bucket.
Prints one JSON line: the card, the untraced window's wall seconds per
iteration, device-busy seconds per iteration in the traced window (the union
of kernel intervals on the timeline), the idle share (busy against the
UNTRACED wall, since the profiler slows the host), the hand-written sweep
kernels' device seconds per iteration, host syncs (every device-to-host
read, the sweep loop's stop-flag reads among them, counted apart as loop
checks, and the windows' packed fetches), CUDA-graph replays and captures
of the sweep loop and the host
seconds its captures took, the blocks its replays ran (gated ones
included) and the blocks that swept (all in the untraced window), kernel
launches per
iteration (device kernels, and hand-written kernel launches in the traced
window, which tell a frozen iteration from a refresh, also by each
kernel's mode), and the top device kernels by time.  Imports nothing of
JAX.

``--model wheel`` profiles the farmer wheel instead (the farmer PH as the
hub of ``WheelSpinner``, with the Lagrangian, XhatShuffle and XhatXbar
spokes, each cylinder on a CUDA stream of its own, no gap termination):
the windows are hub iterations while the spokes run, the busy share is
that of the whole card (every cylinder's kernels), and each cylinder's
launches per hub iteration, solves and host-exact straggler re-solves are
added.  The spokes solve in ``--spoke-dtype`` (f64, as in chip_smoke.py's
wheel) and the Lagrangian rescues at most ``--lagrangian-rescue-cap``
stragglers a solve (64, the default of the reference and the port), so
two runs that differ in one of them show what it costs the hub.  With
``--in-wheel`` the wheel is the hub alone with ``in_wheel_bounds``: its
windows certify with their own bound pass, and no spoke runs.  The hub's
windows are marked at window ends, so each timed span covers whole
windows from the first end at or past its start.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


def busy_seconds(events):
    """Union length of [start, end) device intervals (microseconds in)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total * 1e-6


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("farmer", "uc_lite", "uc", "wheel"),
                    default="farmer")
    ap.add_argument("--scens", type=int, default=1000)
    ap.add_argument("--crops-multiplier", type=int, default=4)
    ap.add_argument("--warm-iters", type=int, default=20)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--spoke-dtype", choices=("float32", "float64"),
                    default="float64")
    ap.add_argument("--lagrangian-rescue-cap", type=int, default=64)
    ap.add_argument("--megastep", type=int, choices=(0, 1), default=0)
    ap.add_argument("--in-wheel", action="store_true")
    ap.add_argument("--no-ladder", action="store_true")
    ap.add_argument("--bundles", type=int, default=0)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpusppy_torch.models import farmer, uc, uc_lite
    from tpusppy_torch.obs import metrics
    from tpusppy_torch.opt.ph import PH
    from tpusppy_torch.solvers import cuda_kernels

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    S, cm = args.scens, args.crops_multiplier
    solver = {"dtype": "float32", "eps_abs": 1e-5, "eps_rel": 1e-5,
              "megastep": args.megastep}
    if args.model == "wheel":
        return profile_wheel(args, solver)
    if args.model == "farmer":
        model, rho = farmer, 1.0
        kw = {"num_scens": S, "crops_multiplier": cm}
    else:
        model = uc_lite if args.model == "uc_lite" else uc
        rho = 500.0
        kw = {"num_scens": S, "relax_integers": True}
    if args.model == "uc":
        # bench_uc.py's UC solver settings
        solver.update(max_iter=200, restarts=2, scaling_iters=6,
                      solve_refine=1, sweep_plateau_rtol=0.05,
                      sweep_plateau_window=8)
    ladder = {"straggler_tol_qp": 1e30} if args.no_ladder else {}
    if args.bundles:
        ladder.update(bundles_per_rank=args.bundles, shape_buckets=True)
    ph = PH({"defaultPHrho": rho, "PHIterLimit": args.warm_iters,
             "convthresh": 0.0, "solver_options": solver, **ladder},
            model.scenario_names_creator(S), model.scenario_creator,
            scenario_creator_kwargs=kw)
    ph.ph_main()
    torch.cuda.synchronize()
    n = args.iters

    def run_iters():
        ph.options["PHIterLimit"] = ph._iter + n
        ph.iterk_loop()
        torch.cuda.synchronize()

    with metrics.window() as win:
        t0 = time.perf_counter()
        run_iters()
        wall = (time.perf_counter() - t0) / n
    # read now: the window's deltas run on while the traced window runs
    untraced = {k: win.delta(k) / n for k in (
        "host_sync.count", "admm.loop_checks", "device_loop.replays",
        "device_loop.blocks", "device_loop.captures",
        "device_loop.capture_secs", "solve.sweeps", "dispatch.megasteps",
        "dispatch.mega_iterations")}
    cuda_kernels.reset_counts()
    with profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_iters()
        traced_wall = (time.perf_counter() - t0) / n
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print("FAIL: the profiler recorded no device kernels", flush=True)
        return 1
    busy = busy_seconds(dev) / n
    by_name = {}
    for e in dev:
        name = e.name[:100]
        by_name[name] = by_name.get(name, 0.0) + (
            e.time_range.end - e.time_range.start) * 1e-6 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    sweep_s = sum((e.time_range.end - e.time_range.start) * 1e-6
                  for e in dev if "fused_sweeps" in e.name) / n
    smi = card()
    print(json.dumps({
        "card": smi, "model": args.model, "scens": S,
        "crops_multiplier": cm if args.model == "farmer" else None,
        "iters": n, "megastep": args.megastep,
        "no_ladder": args.no_ladder, "bundles": args.bundles,
        "buckets": [(int(i.size), sub.num_rows, sub.num_vars)
                    for i, sub in getattr(ph.batch, "buckets", [])],
        "window_n": ph._megastep_request(),
        "wall_s_per_iter": wall, "traced_wall_s_per_iter": traced_wall,
        "device_busy_s_per_iter": busy, "idle_share": 1.0 - busy / wall,
        "device_kernels_per_iter": len(dev) / n,
        "sweep_kernel_s_per_iter": sweep_s,
        "host_syncs_per_iter": untraced["host_sync.count"],
        "loop_checks_per_iter": untraced["admm.loop_checks"],
        "packed_fetches_per_iter": untraced["dispatch.megasteps"],
        "window_iterations_per_iter": untraced["dispatch.mega_iterations"],
        "graph_replays_per_iter": untraced["device_loop.replays"],
        "blocks_replayed_per_iter": untraced["device_loop.blocks"],
        "sweep_blocks_per_iter": untraced["solve.sweeps"] / max(
            1, ph.admm_settings.check_every),
        "graph_captures_per_iter": untraced["device_loop.captures"],
        "capture_s_per_iter": untraced["device_loop.capture_secs"],
        "kernel_launches_per_iter": {k: v / n for k, v in
                                     cuda_kernels.launches.items()},
        "launches_by_mode_per_iter": {
            name: {k: v / n for k, v in modes.items()}
            for name, modes in (("fused_sweeps", cuda_kernels.dense_modes),
                                ("fused_sweeps_shared",
                                 cuda_kernels.shared_modes),
                                ("fused_sweeps_sparse",
                                 cuda_kernels.sparse_modes))},
        "top_kernels_s_per_iter": top}), flush=True)
    return 0


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def profile_wheel(args, solver):
    """The farmer wheel's hub iterations from the first iteration end at
    or past ``warm`` to the first at or past ``warm + n`` on the host
    clock, then to the first at or past ``warm + 2n`` under
    ``torch.profiler`` (started and stopped at the hub's iteration ends:
    each legacy iteration and each window), while the spokes run.  With
    ``--in-wheel`` the hub runs alone with ``in_wheel_bounds``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tpusppy_torch.cylinders import (LagrangianOuterBound, PHHub,
                                         XhatShuffleInnerBound,
                                         XhatXbarInnerBound)
    from tpusppy_torch.models import farmer
    from tpusppy_torch.obs import metrics
    from tpusppy_torch.opt.ph import PH
    from tpusppy_torch.phbase import PHBase
    from tpusppy_torch.spin_the_wheel import WheelSpinner
    from tpusppy_torch.xhat_eval import Xhat_Eval

    S, cm, w, n = (args.scens, args.crops_multiplier, args.warm_iters,
                   args.iters)
    marks = {}

    def mark(k):
        if "k0" not in marks and k >= w:
            marks.update(k0=k, win=metrics.window().__enter__(),
                         t0=time.perf_counter())
        elif "k1" not in marks and "k0" in marks and k >= w + n:
            span = k - marks["k0"]
            marks.update(k1=k, wall=(time.perf_counter() - marks["t0"])
                         / span,
                         syncs=marks["win"].delta("host_sync.count") / span,
                         prof=profile(activities=[ProfilerActivity.CPU,
                                                  ProfilerActivity.CUDA]))
            marks["prof"].__enter__()
            marks["t1"] = time.perf_counter()
        elif "k2" not in marks and "k1" in marks and k >= w + 2 * n:
            marks["prof"].__exit__(None, None, None)
            marks.update(k2=k, traced=(time.perf_counter() - marks["t1"])
                         / (k - marks["k1"]))

    class Marked(PH):
        def _iterk_one(self, k, convthresh):
            out = super()._iterk_one(k, convthresh)
            mark(self._iter)
            return out

        def _apply_megastep_meas(self, k, meas):
            super()._apply_megastep_meas(k, meas)
            mark(self._iter)

    def okw():
        return {"options": {"defaultPHrho": 1.0, "PHIterLimit": w + 3 * n,
                            "convthresh": -1.0, "batch_cache": True,
                            "in_wheel_bounds": args.in_wheel,
                            "xhat_looper_options": {"scen_limit": 3},
                            "solver_options": dict(solver)},
                "all_scenario_names": farmer.scenario_names_creator(S),
                "scenario_creator": farmer.scenario_creator,
                "scenario_creator_kwargs": {"num_scens": S,
                                            "crops_multiplier": cm}}

    hub = {"hub_class": PHHub, "hub_kwargs": {"options": {}},
           "opt_class": Marked, "opt_kwargs": okw()}
    spokes = []
    spoke_solver = dict(solver, dtype=args.spoke_dtype)
    for sc, oc, extra in ((LagrangianOuterBound, PHBase,
                           {"straggler_lp_max": args.lagrangian_rescue_cap}),
                          (XhatShuffleInnerBound, Xhat_Eval, {}),
                          (XhatXbarInnerBound, Xhat_Eval, {})):
        if args.in_wheel:
            break
        kw = okw()
        kw["options"].update(extra, in_wheel_bounds=False,
                             solver_options=spoke_solver)
        spokes.append({"spoke_class": sc, "opt_class": oc,
                       "opt_kwargs": kw})
    with metrics.window() as whole:
        ws = WheelSpinner(hub, spokes).spin()
        passes = whole.delta("megastep.bound_passes")
        rescues = whole.delta("megastep.bound_rescues")
    if "k2" not in marks:
        print(f"FAIL: the hub's iteration ends {marks} never passed "
              f"{w + 2 * n}", flush=True)
        return 1
    dev = [e for e in marks["prof"].events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        print("FAIL: the profiler recorded no device kernels", flush=True)
        return 1
    span = marks["k2"] - marks["k1"]
    busy = busy_seconds(dev) / span
    sweep_s = sum((e.time_range.end - e.time_range.start) * 1e-6
                  for e in dev if "fused_sweeps" in e.name) / span
    iters = ws.opt._iter
    print(json.dumps({
        "card": card(), "model": "wheel", "scens": S, "crops_multiplier": cm,
        "megastep": args.megastep, "window_n": ws.opt._megastep_request(),
        "in_wheel": args.in_wheel, "spokes": len(spokes),
        "spoke_dtype": args.spoke_dtype,
        "lagrangian_rescue_cap": args.lagrangian_rescue_cap,
        "timed_hub_iterations": [marks["k0"], marks["k1"], marks["k2"]],
        "hub_wall_s_per_iter": marks["wall"],
        "traced_wall_s_per_iter": marks["traced"],
        "device_busy_s_per_iter": busy,
        "idle_share": 1.0 - busy / marks["wall"],
        "idle_share_of_traced_wall": 1.0 - busy / marks["traced"],
        "device_kernels_per_iter": len(dev) / span,
        "sweep_kernel_s_per_iter": sweep_s,
        "hub_host_syncs_per_iter_all_cylinders": marks["syncs"],
        "bound_passes": passes, "bound_rescues": rescues,
        "outer": ws.BestOuterBound, "inner": ws.BestInnerBound,
        "launches_per_hub_iter": {
            name: {f"{t}:{k}": v / iters for (t, k), v in
                   st["launches"].items() if t == "launches"}
            for name, st in ws.stats.items()},
        "host_syncs_per_hub_iter": {name: st["host_syncs"] / iters
                                    for name, st in ws.stats.items()},
        "solves": {name: st["solves"] for name, st in ws.stats.items()},
        "rescued": {name: st["rescued"] for name, st in ws.stats.items()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
