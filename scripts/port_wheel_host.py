#!/usr/bin/env python3
"""The facts behind the farmer wheel's spoke settings (tpusppy_torch).

    python3 scripts/port_wheel_host.py [--device cuda|cpu] [--scens 1000]
                                       [--crops-multiplier 4]
                                       [--hub-iters 30]

Runs on the card unless ``--device cpu`` is given (and raises when there is
no card).

1. Threads: the same small PyTorch ops on host tensors, run serially, on
   one new thread without and with ``torch.set_num_threads`` inside it (a
   new thread's OpenMP team takes the default size), and on 2 and 4
   threads at once (every call drops and retakes the interpreter lock).
   Host seconds.
2. Candidate evaluation at farmer-``--scens`` (``Xhat_Eval``, eps 1e-5), in
   f32 and in f64: the residual census with no straggler rescue (scenarios
   above 1e-4, 1e-3, 1e-2, and the largest) at the HiGHS EF's first stage
   and at it scaled by 1 + 1e-5, and each candidate's objective relative
   to the EF with the defaults (the 1e-3 feasibility gate, at most 64
   host-exact rescues a solve).
3. The Lagrangian bound at the W of ``--hub-iters`` f32 PH iterations: in
   f32 with at most 64 rescues and with every straggler rescued, in f64
   with at most 64, and that f64 bound raised scenario by scenario by 24
   donor duals (``dual_donor_bounds``, the reference's bound at S=1000);
   each bound relative to the EF, the scenarios rescued, and the seconds
   of the solve and bound.

Prints one JSON line.  Imports nothing of JAX.
"""

import argparse
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

EPS = 1e-5


def thread_costs(reps=20000):
    import torch

    x = torch.randn(3, 44, 44, dtype=torch.float64)
    v = torch.randn(3, 44, 1, dtype=torch.float64)

    def work(set_threads):
        if set_threads:
            torch.set_num_threads(1)
        for _ in range(reps):
            y = torch.bmm(x, v) + 1.0
            torch.where(y > 0, y, -y)

    def timed(n, set_threads):
        ts = [threading.Thread(target=work, args=(set_threads,))
              for _ in range(n)]
        t0 = time.perf_counter()
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        return time.perf_counter() - t0

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    work(False)
    serial = time.perf_counter() - t0
    return {"serial_s": serial,
            "one_new_thread_default_team_s": timed(1, False),
            "one_new_thread_one_thread_s": timed(1, True),
            "two_threads_s": timed(2, True), "four_threads_s": timed(4, True)}


def farmer_kwargs(S, cm):
    from tpusppy_torch.models import farmer

    return {"all_scenario_names": farmer.scenario_names_creator(S),
            "scenario_creator": farmer.scenario_creator,
            "scenario_creator_kwargs": {"num_scens": S,
                                        "crops_multiplier": cm}}


def options(device, dtype, **extra):
    return {"defaultPHrho": 1.0, "PHIterLimit": 1, "device": device,
            "solver_options": {"dtype": dtype, "eps_abs": EPS,
                               "eps_rel": EPS}, **extra}


def evaluation_census(device, S, cm, dtype, ef, xs):
    import numpy as np

    from tpusppy_torch.xhat_eval import Xhat_Eval

    kw = farmer_kwargs(S, cm)
    raw = Xhat_Eval(options(device, dtype, straggler_rescue=False), **kw)
    gated = Xhat_Eval(options(device, dtype), **kw)
    base = np.asarray(xs)[:, raw.tree.nonant_indices]
    out = {}
    for tag, scale in (("ef", 1.0), ("ef*(1+1e-5)", 1 + 1e-5)):
        raw.evaluate(base * scale)
        pri = np.asarray(raw.pri_res)
        t0 = time.perf_counter()
        z = gated.evaluate(base * scale)
        out[tag] = {"above_1e-4": int((pri > 1e-4).sum()),
                    "above_1e-3": int((pri > 1e-3).sum()),
                    "above_1e-2": int((pri > 1e-2).sum()),
                    "max": float(pri.max()),
                    "gated_rel_to_ef": float((z - ef) / abs(ef)),
                    "gated_s": time.perf_counter() - t0}
    return out


def lagrangian_census(device, S, cm, hub_iters, ef):
    import numpy as np

    from tpusppy_torch.opt.ph import PH
    from tpusppy_torch.phbase import PHBase

    kw = farmer_kwargs(S, cm)
    hub = PH(dict(options(device, "float32"), PHIterLimit=hub_iters,
                  convthresh=-1.0), **kw)
    hub.ph_main()
    out = {}
    for tag, dtype, cap in (("f32_cap64", "float32", 64),
                            ("f32_all", "float32", S),
                            ("f64_cap64", "float64", 64)):
        lg = PHBase(options(device, dtype, straggler_lp_max=cap), **kw)
        lg.W_on, lg.prox_on = True, False
        lg.W = np.asarray(hub.W, dtype=float).copy()
        q, q2 = lg._augmented_q()
        t0 = time.perf_counter()
        lg.solve_loop(q=q, q2=q2)
        bound = lg.Edualbound(q=q, q2=q2)
        out[tag] = {"bound_rel_to_ef": float((bound - ef) / abs(ef)),
                    "rescued": lg.rescued_scenarios,
                    "s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    donors = lg.dual_donor_bounds(q=q, q2=q2, k=24, budget_s=60,
                                  time_limit=20)
    bound = lg.probs @ np.maximum(lg.Edualbound_perscen(q=q, q2=q2), donors)
    out["f64_cap64_donors24"] = {
        "bound_rel_to_ef": float((bound - ef) / abs(ef)),
        "donor_bound_rel_to_ef": float((lg.probs @ donors - ef) / abs(ef)),
        "s": time.perf_counter() - t0}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scens", type=int, default=1000)
    ap.add_argument("--crops-multiplier", type=int, default=4)
    ap.add_argument("--hub-iters", type=int, default=30)
    args = ap.parse_args()
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("port_wheel_host.py: no CUDA device (pass "
                         "--device cpu to run on the host)")
    from tpusppy_torch.ef import solve_ef
    from tpusppy_torch.spbase import build_batch

    S, cm = args.scens, args.crops_multiplier
    kw = farmer_kwargs(S, cm)
    batch, _ = build_batch(kw["all_scenario_names"], kw["scenario_creator"],
                           kw["scenario_creator_kwargs"])
    ef, xs = solve_ef(batch, solver="highs")
    card = None
    if args.device == "cuda":
        import subprocess

        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    print(json.dumps({
        "device": args.device, "card": card, "ef": ef,
        "threads": thread_costs(),
        "evaluation": {dt: evaluation_census(args.device, S, cm, dt, ef, xs)
                       for dt in ("float32", "float64")},
        "lagrangian": lagrangian_census(args.device, S, cm, args.hub_iters,
                                        ef)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
