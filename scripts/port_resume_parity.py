#!/usr/bin/env python3
"""How far a killed and resumed PH run lands from the same run uninterrupted,
by the solver tolerance and the acceptance ladder of PH's QP subproblems.

    python3 scripts/port_resume_parity.py [--configs 1e-8:default:16,...]

On one CUDA device, for each solver eps, ``straggler_tol_qp`` and
``solver_refresh_every`` in ``--configs`` (``EPS:TOL:REFRESH``; "default"
is the solver's ladder, 1e-2; refresh 1 makes every PH iterate an
adaptive solve, no frozen iterate and no window),
``chip_smoke.kill_and_resume``: the hub-only farmer-1000
(crops_multiplier=4) wheel in f64 at that eps, checkpointing every
iteration in a child
process that is SIGKILLed at its first checkpoint at iteration 15 or
later, resumed from the newest checkpoint to 45 iterations in all,
against the same wheel run 45 iterations uninterrupted.  Prints each
pair's largest W and xbars differences (and their excess over rtol 1e-5,
atol 1e-4, the reference test's tolerances), eobj of both runs, the hub's
PH it/s with checkpointing on and off, then one JSON line.  A window
accepts a frozen iterate that is eps-converged or has every residual
within the ladder; the resumed run starts from cold factors and Iter0's
warm state (a checkpoint holds neither), so its iterates carry other
solver errors than the uninterrupted run's, and PH carries them on.
Imports nothing of JAX.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs",
                    default="1e-8:default:16,1e-10:default:16,"
                            "1e-10:1e-9:16,1e-8:default:1,1e-10:default:1")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 2
    import chip_smoke
    from tpusppy_torch.solvers import cuda_kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    chip_smoke.CARD = f"[{smi}]"
    print(smi, flush=True)
    cuda_kernels.build()
    out = {}
    for name in args.configs.split(","):
        eps, tol, refresh = name.split(":")
        tol = None if tol == "default" else float(tol)
        workdir = tempfile.mkdtemp(prefix="resume_parity_")
        try:
            r = chip_smoke.kill_and_resume(cuda_kernels, workdir, float(eps),
                                           tol, int(refresh), hold=False)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        out[name] = {"resumed_from": r["ck_it"],
                     "W_max_diff": r["W"][1], "W_excess": r["W"][0],
                     "xbars_max_diff": r["xbars"][1],
                     "xbars_excess": r["xbars"][0],
                     "eobj_resumed": r["eobj"][0],
                     "eobj_uninterrupted": r["eobj"][1],
                     "ph_it_s_checkpointing": r["rate_on"],
                     "ph_it_s_off": r["rate_off"]}
    print(json.dumps({"card": smi, "parity": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
