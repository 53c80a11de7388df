#!/usr/bin/env python3
"""How far rounding alone parts two uc-1000 PH runs of the PyTorch/CUDA port.

    python3 scripts/port_uc_parity.py [--scens 1000] [--iters 10]

Runs uc at full width (30 generators x 24 hours, LP relaxation) PH on one
CUDA device with ``chip_smoke.py``'s uc-1000 settings (rho 500 and
bench_uc.py's solver settings, eps 1e-5), ``--iters`` iterations a run:

1. f32 through ``fused_sweeps_sparse``, capturing the inputs of the first
   sweep block of iteration ``--iters // 2``.  On those inputs (the real
   block/Woodbury operator, ELL arrays and ADMM state) the kernel and the
   plain version in f32 are each held against the plain version in f64 on
   the same f32 values;
2. the same run with every stored entry of the operator the kernel applies
   (the block inverses and C^-1) moved one ulp, up or down at random
   (seeded): a change far below the f32 K^-1's own error, which shows how
   far the PH recurrence carries a rounding;
3. f64 through the kernel and on the tensor path: the kernel and the plain
   version in the same recurrence, with f64 rounding.

Prints both runs of each pair side by side (eobj and the solve loop's
decisions after Iter0 and every iteration, ``chip_smoke.print_parting``),
then one JSON line.  Imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scens", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from tpusppy_torch.solvers import cuda_kernels, shared_admm
    from tpusppy_torch.solvers.structured_kkt import KernelWoodbury

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    cuda_kernels.build("fused_sweeps_sparse")
    S, iters = args.scens, args.iters
    kern = "fused_sweeps_sparse"

    # 1. f32 through the kernel, capturing one block's inputs
    launch = cuda_kernels.fused_sweeps_sparse
    cap = {"armed": False}

    def capture(*a, **kw):
        if cap["armed"]:
            cap["armed"] = False
            cap["args"] = [v.clone() if torch.is_tensor(v) else v for v in a]
            cap["ell_t"] = kw.get("ell_t")
        return launch(*a, **kw)

    def make(o, ext):
        class Arm(ext):
            def miditer(self):
                super().miditer()
                if self.opt._iter == iters // 2:
                    cap["armed"] = True
        return cs.uc_full_ph(S, o, extensions=Arm)

    cuda_kernels.fused_sweeps_sparse = capture
    try:
        _, base = cs.run_path(cuda_kernels, kern, make, "auto", iters,
                              cs.UC_MAIN_OPTIONS, cs.UC_SOLVER)
    finally:
        cuda_kernels.fused_sweeps_sparse = launch
    a32 = cap["args"]
    a64 = [v.astype(torch.float64) if isinstance(v, KernelWoodbury)
           else v.double() if torch.is_tensor(v) and v.is_floating_point()
           else v for v in a32]
    got = launch(*a32, ell_t=cap["ell_t"])
    p32 = cuda_kernels.fused_sweeps_sparse_plain(*a32)
    p64 = cuda_kernels.fused_sweeps_sparse_plain(*a64)
    block = {"kernel_vs_plain": cs.max_err(got, p32),
             "kernel_vs_f64": cs.max_err(got, p64),
             "plain_vs_f64": cs.max_err(p32, p64),
             "gamma_range": [float(a32[15].min()), float(a32[15].max())],
             "has": float(a32[14])}
    print(f"iteration {iters // 2}'s first block, f32: kernel vs plain "
          f"{block['kernel_vs_plain']:.3e}, kernel vs f64 plain "
          f"{block['kernel_vs_f64']:.3e}, plain vs f64 plain "
          f"{block['plain_vs_f64']:.3e}", flush=True)
    del a32, a64, got, p32, p64, cap["args"]

    # 2. f32 through the kernel with the operator moved one ulp an entry
    layout = shared_admm.woodbury_layout
    gen = torch.Generator(device="cuda").manual_seed(0)

    def ulp(v):
        up = torch.rand(v.shape, generator=gen, device=v.device) < 0.5
        inf = torch.full((), torch.inf, dtype=v.dtype, device=v.device)
        return torch.nextafter(v, torch.where(up, inf, -inf))

    def nudged(bw, A):
        lay = layout(bw, A)
        return lay._replace(mats=ulp(lay.mats), dinv=ulp(lay.dinv))

    shared_admm.woodbury_layout = nudged
    try:
        _, ulp_run = cs.run_path(cuda_kernels, kern,
                                 lambda o, ext: cs.uc_full_ph(
                                     S, o, extensions=ext),
                                 "auto", iters, cs.UC_MAIN_OPTIONS,
                                 cs.UC_SOLVER)
    finally:
        shared_admm.woodbury_layout = layout
    rel_ulp = cs.print_parting("f32 kernel vs f32 kernel, K^-1 one ulp off",
                               base, ulp_run, iters)

    # 3. f64 through the kernel and on the tensor path
    runs = {}
    for use_kernel in ("auto", False):
        _, runs[use_kernel] = cs.run_path(
            cuda_kernels, kern,
            lambda o, ext: cs.uc_full_ph(S, o, extensions=ext), use_kernel,
            iters, cs.UC_MAIN_OPTIONS, cs.UC_SOLVER, dtype="float64")
    rel_64 = cs.print_parting("f64 kernel vs f64 tensor path", runs["auto"],
                              runs[False], iters)
    print(json.dumps({
        "card": card, "scens": S, "iters": iters, "block": block,
        "f32_ulp_rel": rel_ulp, "f64_rel": rel_64,
        "wall_s": {"f32_kernel": base["wall_s"], "f32_ulp": ulp_run["wall_s"],
                   "f64_kernel": runs["auto"]["wall_s"],
                   "f64_tensor": runs[False]["wall_s"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
