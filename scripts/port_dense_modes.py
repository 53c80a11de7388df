#!/usr/bin/env python3
"""``fused_sweeps`` in each of its modes at the shapes the port's paths give
it: held against its plain version, and timed.

    python3 scripts/port_dense_modes.py [--groups farmer,bucket,integer,wide]
        [--dtypes float32,float64] [--precisions highest,default]
        [--alternatives] [--quick]

For each shape (S, m, n), dtype and precision: the mode ``dense_layout``
picks on this card (and its cluster size C and buffers), the kernel's
largest difference from its plain version on the same inputs relative to
the plain version's largest entry (``chip_smoke.py``'s ``dense_case``; 4
sweeps, n_refine 2, alpha 1.6; tolerance 1e-5 in f32 and 1e-12 in f64 at
"highest", ``chip_smoke.LOW_TOL_F32`` / ``LOW_TOL_F64`` at "default"), the
kernel's and the plain version's device times (``chip_smoke.cuda_time_ms``)
and their ratio, the bound (the matrices and vectors read once and the
outputs written once over 3.35 TB/s, or the flops over the peak, whichever
is longer) and the re-stream floor (``cuda_kernels.dense_matrix_reads``
over 3.35 TB/s).  ``--alternatives`` also holds and times every other mode
that takes the shape (the resident mode with one buffer against a cluster
of 2, and so on) on the same inputs.  ``--quick`` checks without timing.

``--tree DIR`` runs the same cases on the ``fused_sweeps`` of another
checkout (an earlier commit unpacked by ``git archive`` into an ignored
directory), built there, through the API every version has (the
wrapper, its plain version, ``dense_modes``): the mode it ran, its error
and its time beside its plain version's.  A before/after runs the script
with ``--tree`` and without in one call on the same card.

Groups: ``farmer`` (S=1000, m=28, n=44: farmer-1000's main path), ``bucket``
(bundled farmer-1000's and bundled netdes-1000's buckets), ``integer``
(sizes S=3 and sslp 10 x 50 S=50), ``wide`` ((64, 84, 132), farmer at
crops_multiplier 12, (4, 60000, 44), whose work vectors do not fit
shared memory in f64, and (2, 10, 2500), whose rows are longer than a
stage in f64).

Prints the card, one line a case, then one JSON line; exits 1 if any case
disagrees with its plain version.  Imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GROUPS = {
    "farmer": ((1000, 28, 44),),
    "bucket": ((200, 84, 108), (100, 112, 140), (200, 105, 100),
               (100, 140, 125)),
    "integer": ((3, 62, 150), (50, 60, 520)),
    "wide": ((64, 84, 132), (4, 60000, 44), (2, 10, 2500)),
}
N_SWEEPS, N_REFINE, ALPHA = 4, 2, 1.6


def run_case(cs, ck, S, m, n, dtype, prec, alternatives, quick):
    """Every mode of one case: a dict a mode (the picked one first)."""
    import torch

    lowered = prec == "default"
    isz = torch.empty((), dtype=dtype).element_size()
    args, sigma = cs.dense_case(S, m, n, dtype)
    fixed = (N_SWEEPS, N_REFINE, sigma, ALPHA)
    op = ck.dense_operand(args[1], args[2], prec)
    picked = ck.dense_launch_layout(S, args[1], lowered)
    modes = [picked["mode"]]
    if alternatives:
        modes += [md for md in ("resident", "cluster", "streamed")
                  if md != picked["mode"]
                  and ck._dense_mode_layout(m, n, isz, lowered, md)]
    plain = lambda: ck.fused_sweeps_plain(*args, *fixed, precision=prec,
                                          operand=op)
    want = plain()
    if lowered:
        tol = cs.LOW_TOL_F32["default"] if isz == 4 else cs.LOW_TOL_F64
    else:
        tol = 1e-5 if isz == 4 else 1e-12
    reads = ([args[0], *op] + args[3:]) if lowered else args
    nbytes = sum(a.numel() * a.element_size() for a in reads) \
        + sum(w.numel() * w.element_size() for w in want)
    flops = 2 * S * N_SWEEPS * (2 * m * n + n * n * (1 + 2 * N_REFINE))
    bound = max(nbytes / cs.HBM_BYTES_PER_S,
                flops / cs.PEAK_FLOPS[str(dtype).replace("torch.", "")]) * 1e3
    plain_ms = None if quick else cs.cuda_time_ms(plain)
    out = {}
    for md in modes:
        lay = picked if md == picked["mode"] else \
            ck._dense_mode_layout(m, n, isz, lowered, md)
        kern = lambda lay=lay: ck._launch_dense(lay, *args, *fixed,
                                                precision=prec, operand=op)
        before = dict(ck.dense_modes)
        got = kern()
        torch.cuda.synchronize()
        ran = {k: ck.dense_modes[k] - before[k] for k in before}
        err = max(float((g - w).abs().max() / max(float(w.abs().max()),
                                                   1e-300))
                  for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        floor = ck.dense_matrix_reads(S, m, n, isz, lay, N_SWEEPS, N_REFINE,
                                      lowered) / cs.HBM_BYTES_PER_S * 1e3
        ms = None if quick else cs.cuda_time_ms(kern)
        ok = finite and err < tol and ran[md] == 1 and sum(ran.values()) == 1
        out[md] = dict(C=lay["C"], buffers=lay["buffers"],
                       hold=lay.get("hold"), vec_smem=lay.get("vec_smem"),
                       smem=lay["smem"], max_rel_err=err, tol=tol, ok=ok,
                       ms=ms, plain_ms=plain_ms, bound_ms=bound,
                       floor_ms=floor,
                       ratio=None if quick else ms / plain_ms)
        print(f"fused_sweeps S={S} m={m} n={n} {str(dtype)[6:]} {prec}: "
              f"{'picked' if md == modes[0] else 'forced'} {md} C="
              f"{lay['C']} buffers={lay['buffers']}"
              + (f" hold={lay['hold']} vec_smem={lay['vec_smem']}"
                 if md != "resident" else "")
              + f" smem={lay['smem']}: max_rel_err={err:.3e} (tol "
              f"{tol:.0e}){'' if ok else ' FAILED'}"
              + ("" if quick else f" kernel_ms={ms:.5f} "
                 f"plain_ms={plain_ms:.5f} kernel/plain={ms / plain_ms:.4f}")
              + f" bound_ms={bound:.5f} floor_ms={floor:.5f} {cs.CARD}",
              flush=True)
        del got
    del args, want, op
    torch.cuda.empty_cache()
    return out


def run_tree_case(cs, ck, S, m, n, dtype, prec, quick):
    """One case on another checkout's ``fused_sweeps``, in the mode it
    picks there: a dict of that mode."""
    import torch

    isz = torch.empty((), dtype=dtype).element_size()
    args, sigma = cs.dense_case(S, m, n, dtype)
    fixed = (N_SWEEPS, N_REFINE, sigma, ALPHA)
    op = ck.dense_operand(args[1], args[2], prec) \
        if prec == "default" else None
    plain = lambda: ck.fused_sweeps_plain(*args, *fixed, precision=prec,
                                          operand=op)
    kern = lambda: ck.fused_sweeps(*args, *fixed, precision=prec,
                                   operand=op)
    want = plain()
    before = dict(ck.dense_modes)
    got = kern()
    torch.cuda.synchronize()
    ran = [k for k in ck.dense_modes if ck.dense_modes[k] > before[k]]
    if prec == "default":
        tol = cs.LOW_TOL_F32["default"] if isz == 4 else cs.LOW_TOL_F64
    else:
        tol = 1e-5 if isz == 4 else 1e-12
    err = max(float((g - w).abs().max() / max(float(w.abs().max()), 1e-300))
              for g, w in zip(got, want))
    ok = all(bool(torch.isfinite(g).all()) for g in got) and err < tol \
        and len(ran) == 1
    ms = None if quick else cs.cuda_time_ms(kern)
    plain_ms = None if quick else cs.cuda_time_ms(plain)
    md = ran[0] if ran else "none"
    print(f"fused_sweeps (tree) S={S} m={m} n={n} {str(dtype)[6:]} {prec}: "
          f"ran {md}: max_rel_err={err:.3e} (tol {tol:.0e})"
          + ("" if ok else " FAILED")
          + ("" if quick else f" kernel_ms={ms:.5f} plain_ms={plain_ms:.5f}"
             f" kernel/plain={ms / plain_ms:.4f}") + f" {cs.CARD}",
          flush=True)
    del args, want, got, op
    torch.cuda.empty_cache()
    return {md: dict(max_rel_err=err, tol=tol, ok=ok, ms=ms,
                     plain_ms=plain_ms,
                     ratio=None if quick else ms / plain_ms)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", default="farmer,bucket,integer,wide")
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--precisions", default="highest,default")
    ap.add_argument("--alternatives", action="store_true")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--tree", default=None,
                    help="another checkout whose fused_sweeps to run")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree) if args.tree else None
    sys.path.insert(0, tree or ROOT)

    import importlib.util

    import torch

    # the cases' inputs and timing from this checkout's chip_smoke.py
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from tpusppy_torch.solvers import cuda_kernels as ck

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD = "(" + subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip() + ")"
    print(f"card: {cs.CARD}" + (f"; fused_sweeps of {tree}" if tree else ""),
          flush=True)
    ck.build("fused_sweeps")
    print(ck.build_log.get("fused_sweeps", ""), flush=True)
    results, bad = {}, 0
    for group in args.groups.split(","):
        for S, m, n in GROUPS[group]:
            for dt in args.dtypes.split(","):
                for prec in args.precisions.split(","):
                    if tree:
                        res = run_tree_case(cs, ck, S, m, n,
                                            getattr(torch, dt), prec,
                                            args.quick)
                    else:
                        res = run_case(cs, ck, S, m, n, getattr(torch, dt),
                                       prec, args.alternatives, args.quick)
                    bad += sum(not r["ok"] for r in res.values())
                    results[f"{S},{m},{n},{dt},{prec}"] = res
    print(json.dumps({"card": cs.CARD, "tree": tree, "results": results,
                      "failed": bad}),
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
