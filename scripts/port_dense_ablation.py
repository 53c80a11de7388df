#!/usr/bin/env python3
"""Where ``fused_sweeps``' cluster and streamed modes spend their time.

    python3 scripts/port_dense_ablation.py [--reps 15]
        [--shapes 3x62x150,200x84x108,50x60x520] [--dtypes float64]
        [--clusters]

Builds variants of ``tpusppy_torch/csrc/fused_sweeps.cu`` with one part of
the cluster kernel's work taken out (the result is then wrong, only its
time counts), all with nvcc in parallel into
``tpusppy_torch/_build/dense_ablation/``, and times each through the
wrapper at each shape (``chip_smoke.py``'s ``sweep_case``: 4 sweeps,
n_refine 2) in the mode ``dense_layout`` picks there (a cluster of 16 at
sizes' S=3, a cluster of 2 at bundled farmer's (200, 84, 108) in f64, the
streamed mode at sslp's (50, 60, 520) in f64).  A part's cost is the full
kernel's time less the variant's.

Variants: ``no_load`` (the held rows' bulk copies), ``no_products`` (every
row product), ``no_kinv_held`` (the K^-1 products over the held rows),
``no_colsum`` (A'v's partial sums over the held
rows), ``no_rhs`` (the cluster reduction of A'v and the rhs), ``local``
(every write to a peer's copy and every read of a peer's partial sums
made local), ``local_cta_barriers`` (``local``, and the cluster barriers
made block barriers), ``no_stream`` (the streamed panels' arithmetic;
the copies still run).

``--clusters`` then times the full kernel at each shape forced to each
cluster size its cluster mode (or, where no cluster holds a scenario,
its streamed mode) takes, C = 2, 4, 8, 16, beside the clusters the card
places at once at that C and shared memory
(``cudaOccupancyMaxActiveClusters``): the cost of C against the
scenarios in flight.

The variants are edits of the source, and an edit that no longer matches
it fails the script.  Prints the card and one line a variant and shape,
then one JSON line.  Imports nothing of JAX.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

VARIANTS = {
    "no_load": [("    if (s >= S || !any_held) return;",
                 "    if (s >= 0) return;"),
                ("    if (any_held) {\n      mbar_wait(bars + b,",
                 "    if (S < 0) {\n      mbar_wait(bars + b,")],
    "no_products": [("  for (int r0 = 0; r0 < nr; r0 += 4 * per) {",
                     "  for (int r0 = 0; r0 < 0; r0 += 4 * per) {"),
                    ("      for (int r0 = 0; r0 < nr; r0 += 2 * per) {",
                     "      for (int r0 = 0; r0 < 0; r0 += 2 * per) {")],
    "no_kinv_held": [("row_product(NKi, Kih, hKic, w,",
                      "row_product(NKi, Kih, 0, w,")],
    "no_colsum": [("      for (int j = tid; j < n; j += nt) {\n"
                   "        T s0 = T(0), s1 = T(0);",
                   "      for (int j = tid; j < 0; j += nt) {\n"
                   "        T s0 = T(0), s1 = T(0);")],
    "no_rhs": [("      for (int e0 = 0; e0 < rk * C; e0 += nt) {",
                "      for (int e0 = 0; e0 < 0; e0 += nt) {")],
    "local": [("      for (int r = l; r < C; r += g) cluster.map_shared_rank("
               "buf, r)[j] = val;",
               "      if (l == 0) buf[j] = val;"),
              ("    return vs ? cluster.map_shared_rank(part, r)",
               "    return vs ? part")],
    "no_stream": [("      if (d.nc == n) {\n"
                   "        group_rows<T>(pan,",
                   "      if (d.nc == -1) {\n"
                   "        group_rows<T>(pan,"),
                  ("        for (int j = tid; j < d.nc; j += nt) {\n"
                   "          T acc = T(0);",
                   "        for (int j = tid; j < 0; j += nt) {\n"
                   "          T acc = T(0);")],
}
VARIANTS["local_cta_barriers"] = VARIANTS["local"] + [
    ("__device__ __forceinline__ void cluster_sync() {\n  __syncwarp();\n",
     "__device__ __forceinline__ void cluster_sync() {\n  __syncthreads();\n"
     "  if (blockDim.x > 0) return;\n")]
#: Where the cluster kernel begins: the edits touch only the source after it.
_CLUSTER_SECTION = "struct ClusterLayout {"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--shapes", default="3x62x150,200x84x108,50x60x520")
    ap.add_argument("--dtypes", default="float64")
    ap.add_argument("--clusters", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    import chip_smoke as cs
    from tpusppy_torch.solvers import cuda_kernels as ck

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", flush=True)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    out_dir = ck.BUILD_DIR / "dense_ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (ck.CSRC / "fused_sweeps.cu").read_text()
    cut = src.index(_CLUSTER_SECTION)
    jobs = {}
    for var, edits in [("full", [])] + list(VARIANTS.items()):
        text = src[cut:]
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {var}: edit no longer matches the "
                                 f"source: {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"fused_sweeps-{var}.cu"
        cu.write_text(src[:cut] + text)
        jobs[var] = subprocess.Popen(
            [ck._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "--split-compile=0", "-shared",
             "-Xcompiler", "-fPIC", "-o", str(out_dir / f"fused_sweeps-{var}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    for var, proc in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {var}:\n{err}")

    def bind(var):
        lib = ctypes.CDLL(str(out_dir / f"fused_sweeps-{var}.so"))
        for fns, argtypes in ck._ENTRY_POINTS["fused_sweeps"]:
            for fn in fns:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        ck._libs["fused_sweeps"] = lib

    times = {}
    for shape in args.shapes.split(","):
        S, m, n = (int(v) for v in shape.split("x"))
        for dt in args.dtypes.split(","):
            dtype = getattr(torch, dt)
            dargs, sigma = cs.sweep_case(S, m, n, dtype)
            bind("full")
            lay = ck.dense_launch_layout(S, dargs[1])

            def fn():
                return ck.fused_sweeps(*dargs, 4, 2, sigma, 1.6)

            for var in ["full"] + list(VARIANTS):
                bind(var)
                ms = cs.cuda_time_ms(fn, reps=args.reps, warmup=3)
                key = f"{shape} {dt} {lay['mode']} C={lay['C']} {var}"
                times[key] = ms
                full = times[f"{shape} {dt} {lay['mode']} C={lay['C']} full"]
                print(f"{key}: {ms:.5f} ms (full less this: "
                      f"{full - ms:.5f} ms) ({card})", flush=True)
            if args.clusters:
                bind("full")
                isz = dargs[1].element_size()
                for C in ck.DENSE_CLUSTERS:
                    for mode in ("cluster", "streamed"):
                        clay = ck._dense_mode_layout(m, n, isz, False, mode,
                                                     C)
                        if clay is not None:
                            break
                    active = ck._dense_clusters(dargs[1].device, dtype,
                                                False, C, clay["smem"])
                    ms = cs.cuda_time_ms(
                        lambda: ck._launch_dense(clay, *dargs, 4, 2, sigma,
                                                 1.6),
                        reps=args.reps, warmup=3)
                    times[f"{shape} {dt} {mode} C={C}"] = ms
                    print(f"{shape} {dt} {mode} C={C}: {ms:.5f} ms, "
                          f"{active} clusters at once at {clay['smem']} B "
                          f"a CTA, {-(-S // active)} rounds of scenarios "
                          f"({card})", flush=True)
            del dargs
            ck._libs.pop("fused_sweeps", None)
            torch.cuda.empty_cache()
    print(json.dumps({"card": card, "ms": times}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
