#!/usr/bin/env python3
"""Where ``fused_sweeps_shared`` and ``fused_sweeps`` spend their time.

    python3 scripts/port_shared_ablation.py [--scens 1000] [--reps 15]
        [--crossover 16,64,128,176,256,528,1000,2000]

Builds variants of ``tpusppy_torch/csrc/fused_sweeps_shared.cu`` and
``fused_sweeps.cu`` with one part of the work taken out (the result is then
wrong, only its time counts), all with nvcc in parallel into
``tpusppy_torch/_build/ablation/``, and times each on the card through its
wrapper: ``fused_sweeps_shared`` at uc_lite-1000's shape
(``chip_smoke.py``'s check: S=1000, m=242, n=132, 4 sweeps, n_refine=2,
n_extra=2, has=1) in each of its two modes, and ``fused_sweeps`` at
farmer-1000's (S=1000, m=28, n=44, 4 sweeps, n_refine=2), in f32 and f64.
A part's cost is the full kernel's time less the variant's.  Then the
full ``fused_sweeps_shared`` in both modes at uc_lite's shape (and at
m=50, n=22, whose matrices fit one CTA) for each S of ``--crossover``:
where the wrapper's choice of mode
(``cuda_kernels.shared_mode``) is held against the card.

The variants are edits of the source, and an edit that no longer matches
it fails the script.  Streamed ``fused_sweeps_shared`` (a block a tile):
``no_atv``, ``no_kinv``, ``no_k``, ``no_axt``, ``no_x_update``,
``no_barriers``, ``no_splitk_sums``.  Cluster-resident: ``no_atv``,
``no_kinv``, ``no_k``, ``no_axt`` (a product and its epilogue),
``no_reduce`` (A xt's reduce-scatter), ``no_x_update``, ``no_exchange``
(the hand-off to the other CTAs), ``cta_barriers`` (cluster barriers made
block barriers), ``warps_10``, ``no_kloops`` (every product's k loop),
``no_split_sums`` (the warps' partial sums).  ``fused_sweeps``:
``no_load`` (the bulk copies), ``no_sweeps``, ``no_epilogues``,
``no_barriers``, ``two_buffers`` (double-buffered blocks at any shape).

Prints the card and one line a variant, then one JSON line.  Imports
nothing of JAX.
"""

import argparse
import ctypes
import itertools
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---- the streamed shared kernel: a 512-thread block a tile of 8 scenarios,
# split-k contractions --------------------------------------------------------
_STREAMED = {
    "no_atv": [("    for (int i0 = 0; i0 < m; i0 += chunk) {",
                "    for (int i0 = 0; i0 < 0; i0 += chunk) {")],
    "no_kinv": [("  auto apply_kinv = [&](const T* in, auto epi) {\n",
                 "  auto apply_kinv = [&](const T* in, auto epi) {\n"
                 "    if (n > 0) return;\n")],
    "no_k": [("  auto apply_k = [&](const T* in, auto epi) {\n",
              "  auto apply_k = [&](const T* in, auto epi) {\n"
              "    if (n > 0) return;\n")],
    "no_axt": [("    contract<T, SB, false>(sxt, At, n, m, part,",
                "    if (m < 0) contract<T, SB, false>(sxt, At, n, m, part,")],
    "no_x_update": [("    for (int e = tid; e < ns * n; e += nt) {\n"
                     "      const int s = e / n, j = e - s * n;\n"
                     "      const long long r = on + e;",
                     "    for (int e = tid; e < 0; e += nt) {\n"
                     "      const int s = e / n, j = e - s * n;\n"
                     "      const long long r = on + e;")],
    "no_barriers": [("__syncthreads();", "")],
    "no_splitk_sums": [("    for (int h = 1; h < G; ++h) {",
                        "    for (int h = 1; h < 1; ++h) {")],
}
# ---- the cluster-resident shared kernel -------------------------------------
_RESIDENT = {
    "no_atv": [("      // rhs: A'v for this CTA's columns\n      product_cols<SB>(",
                "      // rhs: A'v for this CTA's columns\n"
                "      if (n > 0) {} else product_cols<SB>(")],
    "no_kinv": [("  auto apply_kinv = [&](bool first, bool last) {\n",
                 "  auto apply_kinv = [&](bool first, bool last) {\n"
                 "    if (n > 0) return;\n")],
    "no_k": [("  auto apply_k = [&]() {\n",
              "  auto apply_k = [&]() {\n    if (n > 0) return;\n")],
    "no_axt": [("      // A xt over this CTA's columns, for every row\n"
                "      product_rows<SB>(",
                "      // A xt over this CTA's columns, for every row\n"
                "      if (m < 0) product_rows<SB>(")],
    "no_reduce": [("        for (int r = 0; r < C; ++r) a += "
                   "*cluster.map_shared_rank(spart + e, r);",
                   "        a = spart[e];")],
    "no_x_update": [("      if (last) x_update(j, s, xt);",
                     "      if (last && n < 0) x_update(j, s, xt);")],
    "no_exchange": [("    for (int e = tid; e < nvec * (C - 1); e += nt) {",
                     "    for (int e = tid; e < 0; e += nt) {"),
                    ("      for (int r = 0; r < C; ++r) {\n"
                     "        *reinterpret_cast<V16*>",
                     "      for (int r = rank; r <= rank; ++r) {\n"
                     "        *reinterpret_cast<V16*>")],
    "cta_barriers": [("      cluster_sync();", "      __syncthreads();")],
    "warps_10": [("constexpr int kResThreads = 256;",
                  "constexpr int kResThreads = 320;")],
    "no_kloops": [("    for (int kb = k0; kb < k1; kb += kSumBlock) {",
                   "    for (int kb = k1; kb < k1; kb += kSumBlock) {"),
                  ("      tile(t, 0, nks, d);", "      tile(t, 0, 0, d);"),
                  ("    tile(t, nks * gi / G, nks * (gi + 1) / G, d);",
                   "    tile(t, 0, 0, d);")],
    "no_split_sums": [("        p[w] = *reinterpret_cast<const float4*>(\n"
                       "            part + ((w * CPL) * 32 + q) * SB + s0);",
                       "        p[w] = make_float4(0.f, 0.f, 0.f, 0.f);"),
                      ("    for (int g = 0; g < G; ++g) {\n"
                       "      const double2 p",
                       "    for (int g = 0; g < 0; ++g) {\n"
                       "      const double2 p")],
}
# ---- the dense kernel ------------------------------------------------------
_DENSE = {
    "no_load": [("    for (int a = 0; a < kArrays; ++a) {\n"
                 "      if (a < 2) {",
                 "    for (int a = 0; a < 0; ++a) {\n"
                 "      if (a < 2) {")],
    "no_sweeps": [("    for (int sweep = 0; sweep < n_sweeps; ++sweep) {\n"
                   "      // rhs = sigma",
                   "    for (int sweep = 0; sweep < 0; ++sweep) {\n"
                   "      // rhs = sigma")],
    "no_epilogues": [("    epi(o, s0 + s1);",
                      "    if (s0 == T(-1.5e-30)) epi(o, s0 + s1);"),
                     ("    epi(j, s0 + s1);",
                      "    if (s0 == T(-1.5e-30)) epi(j, s0 + s1);")],
    "no_barriers": [("      __syncthreads();\n", "\n")],
    "two_buffers": [("    if (2 * nb2 > nb) {", "    if (true) {"),
                    ("  if (S > static_cast<long long>(nsm) * nb && "
                     "L.total <= kSmemLimit) {", "  if (true) {")],
}

#: (m, n) of the crossover table: uc_lite's defaults (a cluster of 2 CTAs
#: in f32 and 5 in f64), and a shape whose matrices fit one CTA (C=1).
CROSSOVER_SHAPES = ((242, 132), (50, 22))

#: Where the resident mode's code begins in fused_sweeps_shared.cu: the
#: streamed variants edit the source above it, the resident ones below.
_RESIDENT_SECTION = "// ---- the cluster-resident mode ----"

#: The variants of each kernel, by the mode they are timed in.
VARIANTS = {
    "fused_sweeps_shared": {"streamed": _STREAMED, "resident": _RESIDENT},
    "fused_sweeps": {"resident": _DENSE},
}


def _suffix(name, mode):
    """The build of a shared variant is named by the mode it is timed in."""
    return "-" + mode[0] if len(VARIANTS[name]) > 1 else ""


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scens", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--crossover", default="16,64,128,176,256,528,1000,2000",
                    help="scenario counts at which both modes of "
                         "fused_sweeps_shared are timed")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)

    import torch

    import chip_smoke as cs
    from tpusppy_torch.solvers import cuda_kernels as ck

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", flush=True)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    out_dir = ck.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, by_mode in VARIANTS.items():
        src = (ck.CSRC / f"{name}.cu").read_text()
        # a mode's edits touch only its section of the source
        cut = src.index(_RESIDENT_SECTION) if len(by_mode) > 1 else 0
        edits_of = {"full": ("", [])}
        for mode, table in by_mode.items():
            for var, edits in table.items():
                edits_of[var + _suffix(name, mode)] = (mode, edits)
        for var, (mode, edits) in edits_of.items():
            lo, hi = (0, cut) if mode == "streamed" else (cut, len(src))
            text = src[lo:hi]
            for old, new in edits:
                if old not in text:
                    raise SystemExit(f"{name} variant {var}: edit no longer "
                                     f"matches the source: {old!r}")
                text = text.replace(old, new)
            cu = out_dir / f"{name}-{var}.cu"
            cu.write_text(src[:lo] + text + src[hi:])
            jobs[(name, var)] = subprocess.Popen(
                [ck._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                 "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
                 str(out_dir / f"{name}-{var}.so"), str(cu)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for (name, var), proc in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name} variant {var}:\n{err}")

    def bind(name, var):
        lib = ctypes.CDLL(str(out_dir / f"{name}-{var}.so"))
        for fns, argtypes in ck._ENTRY_POINTS[name]:
            for fn in fns:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        ck._libs[name] = lib

    times, crossover = {}, {}
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace("torch.", "")
        sargs, sigma = cs.shared_sweep_case(args.scens, 242, 132, dtype, 1)
        dargs, dsigma = cs.sweep_case(args.scens, 28, 44, dtype)
        for name, by_mode in VARIANTS.items():
            for mode, table in by_mode.items():
                if name == "fused_sweeps_shared":
                    def fn(mode=mode):
                        return ck.fused_sweeps_shared(
                            *sargs, 4, 2, 2, sigma, 1.6, mode=mode)
                else:
                    def fn():
                        return ck.fused_sweeps(*dargs, 4, 2, dsigma, 1.6)
                for var in ["full"] + [v + _suffix(name, mode)
                                       for v in table]:
                    bind(name, var)
                    ms = cs.cuda_time_ms(fn, reps=args.reps, warmup=3)
                    key = f"{name} {mode} {var} {dt}"
                    times[key] = ms
                    full = times[f"{name} {mode} full {dt}"]
                    print(f"{key}: {ms:.5f} ms (full less this: "
                          f"{full - ms:.5f} ms)", flush=True)
                ck._libs.pop(name, None)
        del sargs, dargs
        # both modes of the full shared kernel, and the wrapper's choice
        scens = [int(v) for v in args.crossover.split(",")]
        for (m, n), S in itertools.product(CROSSOVER_SHAPES, scens):
            cargs, csigma = cs.shared_sweep_case(S, m, n, dtype, 1)
            row = {}
            for mode in ("resident", "streamed"):
                row[mode] = cs.cuda_time_ms(
                    lambda mode=mode: ck.fused_sweeps_shared(
                        *cargs, 4, 2, 2, csigma, 1.6, mode=mode),
                    reps=args.reps, warmup=3)
            before = dict(ck.shared_modes)
            ck.fused_sweeps_shared(*cargs, 4, 2, 2, csigma, 1.6)
            row["picked"] = next(k for k in ck.shared_modes
                                 if ck.shared_modes[k] > before[k])
            crossover[f"{m}x{n} {S} {dt}"] = row
            print(f"crossover m={m} n={n} S={S} {dt}: resident "
                  f"{row['resident']:.5f} "
                  f"ms, streamed {row['streamed']:.5f} ms, picked "
                  f"{row['picked']}", flush=True)
            del cargs
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "scens": args.scens, "ms": times,
                      "crossover": crossover}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
