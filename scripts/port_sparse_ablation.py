#!/usr/bin/env python3
"""Where the structured mode of ``fused_sweeps_sparse`` spends its time.

    python3 scripts/port_sparse_ablation.py [--scens 1000] [--reps 9]

Builds variants of ``tpusppy_torch/csrc/fused_sweeps_sparse.cu`` with one
part of the work taken out (the result is then wrong, only its time
counts), all with nvcc in parallel into ``tpusppy_torch/_build/ablation/``,
and times each on the card at uc-1000's shape (``chip_smoke.py``'s
structured kernel check: S=1000, m=4626, n=2928, 4 sweeps, n_refine=1,
n_extra=2, has=1), f32, and f64 for the apply's parts.  A part's cost is
the full kernel's time less the variant's.  Variants:

- ``no_apply``: every K^-1 apply skipped (and its panel pipeline);
- ``no_products``: the block and C^-1 products skipped;
- ``no_waits``: the panel copies and their waits skipped;
- ``no_passes``: the w' pass and the final scatter of the apply skipped;
- ``no_apply_no_<loop>``: with the applies gone, one loop of the sweep
  skipped too: ``rhs`` (A'v and the rhs), ``defect_rows`` (A xt in each
  refinement pass), ``defect_cols`` (A'(rho_a A xt) and w in each pass),
  ``x_update``, ``final_rows`` (A xt with the z, y, Ax updates).

Prints the card and one line a variant, then one JSON line.  A variant's
edit that no longer matches the source fails the script.  Imports nothing
of JAX.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_WAIT = ("      mbar_wait(pp.full + (pp.it & 1), "
         "static_cast<uint32_t>((pp.it >> 1) & 1));\n")
_REQUEST = ("      if (tid == 0 && pp.it + 1 < pp.total) "
            "pipe_issue(wb, pp, pp.it + 1);\n")
_FIRST = "    if (tid == 0 && pp.total > 0) pipe_issue(wb, pp, 0);\n"
_APPLY = ("  const int tid = threadIdx.x;\n  const int nt = blockDim.x;\n"
          "  using V = Tile<T, SB>;\n  // t = B^-1 w: the one-variable")

NO_WAITS = [(_WAIT, ""), (_REQUEST, ""), (_FIRST, "")]
NO_APPLY = NO_WAITS + [(_APPLY, "  if (n > 0) return;\n" + _APPLY)]
NO_PRODUCTS = [
    ("        for (int k = rows * gi / G; k < k1; ++k) {",
     "        for (int k = k1; k < k1; ++k) {"),
    ("        for (int ks = nks * gi / G; ks < ks1; ++ks) {",
     "        for (int ks = ks1; ks < ks1; ++ks) {")]
NO_PASSES = [
    ("  for (int p = tid; p < n; p += nt) {\n    V wq",
     "  for (int p = tid; p < 0; p += nt) {\n    V wq"),
    ("  for (int e = tid; e < n * SB; e += nt) {\n    const int p = e / SB",
     "  for (int e = tid; e < 0; e += nt) {\n    const int p = e / SB")]
LOOPS = {
    "rhs": ("    for (int j = tid; j < n; j += nt) {\n      const V atv",
            "    for (int j = tid; j < 0; j += nt) {\n      const V atv"),
    "defect_rows": ("      // t = rho_a (A xt), into the m-vector scratch\n"
                    "      rows_of_A",
                    "      // t = rho_a (A xt), into the m-vector scratch\n"
                    "      if (m < 0) rows_of_A"),
    "defect_cols": ("      for (int j = tid; j < n; j += nt) {\n"
                    "        const V att",
                    "      for (int j = tid; j < 0; j += nt) {\n"
                    "        const V att"),
    "x_update": ("    for (int e0 = tid; e0 < ns * n; e0 += kBatch * nt) {",
                 "    for (int e0 = tid; e0 < 0; e0 += kBatch * nt) {"),
    "final_rows": ("    };\n    rows_of_A", "    };\n    if (m < 0) rows_of_A"),
}


def variants():
    out = {"full": [], "no_apply": NO_APPLY, "no_products": NO_PRODUCTS,
           "no_waits": NO_WAITS, "no_passes": NO_PASSES}
    for name, edit in LOOPS.items():
        out[f"no_apply_no_{name}"] = NO_APPLY + [edit]
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scens", type=int, default=1000)
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from tpusppy_torch.solvers import cuda_kernels as ck

    if not torch.cuda.is_available():
        print("FAIL: needs a CUDA device", flush=True)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    src = (ck.CSRC / "fused_sweeps_sparse.cu").read_text()
    out_dir = ck.BUILD_DIR / "ablation"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, edits in variants().items():
        text = src
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"variant {name}: edit no longer matches "
                                 f"the source: {old!r}")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        jobs[name] = subprocess.Popen(
            [ck._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on variant {name}:\n{err}")

    def bind(name):
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fns, argtypes in ck._ENTRY_POINTS["fused_sweeps_sparse"]:
            for fn in fns:
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        ck._libs["fused_sweeps_sparse"] = lib

    pattern = cs.uc_sparse_pattern()
    times = {}
    for dtype in (torch.float32, torch.float64):
        dt = str(dtype).replace("torch.", "")
        kargs, _, sigma = cs.sparse_sweep_case(pattern, args.scens, dtype,
                                               1, structured=True)
        ell_t = ck.ell_slot_major(kargs[1:5])
        for name in variants():
            if dtype == torch.float64 and name.startswith("no_apply_no_"):
                continue
            bind(name)
            ms = cs.cuda_time_ms(
                lambda: ck.fused_sweeps_sparse(*kargs, 4, 1, 2, sigma, 1.6,
                                               ell_t=ell_t),
                reps=args.reps, warmup=2)
            times[f"{name} {dt}"] = ms
            full = times[f"full {dt}"]
            print(f"{name} {dt}: {ms:.5f} ms (full less this: "
                  f"{full - ms:.5f} ms)", flush=True)
        del kargs
        torch.cuda.empty_cache()
    ck._libs.pop("fused_sweeps_sparse", None)
    print(json.dumps({"card": card, "scens": args.scens, "ms": times}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
