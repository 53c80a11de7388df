"""Time ``nvcc`` on each of the port's kernel sources, with the build's
flags and with ``--split-compile=0`` added, every source of a group
compiled at once as :func:`tpusppy_torch.solvers.cuda_kernels.build` does.
Prints each source's finish time from its group's start and its kernels'
register counts (the two builds' register counts should agree).

Needs ``nvcc`` (CUDA 12); run from the repository's root:
``python3 scripts/port_build_time.py``.
"""

import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from tpusppy_torch.solvers import cuda_kernels as ck  # noqa: E402

SOURCES = ("fused_sweeps", "fused_sweeps_shared", "fused_sweeps_sparse")


def registers(log):
    return sorted(int(w) for line in log.splitlines() if "registers" in line
                  for w, nxt in zip(line.split(), line.split()[1:])
                  if nxt == "registers,")


def main():
    out = tempfile.mkdtemp()
    for extra in ([], ["--split-compile=0"]):
        t0 = time.perf_counter()
        procs = []
        for nm in SOURCES:
            cmd = [ck._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                   "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                   "-Xptxas", "-v", *extra, "-o",
                   os.path.join(out, f"{nm}{len(extra)}.so"),
                   str(ck.CSRC / f"{nm}.cu")]
            procs.append((nm, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        for nm, p in procs:
            _, err = p.communicate()
            regs = registers(err)
            print(extra, nm, "rc", p.returncode,
                  f"{time.perf_counter() - t0:.1f} s", "kernels", len(regs),
                  "max regs", max(regs, default=0), "sum regs", sum(regs),
                  flush=True)
            if p.returncode:
                print(err[-2000:])
    print("cpu count", os.cpu_count())


if __name__ == "__main__":
    main()
