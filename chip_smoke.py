#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpusppy_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA device and the
CUDA toolkit (nvcc).  Phases, each printing a line:

1. card: the device, with ``nvidia-smi``'s name and power limit;
2. build: every hand-written kernel from ``tpusppy_torch/csrc``;
3. kernels: each kernel against its plain PyTorch version on the card at the
   main-path shape (farmer crops_multiplier=4: S=1000, m=28, n=44,
   n_sweeps=4, n_refine=2), in f32 and f64, with CUDA-event times and the
   card's bound for the same work;
4. golden: farmer S=3 PH in f64 through the kernel (EF optimum -108390);
5. main path: farmer-1000 crops_multiplier=4 PH in f32 through the kernel,
   launch counts and host syncs read around exactly that run, then the same
   PH on the batched tensor path and the HiGHS EF of the same scenarios.

Prints a ``{"kernels": [...]}`` line, then as the last line
``{"ok": true, "device": {...}}``.  Any failed phase exits non-zero before
the last line is printed.  Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM data-sheet rates (dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
EF_GOLDEN = -108390.0


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
    cost."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 40_000_000     # 20 ms at the H100's 1.98 GHz, longer if slower
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


def phase_kernels(cuda_kernels):
    """Kernel vs plain version at the main-path shape, f32 and f64."""
    import torch

    S, m, n, n_sweeps, n_refine, alpha = 1000, 28, 44, 4, 2, 1.6
    out = {}
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        args, sigma = sweep_case(S, m, n, dtype)

        def kern():
            return cuda_kernels.fused_sweeps(*args, n_sweeps, n_refine,
                                             sigma, alpha)

        def plain():
            return cuda_kernels.fused_sweeps_plain(*args, n_sweeps,
                                                   n_refine, sigma, alpha)

        got, want = kern(), plain()
        torch.cuda.synchronize()
        abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        rel_err = max(float((g - w).abs().max() / w.abs().max())
                      for g, w in zip(got, want))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        ms, plain_ms = cuda_time_ms(kern), cuda_time_ms(plain)
        # bound: each input read once, each output written once; the
        # arithmetic counts a multiply-add as 2 operations
        nbytes = (sum(a.numel() for a in args)
                  + sum(o.numel() for o in got)) * args[0].element_size()
        flops = 2 * S * n_sweeps * (2 * m * n + n * n * (1 + 2 * n_refine))
        name = str(dtype).replace("torch.", "")
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[name] * 1e3
        out[name] = dict(abs_err=abs_err, rel_err=rel_err, ms=ms,
                         plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops
                         else "operations", bytes=nbytes, flops=flops)
        print(f"kernel fused_sweeps {name}: max_rel_err={rel_err:.3e} "
              f"(tol {tol:.0e}) max_abs_err={abs_err:.3e} "
              f"kernel_ms={ms:.5f} plain_ms={plain_ms:.5f} "
              f"bound_ms={out[name]['bound_ms']:.5f} "
              f"({out[name]['bound_by']}: {nbytes} B, {flops} flop)",
              flush=True)
        check(finite, f"fused_sweeps {name}: non-finite output")
        check(rel_err < tol,
              f"fused_sweeps {name}: kernel disagrees with plain version "
              f"({rel_err:.3e} >= {tol:.0e})")
    return out


def farmer_ph(S, cm, options, extensions=None):
    from tpusppy_torch.models import farmer
    from tpusppy_torch.opt.ph import PH

    return PH(options, farmer.scenario_names_creator(S),
              farmer.scenario_creator,
              scenario_creator_kwargs={"num_scens": S,
                                       "crops_multiplier": cm},
              extensions=extensions)


def phase_golden(cuda_kernels):
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


def run_main_path(cuda_kernels, use_kernel, S=1000, cm=4, iters=100):
    """farmer-S PH in f32; returns (ph, results) with the launch counts and
    host syncs read around exactly this run."""
    import torch

    from tpusppy_torch.extensions.extension import Extension
    from tpusppy_torch.obs import metrics

    opts = {"defaultPHrho": 1.0, "PHIterLimit": iters, "convthresh": 1e-6,
            "solver_options": {"dtype": "float32", "eps_abs": 1e-5,
                               "eps_rel": 1e-5, "use_kernel": use_kernel}}

    class IterZeroClock(Extension):
        """Stamps the end of Iter0, so the PH rate excludes it."""

        def post_iter0(self):
            torch.cuda.synchronize()
            self.opt.t_iter0_done = time.perf_counter()

    ph = farmer_ph(S, cm, opts, extensions=IterZeroClock)
    torch.cuda.synchronize()
    cuda_kernels.reset_counts()
    with metrics.window() as win:
        t0 = time.perf_counter()
        _, eobj, _ = ph.ph_main()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    t1 = ph.t_iter0_done
    launches = cuda_kernels.launches["fused_sweeps"]
    plain = cuda_kernels.plain_calls["fused_sweeps"]
    n_it = max(ph._iter, 1)
    syncs = win.delta("host_sync.count") + win.delta("admm.loop_checks")
    res = dict(eobj=eobj, tbound=ph.trivial_bound, conv=ph.conv,
               iters=ph._iter, wall_s=t2 - t0, iter0_s=t1 - t0,
               loop_s=t2 - t1, rate=ph._iter / (t2 - t1),
               launches=launches, plain_calls=plain,
               launches_per_iter=launches / n_it,
               syncs_per_iter=syncs / n_it,
               fetches_per_iter=win.delta("host_sync.count") / n_it,
               loop_checks_per_iter=win.delta("admm.loop_checks") / n_it,
               rescued=win.delta("solve.rescued_scenarios"))
    x = ph.local_x
    check(x.shape == (ph.batch.num_scenarios, ph.batch.num_vars),
          f"local_x shape {x.shape}")
    check(bool(np.isfinite(x).all() and np.isfinite(ph.W).all()),
          "non-finite PH state")
    return ph, res


def phase_main(cuda_kernels):
    from tpusppy_torch.ef import solve_ef

    ph, k = run_main_path(cuda_kernels, use_kernel="auto")
    print(f"main path farmer-1000 cm=4 f32 kernel: eobj={k['eobj']:.4f} "
          f"tbound={k['tbound']:.4f} conv={k['conv']:.3e} "
          f"iters={k['iters']} wall_s={k['wall_s']:.3f} "
          f"(iter0 {k['iter0_s']:.3f}, loop {k['loop_s']:.3f}) "
          f"ph_it_per_s={k['rate']:.3f} launches={k['launches']} "
          f"launches_per_iter={k['launches_per_iter']:.2f} "
          f"host_syncs_per_iter={k['syncs_per_iter']:.2f} "
          f"(fetches {k['fetches_per_iter']:.2f} + loop checks "
          f"{k['loop_checks_per_iter']:.2f}) rescued={k['rescued']:.0f}",
          flush=True)
    check(k["launches"] > 0, "the main path launched no fused_sweeps kernel")
    check(k["plain_calls"] == 0,
          f"the main path ran the plain sweep {k['plain_calls']} times")

    _, p = run_main_path(cuda_kernels, use_kernel=False)
    print(f"main path farmer-1000 cm=4 f32 tensor path: "
          f"eobj={p['eobj']:.4f} tbound={p['tbound']:.4f} "
          f"iters={p['iters']} wall_s={p['wall_s']:.3f} "
          f"ph_it_per_s={p['rate']:.3f} "
          f"host_syncs_per_iter={p['syncs_per_iter']:.2f}", flush=True)
    check(p["launches"] == 0, "use_kernel=False launched the kernel")
    t0 = time.perf_counter()
    ef_obj, _ = solve_ef(ph.batch, solver="highs")
    print(f"EF HiGHS farmer-1000 cm=4: {ef_obj:.4f} "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    rel_kp = abs(k["eobj"] - p["eobj"]) / abs(p["eobj"])
    print(f"eobj kernel vs tensor path rel diff {rel_kp:.3e}; vs EF "
          f"{abs(k['eobj'] - ef_obj) / abs(ef_obj):.3e} / "
          f"{abs(p['eobj'] - ef_obj) / abs(ef_obj):.3e}", flush=True)
    check(rel_kp <= 1e-4, f"kernel and tensor-path eobj differ by {rel_kp}")
    for tag, r in (("kernel", k), ("tensor path", p)):
        check(abs(r["eobj"] - ef_obj) <= 1e-2 * abs(ef_obj),
              f"{tag} eobj {r['eobj']} not within 1e-2 of EF {ef_obj}")
        check(r["tbound"] <= ef_obj + 1e-6 * abs(ef_obj),
              f"{tag} trivial bound {r['tbound']} above EF {ef_obj}")
    return k, p, ef_obj


def main() -> int:
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
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        print(smi, flush=True)
        print(f"card: {torch.cuda.get_device_name(0)} x "
              f"{torch.cuda.device_count()}, torch {torch.__version__}, "
              f"CUDA {torch.version.cuda}", flush=True)
        t0 = time.perf_counter()
        cuda_kernels.build("fused_sweeps")
        print(f"build: fused_sweeps in {time.perf_counter() - t0:.2f} s",
              flush=True)
        kres = phase_kernels(cuda_kernels)
        phase_golden(cuda_kernels)
        k, _, _ = phase_main(cuda_kernels)
    except PhaseError as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    f32 = kres["float32"]
    print(json.dumps({"kernels": [{
        "name": "fused_sweeps", "route": "cuda",
        "source": "tpusppy_torch/csrc/fused_sweeps.cu",
        "replaces": "tpusppy/solvers/pallas_kernels.py:57",
        "launches": k["launches"], "max_abs_err": f32["abs_err"],
        "ms": f32["ms"], "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": None}]}), flush=True)
    print(f"total: {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
