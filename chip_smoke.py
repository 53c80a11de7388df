#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpusppy_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA device and the
CUDA toolkit (nvcc).  Phases, each printing a line:

1. card: the device, with ``nvidia-smi``'s name and power limit;
2. build: every hand-written kernel from ``tpusppy_torch/csrc``, one
   ``nvcc`` per source, all started together;
3. kernels: each kernel against its plain PyTorch version on the card at
   its main path's shape, in f32 and f64, with CUDA-event times and the
   card's bound for the same work: ``fused_sweeps`` at farmer
   crops_multiplier=4 (S=1000, m=28, n=44, n_sweeps=4, n_refine=2),
   ``fused_sweeps_shared`` at uc_lite's defaults (S=1000, m=242, n=132,
   n_sweeps=4, n_refine=2, n_extra=2, with has=1 and has=0);
4. goldens in f64 through the kernels: farmer S=3 PH (EF optimum -108390),
   and uc_lite S=3 (3 generators, 6 hours) PH against its HiGHS EF;
5. main paths, each with the launch counts and host syncs read around
   exactly that run, then the first iterations of the same PH on the
   batched tensor path (eobj held to the kernel run's after as many
   iterations) and the HiGHS EF of the same scenarios: farmer-1000
   crops_multiplier=4 PH in f32 (100 iterations, 50 on the tensor path)
   through ``fused_sweeps`` (the dense per-scenario engine), and
   uc_lite-1000 at its defaults (rho 500, 60 iterations, 20 on the tensor
   path) PH in f32 through ``fused_sweeps_shared`` (the shared-A engine).

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

# H100 SXM data-sheet rates (dense, at the 700 W limit): f32 outside the
# tensor cores, f64 on the tensor cores (full IEEE f64; 34 on CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 67e12}
EF_GOLDEN = -108390.0
# uc_lite S=3 golden: the repo's own settings (tests/test_models.py)
UC_GOLDEN_OPTIONS = {"defaultPHrho": 10.0, "convthresh": 1e-5}
# uc_lite-1000: rho 500, the repo's unit-commitment PH rho (bench_uc.py).
# At the golden's rho 10 the S=1000 eobj climbs toward the EF far too
# slowly to come within 1e-2 in a depth that fits the time limit.
UC_MAIN_OPTIONS = {"defaultPHrho": 500.0, "convthresh": 1e-5}


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


def shared_sweep_case(S, m, n, dtype, has, seed=0):
    """Random fused_sweeps_shared inputs on the card: one A (entries ~
    1/sqrt(n)), rho >= 0.5 so the shared K is well conditioned, gamma in
    [0.6, 1.8], and dq2 <= 0.05, small against gamma K's diagonal, so the
    refinement contracts."""
    import torch

    rng = np.random.RandomState(seed)
    sigma = 1e-6
    A = rng.randn(m, n) / np.sqrt(n)
    rho_a = rng.uniform(0.5, 1.0, size=(1, m))
    rho_x = rng.uniform(0.5, 1.0, size=(1, n))
    K = (A.T * rho_a) @ A + sigma * np.eye(n) + np.diag(rho_x[0])
    Kinv = np.linalg.inv(K)
    cl = -np.abs(rng.randn(S, m)) - 0.5
    cu = np.abs(rng.randn(S, m)) + 0.5
    x = rng.randn(S, n) * 0.1
    arrs = dict(
        q=rng.randn(S, n), A=A, Kinv=Kinv, K=K, cl=cl, cu=cu,
        lb=-2.0 * np.ones((S, n)), ub=2.0 * np.ones((S, n)),
        rho_a=rho_a, rho_x=rho_x,
        dq2=0.05 * rng.uniform(size=(S, n)) * has,
        has=np.full((1, 1), float(has)),
        gamma=rng.uniform(0.6, 1.8, size=(S, 1)), x=x,
        z=np.clip(rng.randn(S, m), cl, cu), zx=np.clip(x, -2.0, 2.0),
        y=0.1 * rng.randn(S, m), yx=0.1 * rng.randn(S, n), Ax=x @ A.T)
    order = ("q", "A", "Kinv", "K", "cl", "cu", "lb", "ub", "rho_a",
             "rho_x", "dq2", "has", "gamma", "x", "z", "zx", "y", "yx", "Ax")
    return [torch.as_tensor(arrs[k], dtype=dtype, device="cuda")
            for k in order], sigma


def hold_kernel(label, kern, plain, args, flops, tol, dtype):
    """One kernel call against its plain version on the same inputs, then
    both timed; returns the errors, times and bound."""
    import torch

    got, want = kern(), plain()
    torch.cuda.synchronize()
    abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    rel_err = max(float((g - w).abs().max() / w.abs().max())
                  for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    ms, plain_ms = cuda_time_ms(kern), cuda_time_ms(plain)
    # bound: each input read once, each output written once, over the HBM
    # rate; the arithmetic (a multiply-add counts 2) over the peak rate
    nbytes = (sum(a.numel() for a in args)
              + sum(o.numel() for o in got)) * args[0].element_size()
    name = str(dtype).replace("torch.", "")
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[name] * 1e3
    res = dict(abs_err=abs_err, rel_err=rel_err, ms=ms, plain_ms=plain_ms,
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations",
               bytes=nbytes, flops=flops)
    print(f"kernel {label} {name}: max_rel_err={rel_err:.3e} "
          f"(tol {tol:.0e}) max_abs_err={abs_err:.3e} kernel_ms={ms:.5f} "
          f"plain_ms={plain_ms:.5f} bound_ms={res['bound_ms']:.5f} "
          f"({res['bound_by']}: {nbytes} B, {flops} flop)", flush=True)
    check(finite, f"{label} {name}: non-finite output")
    check(rel_err < tol, f"{label} {name}: kernel disagrees with plain "
          f"version ({rel_err:.3e} >= {tol:.0e})")
    return res


def phase_kernels(cuda_kernels):
    """Each kernel against its plain version at its main path's shape, in
    f32 and f64."""
    import torch

    out = {"fused_sweeps": {}, "fused_sweeps_shared": {}}
    S, m, n, n_sweeps, n_refine, alpha = 1000, 28, 44, 4, 2, 1.6
    flops = 2 * S * n_sweeps * (2 * m * n + n * n * (1 + 2 * n_refine))
    for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
        args, sigma = sweep_case(S, m, n, dtype)
        out["fused_sweeps"][dtype] = hold_kernel(
            "fused_sweeps",
            lambda: cuda_kernels.fused_sweeps(*args, n_sweeps, n_refine,
                                              sigma, alpha),
            lambda: cuda_kernels.fused_sweeps_plain(*args, n_sweeps,
                                                    n_refine, sigma, alpha),
            args, flops, tol, dtype)
    S, m, n, n_extra = 1000, 242, 132, 2
    for has in (1, 0):
        flops = 2 * S * n_sweeps * (
            2 * m * n + n * n * (1 + 2 * n_refine + 2 * n_extra * has))
        for dtype, tol in ((torch.float32, 1e-5), (torch.float64, 1e-12)):
            args, sigma = shared_sweep_case(S, m, n, dtype, has)
            # A' made once, as the engine makes it once per solve
            At = args[1].T.contiguous()
            out["fused_sweeps_shared"][(dtype, has)] = hold_kernel(
                f"fused_sweeps_shared has={has}",
                lambda: cuda_kernels.fused_sweeps_shared(
                    *args, n_sweeps, n_refine, n_extra, sigma, alpha, At=At),
                lambda: cuda_kernels.fused_sweeps_shared_plain(
                    *args, n_sweeps, n_refine, n_extra, sigma, alpha),
                args, flops, tol, dtype)
    return out


def farmer_ph(S, cm, options, extensions=None):
    from tpusppy_torch.models import farmer
    from tpusppy_torch.opt.ph import PH

    return PH(options, farmer.scenario_names_creator(S),
              farmer.scenario_creator,
              scenario_creator_kwargs={"num_scens": S,
                                       "crops_multiplier": cm},
              extensions=extensions)


def uc_ph(S, options, extensions=None, **kw):
    """uc_lite PH (LP relaxation) on its shared-A engine; ``kw`` goes to
    the scenario creator (num_gens, horizon)."""
    from tpusppy_torch.models import uc_lite
    from tpusppy_torch.opt.ph import PH

    ph = PH(options, uc_lite.scenario_names_creator(S),
            uc_lite.scenario_creator,
            scenario_creator_kwargs=dict(kw, num_scens=S,
                                         relax_integers=True),
            extensions=extensions)
    check(ph.batch.A_shared is not None, "uc_lite batch is not shared-A")
    return ph


def phase_golden(cuda_kernels):
    from tpusppy_torch.ef import solve_ef

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

    # the repo's uc_lite settings and limits (tests/test_models.py)
    ph = uc_ph(3, dict(UC_GOLDEN_OPTIONS, PHIterLimit=60), num_gens=3,
               horizon=6)
    cuda_kernels.reset_counts()
    conv, eobj, tbound = ph.ph_main()
    launches = cuda_kernels.launches["fused_sweeps_shared"]
    plain = cuda_kernels.plain_calls["fused_sweeps_shared"]
    ef_obj, _ = solve_ef(ph.batch, solver="highs")
    print(f"golden uc_lite S=3 (3 gens, 6 h) f64 on {ph.device}: "
          f"conv={conv:.3e} eobj={eobj:.4f} tbound={tbound:.4f} "
          f"(EF {ef_obj:.4f}, rel {abs(eobj - ef_obj) / abs(ef_obj):.3e}) "
          f"launches={launches} plain_calls={plain}", flush=True)
    check(launches > 0 and plain == 0, "the uc_lite golden run did not go "
          "through the fused_sweeps_shared kernel")
    check(abs(eobj - ef_obj) <= 1e-2 * abs(ef_obj),
          f"uc_lite golden eobj {eobj} not within 1e-2 of EF {ef_obj}")
    check(tbound <= ef_obj + 1e-6 * abs(ef_obj),
          f"uc_lite golden trivial bound {tbound} above EF {ef_obj}")


def run_path(cuda_kernels, kernel, make_ph, use_kernel, iters, options):
    """One main path's PH in f32; returns (ph, results) with the launch
    counts and host syncs read around exactly this run."""
    import torch

    from tpusppy_torch.extensions.extension import Extension
    from tpusppy_torch.obs import metrics

    opts = dict(options, PHIterLimit=iters,
                solver_options={"dtype": "float32", "eps_abs": 1e-5,
                                "eps_rel": 1e-5, "use_kernel": use_kernel})

    class Clock(Extension):
        """Stamps the end of Iter0, so the PH rate excludes it, and records
        eobj after every iteration."""

        def post_iter0(self):
            torch.cuda.synchronize()
            self.opt.t_iter0_done = time.perf_counter()
            self.opt.eobj_trace = []

        def enditer(self):
            self.opt.eobj_trace.append(self.opt.Eobjective())

    ph = make_ph(opts, Clock)
    torch.cuda.synchronize()
    cuda_kernels.reset_counts()
    with metrics.window() as win:
        t0 = time.perf_counter()
        _, eobj, _ = ph.ph_main()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    t1 = ph.t_iter0_done
    launches = cuda_kernels.launches[kernel]
    plain = cuda_kernels.plain_calls[kernel]
    n_it = max(ph._iter, 1)
    syncs = win.delta("host_sync.count") + win.delta("admm.loop_checks")
    res = dict(eobj=eobj, eobj_trace=ph.eobj_trace,
               tbound=ph.trivial_bound, conv=ph.conv,
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


def phase_main(cuda_kernels, label, kernel, make_ph, iters, tensor_iters,
               options):
    """A main path through ``kernel``, the same PH on the tensor path for
    its first ``tensor_iters`` iterations (the plain sweep is launch-bound
    on the host, so its depth is cut to fit the time limit), and the HiGHS
    EF of the same scenarios."""
    from tpusppy_torch.ef import solve_ef

    ph, k = run_path(cuda_kernels, kernel, make_ph, "auto", iters, options)
    print(f"main path {label} f32 kernel: eobj={k['eobj']:.4f} "
          f"tbound={k['tbound']:.4f} conv={k['conv']:.3e} "
          f"iters={k['iters']} wall_s={k['wall_s']:.3f} "
          f"(iter0 {k['iter0_s']:.3f}, loop {k['loop_s']:.3f}) "
          f"ph_it_per_s={k['rate']:.3f} launches={k['launches']} "
          f"launches_per_iter={k['launches_per_iter']:.2f} "
          f"host_syncs_per_iter={k['syncs_per_iter']:.2f} "
          f"(fetches {k['fetches_per_iter']:.2f} + loop checks "
          f"{k['loop_checks_per_iter']:.2f}) rescued={k['rescued']:.0f}",
          flush=True)
    check(k["launches"] > 0, f"the main path launched no {kernel} kernel")
    check(k["plain_calls"] == 0,
          f"the main path ran the plain sweep {k['plain_calls']} times")
    check(k["iters"] == iters, f"the main path ran {k['iters']} of {iters} "
          "PH iterations")

    _, p = run_path(cuda_kernels, kernel, make_ph, False, tensor_iters,
                    options)
    print(f"main path {label} f32 tensor path: "
          f"eobj={p['eobj']:.4f} tbound={p['tbound']:.4f} "
          f"iters={p['iters']} wall_s={p['wall_s']:.3f} "
          f"ph_it_per_s={p['rate']:.3f} "
          f"host_syncs_per_iter={p['syncs_per_iter']:.2f}", flush=True)
    check(p["launches"] == 0, "use_kernel=False launched the kernel")
    check(p["iters"] == tensor_iters, f"the tensor path ran {p['iters']} of "
          f"{tensor_iters} PH iterations")
    # the kernel run's eobj after the same number of iterations
    k_eobj = k["eobj_trace"][tensor_iters - 1]
    rel_kp = abs(k_eobj - p["eobj"]) / abs(p["eobj"])
    print(f"{label} eobj after {tensor_iters} iterations, kernel vs tensor "
          f"path rel diff {rel_kp:.3e}", flush=True)
    check(rel_kp <= 1e-4, f"kernel and tensor-path eobj differ by {rel_kp}")

    t0 = time.perf_counter()
    ef_obj, _ = solve_ef(ph.batch, solver="highs")
    rel_ef = abs(k["eobj"] - ef_obj) / abs(ef_obj)
    print(f"EF HiGHS {label}: {ef_obj:.4f} ({time.perf_counter() - t0:.2f} "
          f"s); kernel eobj vs EF {rel_ef:.3e}", flush=True)
    check(rel_ef <= 1e-2, f"eobj {k['eobj']} not within 1e-2 of EF {ef_obj}")
    for tag, r in (("kernel", k), ("tensor path", p)):
        check(r["tbound"] <= ef_obj + 1e-6 * abs(ef_obj),
              f"{tag} trivial bound {r['tbound']} above EF {ef_obj}")
    return k


def kernel_line(name, source, replaces, launches, res):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": res["abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None}


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
        cuda_kernels.build()
        print(f"build: {', '.join(cuda_kernels.build_log)} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        for name, log in cuda_kernels.build_log.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {name}: {line.strip()}", flush=True)
        kres = phase_kernels(cuda_kernels)
        phase_golden(cuda_kernels)
        farmer = phase_main(
            cuda_kernels, "farmer-1000 cm=4", "fused_sweeps",
            lambda o, ext: farmer_ph(1000, 4, o, extensions=ext), 100, 50,
            {"defaultPHrho": 1.0, "convthresh": 1e-6})
        uc = phase_main(
            cuda_kernels, "uc_lite-1000", "fused_sweeps_shared",
            lambda o, ext: uc_ph(1000, o, extensions=ext), 60, 20,
            UC_MAIN_OPTIONS)
    except PhaseError as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    f32 = torch.float32
    print(json.dumps({"kernels": [
        kernel_line("fused_sweeps", "tpusppy_torch/csrc/fused_sweeps.cu",
                    "tpusppy/solvers/pallas_kernels.py:57",
                    farmer["launches"], kres["fused_sweeps"][f32]),
        kernel_line("fused_sweeps_shared",
                    "tpusppy_torch/csrc/fused_sweeps_shared.cu",
                    "tpusppy/solvers/pallas_kernels.py:265",
                    uc["launches"], kres["fused_sweeps_shared"][(f32, 1)]),
    ]}), flush=True)
    print(f"total: {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
