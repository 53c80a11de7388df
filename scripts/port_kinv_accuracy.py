#!/usr/bin/env python3
"""f32 accuracy and time of the two ways the port factors uc's shared K.

    python3 scripts/port_kinv_accuracy.py [--device cuda] [--reps 5]

The shared-A engine factors a SparseA with block/Woodbury structure through
``structured_kkt.factor_structured`` (with the operator's kernel layout);
a SparseA without structure gets a dense explicit inverse.
At uc's full width (30 generators x 24 hours) this takes the K of a first
factorization: the Ruiz-scaled A (6 passes), q2 = 0 (Iter0), the starting
rho profile (the default base rho, equality rows and fixed variables
boosted by ``rho_eq_scale``, free rows at ``rho_min``).  It factors K both
ways in f32 and prints, against the f64 inverse of the same K:

- ``kinv_err``: max |K^-1 error| / max |K^-1|;
- ``solve_err``: max |x - x64| / max |x64| for x = b K^-1, b random;
- ``backward_err``: max |x K - b| / max |b|;
- ``ms``: the factorization's time, the structured way's kernel layout
  included (the median of ``--reps`` calls; CUDA events on a card, the
  host clock on the CPU).

The errors read the structured operator densified (``kinv_apply`` on the
identity), outside the timed factorization.

One JSON line.  Imports nothing of JAX.
"""

import argparse
import copy
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()

    import numpy as np
    import torch

    from tpusppy_torch.models import uc
    from tpusppy_torch.solvers import shared_admm as sa
    from tpusppy_torch.solvers.admm import ADMMSettings, _explicit_inverse
    from tpusppy_torch.solvers.sparse import SparseA
    from tpusppy_torch.solvers.structured_kkt import kinv_apply
    from tpusppy_torch.spbase import build_batch

    dev = torch.device(args.device)
    card = "cpu"
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    batch, _ = build_batch(uc.scenario_names_creator(2), uc.scenario_creator,
                           {"num_scens": 2, "relax_integers": True})
    st = ADMMSettings(dtype="float64", scaling_iters=6)
    A = SparseA.from_dense(batch.A_shared, torch.float64, dev, structure=True)
    c, q2, A, cl, cu, lb, ub, masks = sa._prep_shared(
        batch.c, batch.q2, A, batch.cl, batch.cu, batch.lb, batch.ub, st, dev)
    q2ref = torch.zeros(A.shape[1], dtype=torch.float64, device=dev)
    D, E = sa._ruiz_shared(A, q2ref, st.scaling_iters)
    As = A.scale(E, D)
    f32 = torch.float32
    ways = {"structured": As.astype(f32), "dense": copy.copy(As.astype(f32))}
    ways["dense"].structure = None
    rng = np.random.RandomState(0)
    b = torch.as_tensor(rng.randn(16, A.shape[1]), device=dev)

    def timed(fn):
        ts = []
        for _ in range(args.reps):
            if dev.type == "cuda":
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                out = fn()
                e1.record()
                e1.synchronize()
                ts.append(e0.elapsed_time(e1))
            else:
                t0 = time.perf_counter()
                out = fn()
                ts.append((time.perf_counter() - t0) * 1e3)
        return out, float(np.median(ts))

    base = torch.full((A.shape[0],), st.rho, dtype=torch.float64,
                      device=dev)
    rho_a = torch.where(masks.eq, st.rho * st.rho_eq_scale, base)
    rho_a = torch.where(masks.loose, st.rho_min, rho_a)
    rho_x = torch.where(masks.eqx, st.rho * st.rho_eq_scale,
                        torch.full_like(q2ref, st.rho))
    Ad = As.todense()
    K = Ad.T @ (rho_a[:, None] * Ad) + torch.diag(rho_x + st.sigma)
    Kinv = _explicit_inverse(K[None])[0]
    x64 = b @ Kinv
    out = {"card": card, "base_rho": st.rho, "n": A.shape[1],
           "cond_K": float(torch.linalg.cond(K))}
    for name, A32 in ways.items():
        Kf, ms = timed(lambda: sa._factor_shared(
            q2ref.to(f32), A32, rho_a.to(f32), rho_x.to(f32), st.sigma)[0])
        Kd = Kf if isinstance(Kf, torch.Tensor) else kinv_apply(
            Kf, torch.eye(A.shape[1], dtype=f32, device=dev))
        x = (b.to(f32) @ Kd).double()
        out[name] = {
            "kinv_err": float((Kd.double() - Kinv).abs().max()
                              / Kinv.abs().max()),
            "solve_err": float((x - x64).abs().max() / x64.abs().max()),
            "backward_err": float((x @ K - b).abs().max() / b.abs().max()),
            "ms": ms}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
