"""Reference-shape stochastic unit commitment (a copy of
``tpusppy/models/uc.py``, template cache included).

This is the scaled counterpart of :mod:`tpusppy_torch.models.uc_lite`,
matching the decision structure of the reference's UC example (egret-built
models driven by ``examples/uc/uc_funcs.py`` and the
``paperruns/larger_uc`` wind-scenario ladders): binary commitment with
startup/shutdown variables and min-up/min-down constraints, dispatch with
capacity/ramp/startup-ramp limits, hourly power balance and spinning-reserve requirements, wind uncertainty.

Wind enters ONLY the balance/reserve right-hand sides, so every scenario
shares one constraint matrix — the batch runs on the shared-A engine
(``ir.ScenarioBatch.A_shared`` -> ``solvers.shared_admm``), which is what
makes 1000-scenario reference-scale instances fit a single card (a dense
(S, m, n) A at 30 gens x 48 h x S=1000 is ~67 GB; the shared matrix is
~60 MB).  At 30 generators x 24 hours the shared A is (4626, 2928) with
0.14% non-zeros, so the port uploads it as a ``solvers.sparse.SparseA`` and
solves it on the structured-KKT engine.

Model (per generator g, hour h; all rows linear):

  vars   u[g,h] in {0,1} commitment (FIRST STAGE, the nonants)
         v[g,h], w[g,h] in [0,1] startup/shutdown indicators
         p[g,h] >= 0 dispatch, shed[h] >= 0 load shed (VOLL),
         rsh[h] >= 0 reserve shortfall (penalized)
  rows   u[g,h] - u[g,h-1] = v[g,h] - w[g,h]            (logic, equality)
         sum_{t in (h-UT,h]} v[g,t] <= u[g,h]           (min-up)
         sum_{t in (h-DT,h]} w[g,t] <= 1 - u[g,h]       (min-down)
         pmin u <= p <= pmax u                          (capacity)
         p[h] - p[h-1] <= RU u[g,h-1] + SU v[g,h]       (ramp up / startup)
         p[h-1] - p[h] <= RD u[g,h] + SD w[g,h]         (ramp down / shutdn)
         sum_g p + shed >= demand[h] - wind_s[h]        (balance; rhs varies)
         sum_g (pmax u - p) + rsh >= resreq_s[h]        (spinning reserve)
  cost   mc p + noload u + startcost v + VOLL shed + rpen rsh

The fleet is a seeded mix of unit classes (base/mid/peaker) with class-scaled
minimum up/down times, ramps and startup costs.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ir import LinearModelBuilder
from ..scenario_tree import ScenarioNode, extract_num

VOLL = 5000.0      # value of lost load ($/MWh)
RPEN = 1000.0      # reserve-shortfall penalty ($/MWh)
RESERVE_FRAC = 0.1  # spinning reserve requirement as a fraction of demand

_TEMPLATE_CACHE: dict = {}


def scenario_names_creator(num_scens, start=0):
    return [f"Scenario{i}" for i in range(start, start + num_scens)]


def kw_creator(cfg=None, **kwargs):
    cfg = cfg or {}
    get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: getattr(cfg, k, d)
    return {
        "num_gens": kwargs.get("num_gens", get("uc_num_gens", 30)),
        "horizon": kwargs.get("horizon", get("uc_horizon", 24)),
        "num_scens": kwargs.get("num_scens", get("num_scens")),
        "seedoffset": kwargs.get("seedoffset", get("seedoffset", 0)),
        "relax_integers": kwargs.get("relax_integers",
                                     get("relax_integers", False)),
        "wind_frac": kwargs.get("wind_frac", get("uc_wind_frac", 0.25)),
    }


def inparser_adder(cfg):
    if "num_scens" not in cfg:
        cfg.num_scens_required()
    cfg.add_to_config("uc_num_gens", "number of thermal generators", int, 30)
    cfg.add_to_config("uc_horizon", "scheduling horizon (hours)", int, 24)
    cfg.add_to_config("uc_wind_frac",
                      "mean wind share of peak thermal capacity", float, 0.25)


def _fleet(num_gens, seedoffset):
    """Seeded thermal fleet: base-load / mid-merit / peaker classes with
    class-correlated sizes, costs, ramps and min-up/down times."""
    stream = np.random.RandomState(4242 + seedoffset)
    cls = stream.choice(3, size=num_gens, p=[0.3, 0.4, 0.3])  # 0=base,1=mid,2=peak
    size_lo = np.array([200.0, 80.0, 20.0])[cls]
    size_hi = np.array([400.0, 200.0, 80.0])[cls]
    pmax = size_lo + (size_hi - size_lo) * stream.rand(num_gens)
    pmin = pmax * np.array([0.45, 0.35, 0.2])[cls]
    mc = (np.array([12.0, 25.0, 45.0])[cls]
          * (0.85 + 0.3 * stream.rand(num_gens)))
    noload = pmax * np.array([2.0, 1.2, 0.6])[cls]
    startcost = pmax * np.array([40.0, 15.0, 4.0])[cls]
    ramp = pmax * np.array([0.25, 0.5, 1.0])[cls]          # per-hour ramp
    startramp = np.maximum(pmin, ramp)                     # SU/SD limits
    minup = np.array([8, 4, 1])[cls]
    mindown = np.array([6, 3, 1])[cls]
    return dict(pmax=pmax, pmin=pmin, mc=mc, noload=noload,
                startcost=startcost, ramp=ramp, startramp=startramp,
                minup=minup, mindown=mindown)


def _template(num_gens, horizon, seedoffset, relax_integers):
    key = (num_gens, horizon, seedoffset, relax_integers)
    cached = _TEMPLATE_CACHE.get(key)
    if cached is not None:
        return cached
    fl = _fleet(num_gens, seedoffset)
    as_int = not relax_integers
    G, H = num_gens, horizon
    b = LinearModelBuilder("template")
    u = np.empty((G, H), dtype=np.int64)
    v = np.empty((G, H), dtype=np.int64)
    w = np.empty((G, H), dtype=np.int64)
    p = np.empty((G, H), dtype=np.int64)
    for g in range(G):
        for h in range(H):
            u[g, h] = b.add_var(f"u[{g},{h}]", lb=0.0, ub=1.0,
                                cost=fl["noload"][g], integer=as_int)
    for g in range(G):
        for h in range(H):
            v[g, h] = b.add_var(f"v[{g},{h}]", lb=0.0, ub=1.0,
                                cost=fl["startcost"][g])
    for g in range(G):
        for h in range(H):
            w[g, h] = b.add_var(f"w[{g},{h}]", lb=0.0, ub=1.0)
    for g in range(G):
        for h in range(H):
            p[g, h] = b.add_var(f"p[{g},{h}]", lb=0.0, cost=fl["mc"][g])
    shed = b.add_vars("shed", H, lb=0.0, cost=VOLL)
    rsh = b.add_vars("rsh", H, lb=0.0, cost=RPEN)

    # initial state: units start OFF with p=0 (h=0 logic rows use u[-1]=0)
    for g in range(G):
        pmax_g, pmin_g = float(fl["pmax"][g]), float(fl["pmin"][g])
        RU = float(fl["ramp"][g])
        SU = float(fl["startramp"][g])
        UT = int(fl["minup"][g])
        DT = int(fl["mindown"][g])
        for h in range(H):
            # commitment logic
            if h == 0:
                b.add_eq({u[g, 0]: 1.0, v[g, 0]: -1.0, w[g, 0]: 1.0}, 0.0)
            else:
                b.add_eq({u[g, h]: 1.0, u[g, h - 1]: -1.0,
                          v[g, h]: -1.0, w[g, h]: 1.0}, 0.0)
            # min-up / min-down (Rajan–Takriti turn-on/off inequalities)
            if UT > 1:
                coeffs = {v[g, t]: 1.0 for t in range(max(0, h - UT + 1), h + 1)}
                coeffs[u[g, h]] = coeffs.get(u[g, h], 0.0) - 1.0
                b.add_le(coeffs, 0.0)
            if DT > 1:
                coeffs = {w[g, t]: 1.0 for t in range(max(0, h - DT + 1), h + 1)}
                coeffs[u[g, h]] = coeffs.get(u[g, h], 0.0) + 1.0
                b.add_le(coeffs, 1.0)
            # capacity
            b.add_le({p[g, h]: 1.0, u[g, h]: -pmax_g}, 0.0)
            b.add_ge({p[g, h]: 1.0, u[g, h]: -pmin_g}, 0.0)
            # ramps with startup/shutdown allowances
            if h == 0:
                b.add_le({p[g, 0]: 1.0, v[g, 0]: -SU}, 0.0)
            else:
                b.add_le({p[g, h]: 1.0, p[g, h - 1]: -1.0,
                          u[g, h - 1]: -RU, v[g, h]: -SU}, 0.0)
                b.add_le({p[g, h - 1]: 1.0, p[g, h]: -1.0,
                          u[g, h]: -RU, w[g, h]: -SU}, 0.0)
    # balance + reserve rows LAST (their rhs is the per-scenario part)
    for h in range(H):
        coeffs = {p[g, h]: 1.0 for g in range(G)}
        coeffs[shed[h]] = 1.0
        b.add_ge(coeffs, 0.0)                       # >= demand - wind_s
    for h in range(H):
        coeffs = {u[g, h]: float(fl["pmax"][g]) for g in range(G)}
        for g in range(G):
            coeffs[p[g, h]] = -1.0
        coeffs[rsh[h]] = 1.0
        b.add_ge(coeffs, 0.0)                       # >= reserve requirement

    mdl = b.build()
    m = mdl.num_rows
    balance_rows = np.arange(m - 2 * H, m - H)
    reserve_rows = np.arange(m - H, m)
    nonants = u.reshape(-1).astype(np.int32)
    _TEMPLATE_CACHE[key] = (mdl, balance_rows, reserve_rows, nonants, fl)
    return _TEMPLATE_CACHE[key]


def _wind_demand(scennum, seedoffset, horizon, fl, wind_frac):
    """Deterministic demand sinusoid + per-scenario wind random walk,
    mirroring the reference's wind-scenario ladders
    (paperruns/larger_uc/*scenarios_wind)."""
    cap = fl["pmax"].sum()
    t = np.arange(horizon)
    demand = 0.65 * cap * (1.0 + 0.25 * np.sin(2 * np.pi * (t - 6) / 24.0)
                           + 0.08 * np.sin(4 * np.pi * (t - 2) / 24.0))
    stream = np.random.RandomState(91000 + scennum + seedoffset)
    wind_mean = wind_frac * cap
    walk = np.cumsum(stream.normal(0.0, 0.12 * wind_mean, horizon))
    diurnal = 0.3 * wind_mean * np.sin(2 * np.pi * (t + 6) / 24.0)
    wind = np.clip(wind_mean + diurnal + walk, 0.0, 2.0 * wind_mean)
    return demand, wind


def scenario_creator(scenario_name, num_gens=30, horizon=24, num_scens=None,
                     seedoffset=0, relax_integers=False, wind_frac=0.25):
    scennum = extract_num(scenario_name)
    mdl, balance_rows, reserve_rows, nonants, fl = _template(
        num_gens, horizon, seedoffset, relax_integers)
    demand, wind = _wind_demand(scennum, seedoffset, horizon, fl, wind_frac)
    cl = mdl.cl.copy()
    cl[balance_rows] = demand - wind
    cl[reserve_rows] = RESERVE_FRAC * demand
    return dataclasses.replace(
        mdl,
        name=scenario_name,
        cl=cl,
        prob=None if num_scens is None else 1.0 / num_scens,
        nodes=[ScenarioNode("ROOT", 1.0, 1, nonants)],
    )


def scenario_denouement(rank, scenario_name, scenario):
    pass
