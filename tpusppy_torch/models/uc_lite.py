"""UC-lite: stochastic unit commitment in the tpusppy_torch IR (a copy of
``tpusppy/models/uc_lite.py``, template cache included).

The reference's UC example rides Egret + Prescient wind-scenario data files
(``examples/uc/uc_funcs.py``, ``paperruns/larger_uc``).  This self-contained
analogue keeps the decision structure that makes stochastic UC the paper's
headline benchmark: first-stage per-generator per-hour commitment (the
nonants), second-stage economic dispatch against a stochastic net-load
profile, with min/max output linked to commitment, ramping limits, and load
shedding at VOLL.

Instances are seeded generators: ``num_gens`` thermal units with jittered
cost/capacity blocks, ``horizon`` hours, scenario demand = base sinusoid *
lognormal wind error walk.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ir import LinearModelBuilder
from ..scenario_tree import ScenarioNode, extract_num

VOLL = 1000.0  # value of lost load ($/MWh)

# Template cache: uncertainty enters ONLY the power-balance rhs, so every
# scenario shares one constraint matrix.  Reusing the same numpy A object
# across ScenarioProblems opts the batch into the shared-A engine
# (ir.ScenarioBatch.A_shared / solvers.shared_admm) — the (S, m, n) tensor is
# never materialized, which is what makes reference-scale UC
# (paperruns/larger_uc) fit one card.
_TEMPLATE_CACHE: dict = {}


def scenario_names_creator(num_scens, start=0):
    return [f"Scenario{i}" for i in range(start, start + num_scens)]


def kw_creator(cfg=None, **kwargs):
    cfg = cfg or {}
    get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: getattr(cfg, k, d)
    return {
        "num_gens": kwargs.get("num_gens", get("uc_num_gens", 5)),
        "horizon": kwargs.get("horizon", get("uc_horizon", 12)),
        "num_scens": kwargs.get("num_scens", get("num_scens")),
        "seedoffset": kwargs.get("seedoffset", get("seedoffset", 0)),
        # integer commitment by DEFAULT: this is the headline family's whole
        # point (1000-scenario stochastic UC with integer u); pass
        # relax_integers=True explicitly for the easy LP mode
        "relax_integers": kwargs.get("relax_integers",
                                     get("relax_integers", False)),
    }


def inparser_adder(cfg):
    if "num_scens" not in cfg:
        cfg.num_scens_required()
    cfg.add_to_config("uc_num_gens", "number of generators", int, 5)
    cfg.add_to_config("uc_horizon", "scheduling horizon (hours)", int, 12)


def _fleet(num_gens, seedoffset):
    stream = np.random.RandomState(4242 + seedoffset)
    pmax = 50.0 + 100.0 * stream.rand(num_gens)
    pmin = 0.25 * pmax
    mc = 15.0 + 30.0 * stream.rand(num_gens)        # marginal cost
    noload = 100.0 + 300.0 * stream.rand(num_gens)  # no-load (commitment) cost
    ramp = 0.4 * pmax
    return pmax, pmin, mc, noload, ramp


def _template(num_gens, horizon, seedoffset, relax_integers):
    """Build the scenario-independent model ONCE per configuration; scenarios
    only rewrite the balance-row rhs (see module docstring)."""
    key = (num_gens, horizon, seedoffset, relax_integers)
    cached = _TEMPLATE_CACHE.get(key)
    if cached is not None:
        return cached
    pmax, pmin, mc, noload, ramp = _fleet(num_gens, seedoffset)
    as_int = not relax_integers
    b = LinearModelBuilder("template")
    u, p = {}, {}
    for g in range(num_gens):
        for h in range(horizon):
            u[g, h] = b.add_var(f"u[{g},{h}]", lb=0.0, ub=1.0,
                                cost=noload[g], integer=as_int)
    for g in range(num_gens):
        for h in range(horizon):
            p[g, h] = b.add_var(f"p[{g},{h}]", lb=0.0, cost=mc[g])
    shed = b.add_vars("shed", horizon, lb=0.0, cost=VOLL)

    for g in range(num_gens):
        for h in range(horizon):
            b.add_le({p[g, h]: 1.0, u[g, h]: -pmax[g]}, 0.0)   # p <= pmax u
            b.add_ge({p[g, h]: 1.0, u[g, h]: -pmin[g]}, 0.0)   # p >= pmin u
            if h > 0:                                          # ramping
                b.add_le({p[g, h]: 1.0, p[g, h - 1]: -1.0}, float(ramp[g]))
                b.add_ge({p[g, h]: 1.0, p[g, h - 1]: -1.0}, -float(ramp[g]))
    for h in range(horizon):
        coeffs = {p[g, h]: 1.0 for g in range(num_gens)}
        coeffs[shed[h]] = 1.0
        b.add_ge(coeffs, 0.0)                # balance rhs set per scenario

    mdl = b.build()
    balance_rows = np.arange(mdl.num_rows - horizon, mdl.num_rows)
    nonants = np.asarray([u[g, h] for g in range(num_gens)
                          for h in range(horizon)], dtype=np.int32)
    _TEMPLATE_CACHE[key] = (mdl, balance_rows, nonants, pmax)
    return _TEMPLATE_CACHE[key]


def scenario_creator(scenario_name, num_gens=5, horizon=12, num_scens=None,
                     seedoffset=0, relax_integers=False):
    scennum = extract_num(scenario_name)
    mdl, balance_rows, nonants, pmax = _template(
        num_gens, horizon, seedoffset, relax_integers)
    stream = np.random.RandomState(31400 + scennum + seedoffset)
    base = 0.55 * pmax.sum()
    t = np.arange(horizon)
    profile = base * (1.0 + 0.3 * np.sin(2 * np.pi * (t - 3) / 24.0))
    noise = np.cumsum(stream.normal(0.0, 0.03 * base, horizon))
    demand = np.clip(profile + noise, 0.2 * base, 0.95 * pmax.sum())

    cl = mdl.cl.copy()
    cl[balance_rows] = demand
    return dataclasses.replace(
        mdl,
        name=scenario_name,
        cl=cl,
        prob=None if num_scens is None else 1.0 / num_scens,
        nodes=[ScenarioNode("ROOT", 1.0, 1, nonants)],
    )


def scenario_denouement(rank, scenario_name, scenario):
    pass
