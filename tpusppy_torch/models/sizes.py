"""SIZES: two-stage product-sizing MIP (Lokketangen & Woodruff 1996), in
the tpusppy_torch IR (a copy of ``tpusppy/models/sizes.py`` without the
fixer tuples: the fixer extension is not ported).

Behavioral port of the reference test model
(``mpisppy/tests/examples/sizes/ReferenceModel.py`` +
``sizes.py`` scenario data in ``SIZES3``/``SIZES10``): ten product sizes,
setup + unit production costs, cut-down recycling between sizes, a shared
capacity per stage.  Scenarios differ only in second-stage demands
(0.7/1.0/1.3 times the base demand for the 3-scenario set).

First-stage (nonanticipative) variables: NumProducedFirstStage and
NumUnitsCutFirstStage — matching the reference's ``varlist`` at
``sizes.py:27-29`` (ProduceSizeFirstStage is stage-1 *derived*).
Golden (integer) 3-scenario EF objective: ~224,000 (reference tests round to
220,000 at 2 significant digits); the LP relaxation our batched solver
certifies is a valid lower bound and is cross-checked against HiGHS.
"""

from __future__ import annotations

import numpy as np

from ..ir import LinearModelBuilder
from ..scenario_tree import ScenarioNode, extract_num

NUM_SIZES = 10
CAPACITY = 200000.0
DEMANDS_FIRST = np.array(
    [2500, 7500, 12500, 10000, 35000, 25000, 15000, 12500, 12500, 5000.0]
)
UNIT_COST = np.array(
    [0.748, 0.7584, 0.7688, 0.7792, 0.7896, 0.8, 0.8104, 0.8208, 0.8312,
     0.8416]
)
SETUP_COST = np.full(10, 453.0)
UNIT_REDUCTION_COST = 0.008
# second-stage demand multipliers per scenario (SIZES3/Scenario{1,2,3}.dat)
DEMAND_FACTORS_3 = [0.7, 1.0, 1.3]


def scenario_names_creator(num_scens, start=0):
    # reference names are Scenario1..ScenarioN (1-based)
    return [f"Scenario{i + 1}" for i in range(start, start + num_scens)]


def kw_creator(cfg=None, **kwargs):
    cfg = cfg or {}
    get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: getattr(cfg, k, d)
    # num_scens may arrive as a plain kwarg too (the service registry's
    # calling convention) — it must not be shadowed by the cfg default
    out = {"scenario_count": kwargs.get(
        "scenario_count", kwargs.get("num_scens", get("num_scens", 3)))}
    if "relax_integers" in kwargs:
        out["relax_integers"] = bool(kwargs["relax_integers"])
    return out


def inparser_adder(cfg):
    if "num_scens" not in cfg:
        cfg.num_scens_required()


def _second_stage_demands(scennum: int, scenario_count: int) -> np.ndarray:
    if scenario_count == 3:
        return DEMANDS_FIRST * DEMAND_FACTORS_3[scennum - 1]
    # SIZES10: evenly spread factors around 1.0 (the reference ships ten
    # .dat files; behaviorally a fan of demand levels)
    factors = np.linspace(0.7, 1.3, scenario_count)
    return DEMANDS_FIRST * factors[scennum - 1]


def scenario_creator(scenario_name, scenario_count=3, relax_integers=True):
    scennum = extract_num(scenario_name)
    d1 = DEMANDS_FIRST
    d2 = _second_stage_demands(scennum, scenario_count)
    N = NUM_SIZES

    b = LinearModelBuilder(scenario_name)
    as_int = not relax_integers
    # produce indicators (stage-derived, binary)
    p1 = b.add_vars("ProduceSizeFirstStage", N, lb=0.0, ub=1.0,
                    cost=0.0, integer=as_int)
    p2 = b.add_vars("ProduceSizeSecondStage", N, lb=0.0, ub=1.0,
                    cost=0.0, integer=as_int)
    np1 = b.add_vars("NumProducedFirstStage", N, lb=0.0, ub=CAPACITY,
                     integer=as_int)
    np2 = b.add_vars("NumProducedSecondStage", N, lb=0.0, ub=CAPACITY,
                     integer=as_int)
    # cut variables over (i, j) with i >= j (0-based here)
    cut_pairs = [(i, j) for i in range(N) for j in range(i + 1)]
    c1 = {}
    c2 = {}
    for (i, j) in cut_pairs:
        c1[i, j] = b.add_var(f"NumUnitsCutFirstStage[{i},{j}]", lb=0.0,
                             ub=CAPACITY, integer=as_int)
    for (i, j) in cut_pairs:
        c2[i, j] = b.add_var(f"NumUnitsCutSecondStage[{i},{j}]", lb=0.0,
                             ub=CAPACITY, integer=as_int)

    # costs: setup * produce + unit * produced + reduction * offdiag cuts
    for i in range(N):
        b.set_cost(p1[i], SETUP_COST[i])
        b.set_cost(p2[i], SETUP_COST[i])
        b.set_cost(np1[i], UNIT_COST[i])
        b.set_cost(np2[i], UNIT_COST[i])
    for (i, j) in cut_pairs:
        if i != j:
            b._c[c1[i, j]] = UNIT_REDUCTION_COST
            b._c[c2[i, j]] = UNIT_REDUCTION_COST

    # demand satisfied per size (cuts from larger sizes count)
    for j in range(N):
        b.add_ge({c1[i, j]: 1.0 for i in range(j, N)}, float(d1[j]))
        b.add_ge({c2[i, j]: 1.0 for i in range(j, N)}, float(d2[j]))
    # production forced to zero unless produce flag on
    for i in range(N):
        b.add_le({np1[i]: 1.0, p1[i]: -CAPACITY}, 0.0)
        b.add_le({np2[i]: 1.0, p2[i]: -CAPACITY}, 0.0)
    # stage capacity
    b.add_le({np1[i]: 1.0 for i in range(N)}, CAPACITY)
    b.add_le({np2[i]: 1.0 for i in range(N)}, CAPACITY)
    # inventory: cuts from size i limited by cumulative production of i
    for i in range(N):
        b.add_le({c1[i, j]: 1.0 for j in range(i + 1)} | {np1[i]: -1.0}, 0.0)
        coeffs = {c1[i, j]: 1.0 for j in range(i + 1)}
        for j in range(i + 1):
            coeffs[c2[i, j]] = 1.0
        coeffs[np1[i]] = -1.0
        coeffs[np2[i]] = -1.0
        b.add_le(coeffs, 0.0)

    nonants = np.asarray(np1 + [c1[i, j] for (i, j) in cut_pairs],
                         dtype=np.int32)
    p = b.build()
    p.prob = 1.0 / scenario_count
    p.nodes = [ScenarioNode("ROOT", 1.0, 1, nonants)]
    return p


def scenario_denouement(rank, scenario_name, scenario):
    pass


def _rho_setter(batch, rho_factor=0.001):
    """Per-slot rho from unit costs (sizes.py:38-59): rho for NumProduced is
    RF*unit cost, for cuts RF*reduction cost.  Returns (K,) over the packed
    nonant layout."""
    N = NUM_SIZES
    ncuts = N * (N + 1) // 2
    rho = np.empty(N + ncuts)
    rho[:N] = UNIT_COST * rho_factor
    rho[N:] = UNIT_REDUCTION_COST * rho_factor
    return rho

