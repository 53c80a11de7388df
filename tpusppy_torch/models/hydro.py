"""Three-stage hydro-thermal scheduling model in the tpusppy_torch IR
(a copy of ``tpusppy/models/hydro.py``).

Mirrors the semantics of the reference's multistage test model
(`mpisppy/tests/examples/hydro/hydro.py` + `PySP/scenariodata/*.dat`): three
periods, thermal generation Pgt, hydro generation Pgh, unserved demand PDns,
reservoir volume Vol, and a terminal water-value variable sl.  Scenarios branch
on inflows: stage-2 inflow in {10, 50, 90} and stage-3 inflow in {40, 50, 60}
under branching factors [3, 3] (9 scenarios, named Scen1..Scen9, 1-based).

Golden values (tests/test_ef_ph.py:545-646): EF objective rounds to 190 at two
significant digits; PH trivial bound rounds to 180; Scen7 Pgt[2] rounds to 60.
"""

import numpy as np

from ..ir import LinearModelBuilder
from ..scenario_tree import ScenarioNode, extract_num

T_PERIODS = 3
DEMAND = np.array([90.0, 160.0, 110.0])
BETA_GT = 1.0
BETA_GH = 0.0
BETA_DNS = 10.0
PGT_MAX = 100.0
PGH_MAX = 100.0
V_MAX = 100.0
U = np.array([0.6048, 0.6048, 1.2096])       # conversion factor per period
DURATION = np.array([168.0, 168.0, 336.0])
V0 = 60.48
T_HORIZON = 8760.0
WATER_VALUE = 4166.67                        # terminal value-of-water slope
INFLOW_STAGE1 = 50.0
INFLOW_STAGE2 = np.array([10.0, 50.0, 90.0])  # branch b -> inflow
INFLOW_STAGE3 = np.array([40.0, 50.0, 60.0])

# discount factor per period: (1/1.1)^(duration/T)
DISCOUNT = (1.0 / 1.1) ** (DURATION / T_HORIZON)


def scenario_names_creator(num_scens, start=0):
    """1-based names, matching the reference's Scen1..ScenN convention."""
    return [f"Scen{i + 1}" for i in range(start, start + num_scens)]


def scenario_denouement(rank, scenario_name, scenario):
    pass


def kw_creator(cfg=None, **kwargs):
    cfg = cfg or {}
    get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: getattr(cfg, k, d)
    return {
        "branching_factors": kwargs.get(
            "branching_factors", get("branching_factors", [3, 3])
        ),
    }


def inparser_adder(cfg):
    cfg.add_branching_factors()


def scenario_creator(scenario_name, branching_factors=None, data_path=None):
    """Build one hydro scenario as a ScenarioProblem.

    Variable layout: for t in 0..2: Pgt[t], Pgh[t], PDns[t], Vol[t]; then sl.
    Stage-t cost folded onto variables: r[t]*(betaGt*Pgt + betaDns*PDns) with
    the terminal water value sl added at stage 3.
    """
    if branching_factors is None:
        branching_factors = [3, 3]
    b1, b2 = branching_factors
    if b1 > len(INFLOW_STAGE2) or b2 > len(INFLOW_STAGE3):
        raise ValueError(
            f"hydro has {len(INFLOW_STAGE2)}x{len(INFLOW_STAGE3)} inflow "
            f"realizations; branching_factors {branching_factors} unsupported"
        )
    snum = extract_num(scenario_name)             # 1-based
    branch = (snum - 1) // b2                     # stage-2 node index
    leaf = (snum - 1) % b2                        # stage-3 branch index

    inflow = np.array([
        INFLOW_STAGE1,
        INFLOW_STAGE2[branch],
        INFLOW_STAGE3[leaf],
    ])

    b = LinearModelBuilder(scenario_name)
    pgt, pgh, pdns, vol = [], [], [], []
    for t in range(T_PERIODS):
        pgt.append(b.add_var(f"Pgt[{t + 1}]", lb=0.0, ub=PGT_MAX,
                             cost=DISCOUNT[t] * BETA_GT))
        pgh.append(b.add_var(f"Pgh[{t + 1}]", lb=0.0, ub=PGH_MAX,
                             cost=DISCOUNT[t] * BETA_GH))
        pdns.append(b.add_var(f"PDns[{t + 1}]", lb=0.0, ub=DEMAND[t],
                              cost=DISCOUNT[t] * BETA_DNS))
        vol.append(b.add_var(f"Vol[{t + 1}]", lb=0.0, ub=V_MAX))
    sl = b.add_var("sl", lb=0.0, cost=1.0)

    for t in range(T_PERIODS):
        # demand balance: Pgt + Pgh + PDns == D[t]
        b.add_eq({pgt[t]: 1.0, pgh[t]: 1.0, pdns[t]: 1.0}, DEMAND[t])
        # volume conservation: Vol[t] - Vol[t-1] + u[t]*Pgh[t] <= u[t]*A[t]
        coeffs = {vol[t]: 1.0, pgh[t]: U[t]}
        rhs = U[t] * inflow[t]
        if t == 0:
            rhs += V0
        else:
            coeffs[vol[t - 1]] = -1.0
        b.add_le(coeffs, rhs)
    # future cost of empty reservoir: sl >= WATER_VALUE * (V0 - Vol[T])
    b.add_ge({sl: 1.0, vol[-1]: WATER_VALUE}, WATER_VALUE * V0)

    p = b.build()
    p.prob = 1.0 / (b1 * b2)
    stage_vars = lambda t: np.asarray(
        [pgt[t], pgh[t], pdns[t], vol[t]], dtype=np.int32
    )
    p.nodes = [
        ScenarioNode("ROOT", 1.0, 1, stage_vars(0)),
        ScenarioNode(f"ROOT_{branch}", 1.0 / b1, 2, stage_vars(1)),
    ]
    return p
