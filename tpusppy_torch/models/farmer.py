"""Scalable farmer model (Birge & Louveaux) in the tpusppy_torch IR
(a copy of ``tpusppy/models/farmer.py``).

Mirrors the reference's scalable farmer (`mpisppy/tests/examples/farmer.py`,
`examples/farmer/farmer.py`): three crops (wheat, corn, sugar beets) times
``crops_multiplier``; yields scale by 0.8/1.0/1.2 for Below/Average/Above
scenarios (scennum % 3), with a reproducible random perturbation for scenario
groups beyond the first three.  The classic 3-scenario EF optimum is -108390.

Exports the module protocol the Amalgamator expects (amalgamator.py:123-135):
``scenario_creator``, ``scenario_names_creator``, ``inparser_adder``,
``kw_creator``.
"""

import numpy as np

from ..ir import LinearModelBuilder
from ..scenario_tree import ScenarioNode, extract_num

# Base data (per crop triple): wheat, corn, sugar beets.
TOTAL_ACREAGE = 500.0
PRICE_QUOTA = np.array([170.0, 150.0, 36.0])
PRICE_SUPER = np.array([0.0, 0.0, 10.0])        # beets above quota
PURCHASE_PRICE = np.array([238.0, 210.0, 1e12])  # beets cannot be purchased
QUOTA = np.array([np.inf, np.inf, 6000.0])
REQUIREMENT = np.array([200.0, 240.0, 0.0])
PLANTING_COST = np.array([150.0, 230.0, 260.0])
MEAN_YIELD = np.array([2.5, 3.0, 20.0])
YIELD_FACTOR = {0: 0.8, 1: 1.0, 2: 1.2}  # Below / Average / Above


def scenario_names_creator(num_scens, start=0):
    return [f"scen{i}" for i in range(start, start + num_scens)]


def kw_creator(cfg=None, **kwargs):
    """Map config to scenario_creator kwargs (cf. farmer.py kw_creator)."""
    cfg = cfg or {}
    get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: getattr(cfg, k, d)
    return {
        "use_integer": kwargs.get("use_integer", get("use_integer", False)),
        "crops_multiplier": kwargs.get(
            "crops_multiplier", get("crops_multiplier", 1)
        ),
        "num_scens": kwargs.get("num_scens", get("num_scens", None)),
        "seedoffset": kwargs.get("seedoffset", get("seedoffset", 0)),
    }


def scenario_denouement(rank, scenario_name, scenario):
    pass


def inparser_adder(cfg):
    if "num_scens" not in cfg:
        cfg.num_scens_required()
    cfg.add_to_config("crops_multiplier", description="farmer crop multiplier",
                      domain=int, default=1)
    cfg.add_to_config("use_integer", description="integer acreage",
                      domain=bool, default=False)


def scenario_creator(scenario_name, use_integer=False, crops_multiplier=1,
                     num_scens=None, seedoffset=0):
    """Build one farmer scenario as a ScenarioProblem.

    Variable layout per crop group g (crops_multiplier groups of 3 crops):
      x[3g:3g+3]   acres planted          (stage 1, nonanticipative)
      w[..]        tons sold at quota price
      e[..]        tons sold above quota (beets)
      y[..]        tons purchased (wheat/corn only)
    """
    scennum = extract_num(scenario_name)
    basenum = scennum % 3
    groupnum = scennum // 3
    stream = np.random.RandomState(scennum + seedoffset)

    ncrops = 3 * crops_multiplier
    factor = YIELD_FACTOR[basenum]
    # Group 0 is the classic deterministic triple; later groups get a
    # reproducible perturbation, mirroring the reference's use of a seeded
    # stream so scenarios differ beyond the first three.
    yields = np.tile(MEAN_YIELD, crops_multiplier) * factor
    if groupnum > 0:
        yields = yields * (1.0 + 0.1 * stream.uniform(-1.0, 1.0, size=ncrops))

    b = LinearModelBuilder(scenario_name)
    xi, wi, ei, yi = [], [], [], []
    for k in range(ncrops):
        crop = k % 3
        xi.append(
            b.add_var(f"x[{k}]", lb=0.0, ub=TOTAL_ACREAGE * crops_multiplier,
                      cost=PLANTING_COST[crop], integer=use_integer)
        )
    for k in range(ncrops):
        crop = k % 3
        wi.append(b.add_var(f"w[{k}]", lb=0.0, cost=-PRICE_QUOTA[crop]))
        ei.append(b.add_var(f"e[{k}]", lb=0.0, cost=-PRICE_SUPER[crop]))
        if PURCHASE_PRICE[crop] < 1e11:
            yi.append(b.add_var(f"y[{k}]", lb=0.0, cost=PURCHASE_PRICE[crop]))
        else:
            yi.append(None)

    # sum of acreage within each multiplier group <= 500
    for g in range(crops_multiplier):
        b.add_le({xi[3 * g + j]: 1.0 for j in range(3)}, TOTAL_ACREAGE)
    for k in range(ncrops):
        crop = k % 3
        # yield*x + y - w - e >= requirement  (balance)
        coeffs = {xi[k]: yields[k], wi[k]: -1.0, ei[k]: -1.0}
        if yi[k] is not None:
            coeffs[yi[k]] = 1.0
        b.add_ge(coeffs, REQUIREMENT[crop])
        # quota on favorable-price sales
        if np.isfinite(QUOTA[crop]):
            b.add_le({wi[k]: 1.0}, QUOTA[crop])
        else:
            # only beets may be sold above quota
            b.add_eq({ei[k]: 1.0}, 0.0)

    prob = None if num_scens is None else 1.0 / num_scens
    p = b.build()
    p.prob = prob
    p.nodes = [
        ScenarioNode("ROOT", 1.0, 1, np.asarray(xi, dtype=np.int32),
                     cost_coeffs=None)
    ]
    return p
