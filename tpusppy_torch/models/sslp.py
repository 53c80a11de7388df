"""SSLP: stochastic server location problem (Ntaimo & Sen), in the
tpusppy_torch IR (a copy of ``tpusppy/models/sslp.py`` without the fixer
tuples: the fixer extension is not ported).

Behavioral port of ``examples/sslp/model/ReferenceModel.py`` +
``examples/sslp/sslp.py``: first stage opens servers (binary, fixed cost);
second stage assigns present clients to open servers for revenue, with server
capacity and an overflow Dummy at high penalty.  Client presence is the
scenario randomness.

The reference reads SIPLIB ``.dat`` instances (``sslp_15_45_5`` etc.); here
instances are generated from a seeded stream with the same shape — pass
``num_servers``/``num_clients`` mirroring the instance-name convention
(sslp_<servers>_<clients>_<scens>).
"""

from __future__ import annotations

import numpy as np

from ..ir import LinearModelBuilder
from ..scenario_tree import ScenarioNode, extract_num

PENALTY = 1000.0


def scenario_names_creator(num_scens, start=0):
    return [f"Scenario{i + 1}" for i in range(start, start + num_scens)]


def kw_creator(cfg=None, **kwargs):
    cfg = cfg or {}
    get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: getattr(cfg, k, d)
    return {
        "num_servers": kwargs.get("num_servers", get("sslp_num_servers", 5)),
        "num_clients": kwargs.get("num_clients", get("sslp_num_clients", 15)),
        "seedoffset": kwargs.get("seedoffset", get("seedoffset", 0)),
        "relax_integers": kwargs.get("relax_integers",
                                     get("relax_integers", True)),
    }


def inparser_adder(cfg):
    if "num_scens" not in cfg:
        cfg.num_scens_required()
    cfg.add_to_config("sslp_num_servers", "number of servers", int, 5)
    cfg.add_to_config("sslp_num_clients", "number of clients", int, 15)


def _instance_data(num_servers, num_clients, seedoffset):
    """Deterministic instance-wide data (demands, costs, revenues) shared by
    all scenarios; SIPLIB-shaped magnitudes."""
    stream = np.random.RandomState(90210 + seedoffset)
    demand = stream.randint(1, 10, size=(num_clients, num_servers)).astype(
        float)
    fixed_cost = stream.randint(40, 80, size=num_servers).astype(float)
    revenue = stream.randint(1, 10, size=(num_clients, num_servers)).astype(
        float)
    capacity = float(demand.mean() * num_clients / max(1, num_servers // 2))
    return demand, fixed_cost, revenue, capacity


def scenario_creator(scenario_name, num_servers=5, num_clients=15,
                     seedoffset=0, relax_integers=True):
    scennum = extract_num(scenario_name)
    demand, fixed_cost, revenue, capacity = _instance_data(
        num_servers, num_clients, seedoffset)
    stream = np.random.RandomState(scennum + seedoffset)
    present = (stream.rand(num_clients) < 0.5).astype(float)

    as_int = not relax_integers
    b = LinearModelBuilder(scenario_name)
    x = b.add_vars("FacilityOpen", num_servers, lb=0.0, ub=1.0,
                   integer=as_int)
    for j in range(num_servers):
        b.set_cost(x[j], fixed_cost[j])
    y = {}
    for i in range(num_clients):
        for j in range(num_servers):
            y[i, j] = b.add_var(f"Allocation[{i},{j}]", lb=0.0, ub=1.0,
                                cost=-revenue[i, j], integer=as_int)
    dummy = b.add_vars("Dummy", num_servers, lb=0.0, cost=PENALTY)

    for j in range(num_servers):
        coeffs = {y[i, j]: demand[i, j] for i in range(num_clients)}
        coeffs[dummy[j]] = -1.0
        coeffs[x[j]] = -capacity
        b.add_le(coeffs, 0.0)
    for i in range(num_clients):
        b.add_eq({y[i, j]: 1.0 for j in range(num_servers)},
                 float(present[i]))

    p = b.build()
    p.nodes = [ScenarioNode("ROOT", 1.0, 1, np.asarray(x, dtype=np.int32))]
    return p


def scenario_denouement(rank, scenario_name, scenario):
    pass

