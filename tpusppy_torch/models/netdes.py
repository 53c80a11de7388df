"""NETDES: stochastic network design, in the tpusppy_torch IR (a copy of
``tpusppy/models/netdes.py``, the same seeds and streams).

Behavioral port of ``examples/netdes/netdes.py``: first stage opens arcs
(binary, per-arc cost), second stage routes flow on open arcs (variable upper
bound y_e <= u_e x_e) to satisfy per-node net-demand balances that vary by
scenario.

The reference reads ``.dat`` instances from ``examples/netdes/data``; here a
seeded generator builds a random strongly-connected digraph with one source /
one sink whose demand scales per scenario.
"""

from __future__ import annotations

import numpy as np

from ..ir import LinearModelBuilder
from ..scenario_tree import ScenarioNode, extract_num


def scenario_names_creator(num_scens, start=0):
    return [f"Scenario{i}" for i in range(start, start + num_scens)]


def kw_creator(cfg=None, **kwargs):
    cfg = cfg or {}
    get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: getattr(cfg, k, d)
    return {
        "num_nodes": kwargs.get("num_nodes", get("netdes_nodes", 10)),
        "num_scens": kwargs.get("num_scens", get("num_scens")),
        "seedoffset": kwargs.get("seedoffset", get("seedoffset", 0)),
        "relax_integers": kwargs.get("relax_integers",
                                     get("relax_integers", True)),
    }


def inparser_adder(cfg):
    if "num_scens" not in cfg:
        cfg.num_scens_required()
    cfg.add_to_config("netdes_nodes", "number of network nodes", int, 10)


def _instance(num_nodes, seedoffset):
    """Digraph with a ring (connectivity) + random chords; per-edge costs and
    capacities."""
    stream = np.random.RandomState(777 + seedoffset)
    edges = [(i, (i + 1) % num_nodes) for i in range(num_nodes)]
    extra = max(num_nodes, int(1.5 * num_nodes))
    while len(edges) < num_nodes + extra:
        i, j = stream.randint(0, num_nodes, 2)
        if i != j and (i, j) not in edges:
            edges.append((int(i), int(j)))
    c = stream.randint(20, 60, len(edges)).astype(float)    # open cost
    d = stream.randint(1, 10, len(edges)).astype(float)     # flow cost
    u = stream.randint(8, 20, len(edges)).astype(float)     # capacity
    return edges, c, d, u


def scenario_creator(scenario_name, num_nodes=10, num_scens=None,
                     seedoffset=0, relax_integers=True):
    scennum = extract_num(scenario_name)
    edges, c, d, u = _instance(num_nodes, seedoffset)
    stream = np.random.RandomState(1000 + scennum + seedoffset)
    # source node 0 ships to sink node num_nodes//2; demand varies by scenario
    demand = float(stream.randint(5, 15))
    bvec = np.zeros(num_nodes)
    bvec[0] = demand
    bvec[num_nodes // 2] = -demand

    as_int = not relax_integers
    b = LinearModelBuilder(scenario_name)
    x = [b.add_var(f"x[{i},{j}]", lb=0.0, ub=1.0, cost=c[e], integer=as_int)
         for e, (i, j) in enumerate(edges)]
    y = [b.add_var(f"y[{i},{j}]", lb=0.0, cost=d[e])
         for e, (i, j) in enumerate(edges)]

    for e in range(len(edges)):
        b.add_le({y[e]: 1.0, x[e]: -u[e]}, 0.0)       # vub: y <= u x
    for node in range(num_nodes):
        coeffs = {}
        for e, (i, j) in enumerate(edges):
            if i == node:
                coeffs[y[e]] = coeffs.get(y[e], 0.0) + 1.0
            if j == node:
                coeffs[y[e]] = coeffs.get(y[e], 0.0) - 1.0
        b.add_eq(coeffs, float(bvec[node]))           # flow balance

    prob = None if num_scens is None else 1.0 / num_scens
    p = b.build()
    p.prob = prob
    p.nodes = [ScenarioNode("ROOT", 1.0, 1, np.asarray(x, dtype=np.int32))]
    return p


def scenario_denouement(rank, scenario_name, scenario):
    pass
