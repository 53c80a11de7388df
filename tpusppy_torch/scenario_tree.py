"""Scenario-tree annotations.

Copy of ``tpusppy/scenario_tree.py`` (the analogue of
``mpisppy/scenario_tree.py:44-96``, ``ScenarioNode``) and of the
tree-rebuilding logic in ``mpisppy/utils/sputils.py:675-840`` (``_TreeNode`` /
``_ScenTree``).  Node names encode tree structure textually exactly as in the
reference: ``ROOT``, ``ROOT_0``, ``ROOT_0_1``, ...

Instead of annotating a Pyomo model, a :class:`ScenarioNode` here carries the
*indices into the scenario's flat variable vector* that are nonanticipative at that
node, plus the conditional probability.  The tree as a whole is compiled by
:func:`build_tree` into flat integer arrays (scenario -> node-id per stage) that the
batched PH reductions consume on device.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np


@dataclasses.dataclass
class ScenarioNode:
    """Per-scenario annotation of one nonleaf tree node (cf. scenario_tree.py:44-96).

    Args:
      name: textual node name; parent is everything before the final ``_``.
      cond_prob: probability of this node given its parent.
      stage: 1-based stage number (ROOT is stage 1).
      nonant_indices: indices (into the scenario's flat x) of the nonanticipative
        variables attached to this node.
      cost_coeffs: optional per-variable cost vector for "stage cost" reporting
        (the reference attaches a Pyomo cost *expression*; we keep a linear form).
    """

    name: str
    cond_prob: float
    stage: int
    nonant_indices: np.ndarray
    cost_coeffs: np.ndarray | None = None

    def __post_init__(self):
        self.nonant_indices = np.asarray(self.nonant_indices, dtype=np.int32)
        if self.name != "ROOT" and not re.fullmatch(r"ROOT(_\d+)+", self.name):
            raise ValueError(f"Node name {self.name!r} must be ROOT or ROOT_i_j...")
        if self.name == "ROOT" and self.stage != 1:
            raise ValueError("ROOT must be stage 1")

    @property
    def parent_name(self) -> str | None:
        if self.name == "ROOT":
            return None
        return self.name.rsplit("_", 1)[0]


def attach_root_node(problem, nonant_indices, cost_coeffs=None):
    """Two-stage convenience: attach a single ROOT node (cf. sputils.py:844-860)."""
    problem.nodes = [
        ScenarioNode("ROOT", 1.0, 1, np.asarray(nonant_indices), cost_coeffs)
    ]
    return problem


def create_nodenames_from_branching_factors(branching_factors) -> list:
    """All node names of a balanced tree, leaves included — same semantics as
    the reference's ``sputils.create_nodenames_from_BFs`` (sputils.py:934).
    Callers wanting only nonleaf names drop the last level themselves."""
    names = ["ROOT"]
    frontier = ["ROOT"]
    for bf in branching_factors:
        frontier = [f"{p}_{i}" for p in frontier for i in range(bf)]
        names.extend(frontier)
    return names


def extract_num(name: str) -> int:
    """Scrape trailing digits off a scenario name (cf. sputils.extract_num)."""
    m = re.search(r"(\d+)$", name)
    if m is None:
        raise RuntimeError(f"Could not extract number from scenario name {name!r}")
    return int(m.group(1))


@dataclasses.dataclass
class TreeInfo:
    """Compiled tree structure for a scenario batch.

    Produced by :func:`build_tree`; consumed by the batched nonant reductions
    (the analogue of per-tree-node MPI communicators, spbase.py:333-375).

    Attributes:
      node_names: list of all distinct nonleaf node names, ROOT first,
        lexicographic within a stage; node-id = index into this list.
      node_stage: (N,) stage of each node (1-based).
      scen_node_ids: (S, T-1) int array; scen_node_ids[s, t] is the node-id of
        scenario s's stage-(t+1) node.
      nonant_stage: (n_nonant,) 1-based stage of each nonant slot in the packed
        nonant vector.
      nonant_indices: (n_nonant,) indices into the flat x vector (shared across
        scenarios; ragged models must pad first).
      node_prob: (N,) unconditional probability of each node
        (cf. spbase.py:378 _compute_unconditional_node_probabilities).
      scen_prob: (S,) scenario probabilities.
    """

    node_names: list
    node_stage: np.ndarray
    scen_node_ids: np.ndarray
    nonant_stage: np.ndarray
    nonant_indices: np.ndarray
    node_prob: np.ndarray
    scen_prob: np.ndarray

    @property
    def num_nodes(self) -> int:
        return len(self.node_names)

    @property
    def num_stages(self) -> int:
        return int(self.scen_node_ids.shape[1]) + 1

    @property
    def num_nonants(self) -> int:
        return int(self.nonant_indices.shape[0])

    def nid_sk(self) -> np.ndarray:
        """(S, K) node-id owning each packed nonant slot, per scenario.

        The single source of truth for the node-grouping index used by host PH
        (Compute_Xbar), the sharded jitted step, and EF column merging."""
        S = self.scen_node_ids.shape[0]
        K = self.num_nonants
        return np.take_along_axis(
            self.scen_node_ids,
            np.broadcast_to(self.nonant_stage[None, :] - 1, (S, K)),
            axis=1,
        ).astype(np.int32)

    def onehot_sk_n(self) -> np.ndarray:
        """(S, K, N) one-hot of :meth:`nid_sk` — the matmul form of per-node
        sub-communicators (replaces one Allreduce per node, phbase.py:75-87)."""
        nid = self.nid_sk()
        S, K = nid.shape
        oh = np.zeros((S, K, self.num_nodes))
        oh[np.arange(S)[:, None], np.arange(K)[None, :], nid] = 1.0
        return oh

    def membership_matrix(self) -> np.ndarray:
        """(N, S) 0/1 node-membership over scenarios, any stage.

        M[n, s] = 1 iff scenario s passes through node n.  Used to build the
        weighted node-averaging matmul that replaces per-node Allreduce
        (phbase.py:75-87).
        """
        S, Tm1 = self.scen_node_ids.shape
        M = np.zeros((self.num_nodes, S), dtype=np.float64)
        for s in range(S):
            for t in range(Tm1):
                M[self.scen_node_ids[s, t], s] = 1.0
        return M


def build_tree(problems) -> TreeInfo:
    """Compile per-scenario node lists into flat arrays.

    ``problems`` is a sequence with ``.nodes`` (list of :class:`ScenarioNode`) and
    ``.prob``.  Validates the same invariants the reference checks at
    spbase.py:150-176 (consistent nonant layouts) and spbase.py:457-502
    (probabilities summing to 1 node-by-node).
    """
    S = len(problems)
    num_stages = len(problems[0].nodes) + 1
    for p in problems:
        if len(p.nodes) != num_stages - 1:
            raise ValueError("All scenarios must have the same number of stages")

    # Collect distinct node names per stage.
    names_by_stage = [dict() for _ in range(num_stages - 1)]  # name -> cond_prob
    for p in problems:
        for t, nd in enumerate(p.nodes):
            if nd.stage != t + 1:
                raise ValueError(
                    f"Node {nd.name} stage {nd.stage} != position {t + 1}"
                )
            prev = names_by_stage[t].setdefault(nd.name, nd.cond_prob)
            if abs(prev - nd.cond_prob) > 1e-12:
                raise ValueError(f"Inconsistent cond_prob for node {nd.name}")

    node_names, node_stage, node_cond = [], [], []
    for t in range(num_stages - 1):
        for name in sorted(names_by_stage[t]):
            node_names.append(name)
            node_stage.append(t + 1)
            node_cond.append(names_by_stage[t][name])
    node_id = {name: i for i, name in enumerate(node_names)}

    # Unconditional node probabilities: product of cond_probs down the path.
    node_prob = np.zeros(len(node_names))
    for i, name in enumerate(node_names):
        p = node_cond[i]
        parent = node_names[i].rsplit("_", 1)[0] if name != "ROOT" else None
        while parent is not None:
            p *= node_cond[node_id[parent]]
            parent = parent.rsplit("_", 1)[0] if parent != "ROOT" else None
        node_prob[i] = p

    scen_node_ids = np.zeros((S, num_stages - 1), dtype=np.int32)
    for s, p in enumerate(problems):
        for t, nd in enumerate(p.nodes):
            scen_node_ids[s, t] = node_id[nd.name]

    # Packed nonant layout: stage-1 slots, then stage-2 slots, ... ; the reference
    # requires identical nonant lengths across scenarios of a node (spbase.py:150).
    ref_nodes = problems[0].nodes
    nonant_indices = np.concatenate(
        [nd.nonant_indices for nd in ref_nodes]
    ).astype(np.int32)
    nonant_stage = np.concatenate(
        [np.full(len(nd.nonant_indices), nd.stage, dtype=np.int32) for nd in ref_nodes]
    )
    for p in problems:
        flat = np.concatenate([nd.nonant_indices for nd in p.nodes])
        if not np.array_equal(flat, nonant_indices):
            raise ValueError(
                "All scenarios must use the same nonant variable slots per stage "
                "(pad ragged models before building the batch)"
            )

    scen_prob = np.array([p.prob for p in problems], dtype=np.float64)
    if np.any(scen_prob < 0):
        raise ValueError("negative scenario probability")
    tot = scen_prob.sum()
    if abs(tot - 1.0) > 1e-9:
        raise ValueError(f"scenario probabilities sum to {tot}, not 1")

    return TreeInfo(
        node_names=node_names,
        node_stage=np.asarray(node_stage, dtype=np.int32),
        scen_node_ids=scen_node_ids,
        nonant_stage=nonant_stage,
        nonant_indices=nonant_indices,
        node_prob=node_prob,
        scen_prob=scen_prob,
    )
