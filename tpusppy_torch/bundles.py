"""Scenario bundling: scenario groups merged into per-bundle EF subproblems.

Port of ``tpusppy/bundles.py`` (the analogue of the reference's
``_assign_bundles`` and ``FormEF``): a bundle is one
:class:`~tpusppy_torch.ir.ScenarioProblem`, the extensive form of its member
scenarios under their probabilities conditional on the bundle, so the
batched solver sees fewer, larger subproblems.

Two-stage families bundle contiguous slices (``np.array_split``: uneven
counts give bundles of two sizes, a ragged family).  Multistage families
form *proper* bundles: each consumes whole second-stage subtrees, so every
inner-stage nonanticipativity lives inside one bundle's EF (its merged
columns), and only the root nonants stay exposed: the bundled problem is
two-stage to PH.

The port's :func:`~tpusppy_torch.ef.build_ef` returns a scipy CSR ``A``;
a bundle's is densified here, one bundle at a time (a ``ScenarioProblem``
carries a dense ``A``).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .ef import build_ef
from .ir import ScenarioBatch, ScenarioProblem
from .scenario_tree import ScenarioNode


def _stage2_group_size(problems) -> int:
    """Scenarios per second-stage subtree (contiguous by construction)."""
    names = [p.nodes[1].name for p in problems]
    sizes = {}
    for nm in names:
        sizes[nm] = sizes.get(nm, 0) + 1
    if len(set(sizes.values())) != 1:
        raise ValueError(
            f"uneven second-stage subtrees {sizes}; proper bundles need "
            "uniform branching")
    size = next(iter(sizes.values()))
    for i in range(0, len(names), size):
        if len(set(names[i:i + size])) != 1:
            raise ValueError(
                "scenario order is not subtree-contiguous; cannot form "
                "proper bundles")
    return size


def form_bundles(problems, num_bundles: int) -> list:
    """``num_bundles`` bundle ScenarioProblems from ``problems``: contiguous
    slices, or for a multistage family proper bundles of whole
    second-stage subtrees.  Each bundle's probability is its members' sum,
    and its one node is ROOT with the root nonant columns, which the
    bundle EF puts first (columns ``0 .. K_root - 1``)."""
    S = len(problems)
    if num_bundles <= 0 or num_bundles > S:
        raise ValueError(f"num_bundles={num_bundles} out of range for {S}")
    if any(p.prob is None for p in problems):
        problems = [dataclasses.replace(p, prob=1.0 / S) for p in problems]

    stage_counts = {len(p.nodes) for p in problems}
    if len(stage_counts) != 1:
        # a mixed list sliced naively could cut subtrees across bundle
        # boundaries and drop inner-stage nonanticipativity unseen
        raise ValueError(
            f"scenarios disagree on stage structure ({stage_counts} node "
            "counts); cannot bundle")
    multistage = len(problems[0].nodes) > 1
    if multistage:
        gsz = _stage2_group_size(problems)
        n_groups = S // gsz
        if num_bundles > n_groups or n_groups % num_bundles != 0:
            raise ValueError(
                f"proper bundles must consume entire second-stage subtrees: "
                f"{n_groups} subtrees of {gsz} scenarios cannot split into "
                f"{num_bundles} bundles")
        per = (n_groups // num_bundles) * gsz
        slices = [np.arange(b * per, (b + 1) * per)
                  for b in range(num_bundles)]
    else:
        slices = np.array_split(np.arange(S), num_bundles)
    bundles = []
    for bnum, sl in enumerate(slices):
        members = [problems[i] for i in sl]
        bprob = sum(p.prob for p in members)
        cond = [dataclasses.replace(p, prob=p.prob / bprob) for p in members]
        sub = ScenarioBatch.from_problems(cond)
        ef = build_ef(sub)
        K_root = int((sub.tree.nonant_stage == 1).sum())
        name = (f"bundle_{bnum}" if not multistage
                else f"Bundle_{int(sl[0])}_{int(sl[-1])}")
        bundles.append(ScenarioProblem(
            name=name, c=ef.c, q2=ef.q2, A=ef.A.toarray(), cl=ef.cl,
            cu=ef.cu, lb=ef.lb, ub=ef.ub, is_int=ef.is_int, prob=bprob,
            nodes=[ScenarioNode("ROOT", 1.0, 1,
                                np.arange(K_root, dtype=np.int32))],
            var_names=None, const=ef.const))
    return bundles
