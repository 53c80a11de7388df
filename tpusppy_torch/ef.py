"""Extensive-form assembly and solve.

Port of ``tpusppy/ef.py``: each scenario is a sub-block of one problem with a
probability-weighted objective; nonant variables that share a tree node are
merged into one column.  The EF is solved by HiGHS (the validation route) or
by the port's batched ADMM as a batch of one.

Unlike the reference, the EF constraint matrix is assembled as a scipy CSR
matrix: at farmer-1000 with ``crops_multiplier=4`` the dense (28000, 32012)
float64 array would take 7 GB, while HiGHS reads the sparse form anyway.  The
ADMM route densifies it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from .ir import ScenarioBatch
from .solvers import scipy_backend


@dataclasses.dataclass
class EFProblem:
    """Monolithic EF in canonical form, plus the column maps back to scenarios."""

    c: np.ndarray
    q2: np.ndarray
    A: sp.csr_matrix
    cl: np.ndarray
    cu: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    is_int: np.ndarray
    const: float
    col_of: np.ndarray       # (S, n) scenario-var -> EF column
    batch: ScenarioBatch

    def split_solution(self, x_ef: np.ndarray) -> np.ndarray:
        """(S, n) per-scenario solution from an EF solution vector."""
        return x_ef[self.col_of]


def build_ef(batch: ScenarioBatch) -> EFProblem:
    S, n = batch.num_scenarios, batch.num_vars
    tree = batch.tree
    nonant_idx = tree.nonant_indices            # (K,) var slots
    K = nonant_idx.shape[0]

    # one column per (node, nonant slot); leaf vars get a private column per
    # scenario
    col_of = -np.ones((S, n), dtype=np.int64)
    node_slot_col: dict[tuple[int, int], int] = {}
    ncols = 0
    for s in range(S):
        for k in range(K):
            stage = tree.nonant_stage[k]
            node = int(tree.scen_node_ids[s, stage - 1])
            key = (node, k)
            if key not in node_slot_col:
                node_slot_col[key] = ncols
                ncols += 1
            col_of[s, nonant_idx[k]] = node_slot_col[key]
    free = col_of < 0
    col_of[free] = ncols + np.arange(int(free.sum()))
    ncols += int(free.sum())

    probs = batch.probs
    c = np.zeros(ncols)
    q2 = np.zeros(ncols)
    lb = np.full(ncols, -np.inf)
    ub = np.full(ncols, np.inf)
    is_int = np.zeros(ncols, dtype=bool)
    for s in range(S):
        cols = col_of[s]
        np.add.at(c, cols, probs[s] * batch.c[s])
        np.add.at(q2, cols, probs[s] * batch.q2[s])
        lb[cols] = np.maximum(lb[cols], batch.lb[s])
        ub[cols] = np.minimum(ub[cols], batch.ub[s])
        is_int[cols] |= batch.is_int

    m = batch.num_rows
    s_i, r_i, j_i = np.nonzero(batch.A)
    A = sp.csr_matrix(
        (batch.A[s_i, r_i, j_i], (s_i * m + r_i, col_of[s_i, j_i])),
        shape=(S * m, ncols))
    return EFProblem(
        c=c, q2=q2, A=A, cl=batch.cl.reshape(-1).copy(),
        cu=batch.cu.reshape(-1).copy(), lb=lb, ub=ub, is_int=is_int,
        const=float(probs @ batch.const), col_of=col_of, batch=batch,
    )


def solve_ef(batch: ScenarioBatch, solver="highs", mip=True, **kw):
    """Solve the EF; returns (objective, per-scenario solutions (S, n)).

    ``solver='highs'`` is the validation path; ``solver='admm'`` runs the
    port's batched ADMM on the single monolithic problem (``kw`` go to
    :func:`~tpusppy_torch.solvers.admm.solve_single`, e.g. ``settings=``
    and ``device=``)."""
    ef = build_ef(batch)
    if solver == "highs":
        res = scipy_backend.solve_lp(
            ef.c, ef.A, ef.cl, ef.cu, ef.lb, ef.ub,
            is_int=ef.is_int if mip else None, q2=ef.q2, const=ef.const, **kw,
        )
        if not res.feasible:
            raise RuntimeError(f"EF infeasible or solver failure: {res.status}")
        return res.obj, ef.split_solution(res.x)
    if solver == "admm":
        from .solvers import admm

        if mip and np.any(ef.is_int):
            raise NotImplementedError(
                "solver='admm' solves the continuous relaxation only; pass "
                "mip=False explicitly, or use solver='highs' for integer EFs"
            )
        sol = admm.solve_single(
            c=ef.c, q2=ef.q2, A=ef.A.toarray(), cl=ef.cl, cu=ef.cu,
            lb=ef.lb, ub=ef.ub, **kw)
        x = np.asarray(sol.x.detach().cpu(), dtype=float)
        obj = float(ef.c @ x + 0.5 * ef.q2 @ (x * x) + ef.const)
        return obj, ef.split_solution(x)
    raise ValueError(f"unknown EF solver {solver!r}")
