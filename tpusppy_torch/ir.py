"""Scenario-problem intermediate representation (IR).

A copy of ``tpusppy/ir.py`` trimmed to what the port uses: the row-wise
:class:`LinearModelBuilder`, one scenario as a :class:`ScenarioProblem`, and a
stacked :class:`ScenarioBatch`.  Each scenario is a dense record in the
canonical conic-box form of first-order LP/QP solvers (OSQP style):

    minimize    0.5 * x' diag(q2) x + c' x  (+ const)
    subject to  cl <= A x <= cu
                lb <=   x <= ub
                x[i] integer for is_int[i]

Equality rows are cl == cu; one-sided rows use +/-inf.  The batch is host
numpy; the solvers move what they need to the device.  A family whose
scenarios all carry the SAME constraint-matrix object (uncertainty in costs,
rhs and bounds only) is detected as shared: the batch keeps the one (m, n)
matrix in ``A_shared`` and ``A`` is a zero-copy broadcast view of it.  A
ragged family (uneven bundles) may be shape-bucketed instead of padded to
its widest member: a :class:`BucketedBatch` holds one compact
``ScenarioBatch`` per (quantized) shape and the 2-D bookkeeping arrays
padded to the family maximum.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .scenario_tree import ScenarioNode, TreeInfo, build_tree

__all__ = ["INF", "BucketedBatch", "LinearModelBuilder", "ScenarioBatch",
           "ScenarioNode", "ScenarioProblem"]

INF = np.inf


class LinearModelBuilder:
    """Tiny row-wise builder so model files read declaratively.

    Declare variables with bounds and costs, then add rows
    ``cl <= sum coef*var <= cu``.  Produces a :class:`ScenarioProblem`.
    """

    def __init__(self, name: str):
        self.name = name
        self._varnames: list[str] = []
        self._lb: list[float] = []
        self._ub: list[float] = []
        self._c: list[float] = []
        self._q2: list[float] = []
        self._is_int: list[bool] = []
        self._rows: list[tuple[dict, float, float]] = []
        self.nodes: list[ScenarioNode] = []
        self.prob: float | None = None
        self.const: float = 0.0

    def add_var(self, name, lb=0.0, ub=INF, cost=0.0, quad=0.0, integer=False) -> int:
        """Declare a variable; returns its flat index."""
        if name in self._varnames:
            raise ValueError(f"duplicate variable {name}")
        self._varnames.append(name)
        self._lb.append(float(lb))
        self._ub.append(float(ub))
        self._c.append(float(cost))
        self._q2.append(float(quad))
        self._is_int.append(bool(integer))
        return len(self._varnames) - 1

    def add_vars(self, prefix, k, **kw) -> list[int]:
        return [self.add_var(f"{prefix}[{i}]", **kw) for i in range(k)]

    def add_row(self, coeffs: dict, cl=-INF, cu=INF):
        """Add constraint cl <= sum_j coeffs[j]*x_j <= cu (indices or names)."""
        idx = {
            (self._varnames.index(k) if isinstance(k, str) else int(k)): float(v)
            for k, v in coeffs.items()
        }
        self._rows.append((idx, float(cl), float(cu)))

    def add_eq(self, coeffs, rhs):
        self.add_row(coeffs, rhs, rhs)

    def add_le(self, coeffs, rhs):
        self.add_row(coeffs, -INF, rhs)

    def add_ge(self, coeffs, rhs):
        self.add_row(coeffs, rhs, INF)

    def set_cost(self, var, cost):
        i = self._varnames.index(var) if isinstance(var, str) else int(var)
        self._c[i] = float(cost)

    def build(self) -> "ScenarioProblem":
        n = len(self._varnames)
        m = len(self._rows)
        A = np.zeros((m, n))
        cl = np.zeros(m)
        cu = np.zeros(m)
        for r, (coeffs, lo, hi) in enumerate(self._rows):
            for j, v in coeffs.items():
                A[r, j] = v
            cl[r], cu[r] = lo, hi
        return ScenarioProblem(
            name=self.name,
            c=np.asarray(self._c),
            q2=np.asarray(self._q2),
            A=A,
            cl=cl,
            cu=cu,
            lb=np.asarray(self._lb),
            ub=np.asarray(self._ub),
            is_int=np.asarray(self._is_int, dtype=bool),
            prob=self.prob,
            nodes=list(self.nodes),
            var_names=list(self._varnames),
            const=self.const,
        )


@dataclasses.dataclass
class ScenarioProblem:
    """One scenario in canonical form (host-side, numpy)."""

    name: str
    c: np.ndarray          # (n,)
    q2: np.ndarray         # (n,) diagonal of the quadratic term (0 => LP)
    A: np.ndarray          # (m, n)
    cl: np.ndarray         # (m,)
    cu: np.ndarray         # (m,)
    lb: np.ndarray         # (n,)
    ub: np.ndarray         # (n,)
    is_int: np.ndarray     # (n,) bool
    prob: float | None     # None => uniform (spbase.py:505-520)
    nodes: list            # list[ScenarioNode], stage order
    var_names: list | None = None
    const: float = 0.0     # objective constant

    @property
    def num_vars(self) -> int:
        return int(self.c.shape[0])

    @property
    def num_rows(self) -> int:
        return int(self.A.shape[0])

    def nonant_indices(self) -> np.ndarray:
        return np.concatenate([nd.nonant_indices for nd in self.nodes])


def _pad_problem(p: ScenarioProblem, n: int, m: int) -> ScenarioProblem:
    """Pad a scenario to (n vars, m rows) with inert slots (fixed-at-0 vars,
    0 <= 0 <= 0 rows) so ragged families stack into one batch."""
    dn, dm = n - p.num_vars, m - p.num_rows
    if dn == 0 and dm == 0:
        return p
    return dataclasses.replace(
        p,
        c=np.pad(p.c, (0, dn)),
        q2=np.pad(p.q2, (0, dn)),
        A=np.pad(p.A, ((0, dm), (0, dn))),
        cl=np.pad(p.cl, (0, dm)),
        cu=np.pad(p.cu, (0, dm)),
        lb=np.pad(p.lb, (0, dn)),
        ub=np.pad(p.ub, (0, dn)),
        is_int=np.pad(p.is_int, (0, dn)),
        var_names=None if p.var_names is None else p.var_names + [f"_pad{i}" for i in range(dn)],
    )


@dataclasses.dataclass
class ScenarioBatch:
    """A stacked batch of scenarios + compiled tree info: arrays of shape
    (S, ...) ready for batched solves and node-grouped reductions."""

    names: list
    c: np.ndarray          # (S, n)
    q2: np.ndarray         # (S, n)
    A: np.ndarray          # (S, m, n) — a zero-copy broadcast view when shared
    cl: np.ndarray         # (S, m)
    cu: np.ndarray         # (S, m)
    lb: np.ndarray         # (S, n)
    ub: np.ndarray         # (S, n)
    is_int: np.ndarray     # (n,) bool (shared across scenarios)
    const: np.ndarray      # (S,)
    tree: TreeInfo
    var_names: list | None = None  # (n,) shared column names, if known
    # mutation counter: bump after ANY in-place edit of the arrays above so
    # cached solver factorizations keyed on it (SPOpt._solve_sig) invalidate
    version: int = 0
    # The shared constraint matrix (m, n), set when every scenario carries
    # the SAME A object (model creators opt in by reusing one numpy array,
    # as uc_lite's template cache does).  ``A`` is then a read-only
    # broadcast view, and solves dispatch to the shared-A engine
    # (tpusppy_torch.solvers.shared_admm) with ONE (n, n) factorization.
    A_shared: np.ndarray | None = None

    @classmethod
    def from_problems(cls, problems: list[ScenarioProblem]) -> "ScenarioBatch":
        probs = [p.prob for p in problems]
        if all(pr is None for pr in probs):
            # uniform default, as spbase.py:505-520
            problems = [
                dataclasses.replace(p, prob=1.0 / len(problems)) for p in problems
            ]
        elif any(pr is None for pr in probs):
            raise ValueError("either all or no scenarios may carry a probability")

        n = max(p.num_vars for p in problems)
        m = max(p.num_rows for p in problems)
        # identity-shared A, detected before padding (a shared family has
        # one shape, so padding never applies to it)
        A0 = problems[0].A
        a_shared = all(p.A is A0 for p in problems)
        problems = [_pad_problem(p, n, m) for p in problems]

        tree = build_tree(problems)
        is_int = problems[0].is_int
        for p in problems:
            if not np.array_equal(p.is_int, is_int):
                raise ValueError("integer pattern must match across scenarios")
        # Column names are only meaningful if every scenario agrees.
        var_names = problems[0].var_names
        if any(p.var_names != var_names for p in problems):
            var_names = None
        if a_shared:
            A_shared = np.ascontiguousarray(A0)
            A = np.broadcast_to(A_shared[None], (len(problems), m, n))
        else:
            A_shared = None
            A = np.stack([p.A for p in problems])
        return cls(
            names=[p.name for p in problems],
            c=np.stack([p.c for p in problems]),
            q2=np.stack([p.q2 for p in problems]),
            A=A,
            A_shared=A_shared,
            cl=np.stack([p.cl for p in problems]),
            cu=np.stack([p.cu for p in problems]),
            lb=np.stack([p.lb for p in problems]),
            ub=np.stack([p.ub for p in problems]),
            is_int=is_int,
            const=np.array([p.const for p in problems]),
            tree=tree,
            var_names=var_names,
        )

    @property
    def num_scenarios(self) -> int:
        return len(self.names)

    @property
    def num_vars(self) -> int:
        return int(self.c.shape[1])

    @property
    def num_rows(self) -> int:
        return int(self.A.shape[1])

    @property
    def probs(self) -> np.ndarray:
        return self.tree.scen_prob

    def nonant_mask(self) -> np.ndarray:
        """(n,) bool mask of the nonant slots."""
        mask = np.zeros(self.num_vars, dtype=bool)
        mask[self.tree.nonant_indices] = True
        return mask

    def objective(self, x: np.ndarray) -> np.ndarray:
        """(S,) per-scenario objective values at x of shape (S, n)."""
        lin = np.einsum("sn,sn->s", self.c, x)
        quad = 0.5 * np.einsum("sn,sn->s", self.q2, x * x)
        return lin + quad + self.const


def _quantize(v: int, quantum: int) -> int:
    """``v`` rounded up to a multiple of ``quantum``."""
    return int(-(-v // quantum) * quantum)


@dataclasses.dataclass
class BucketedBatch:
    """A shape-bucketed batch of a ragged family.

    :class:`ScenarioBatch` pads every scenario to the family's widest, so
    one large scenario makes the whole (S, m, n) constraint tensor pay.
    Here scenarios are grouped by their (n, m) rounded up to ``quantum``
    and by their padded integer pattern; each bucket is a compact
    ``ScenarioBatch`` of its own (its own solver program), with its
    probabilities normalized inside the bucket (the sub-batch's tree is
    solver plumbing only: every reduction reads the outer ``tree``).  The
    2-D bookkeeping arrays (c, q2, lb, ub, cl, cu) are kept zero-padded to
    the family's maxima, so PH's bookkeeping reads them as it reads a
    ScenarioBatch's; the (S, m, n) ``A`` has no padded view and raises.
    ``buckets`` is a list of ``(scenario indices, ScenarioBatch)``."""

    names: list
    buckets: list
    tree: TreeInfo
    c: np.ndarray          # (S, n_max), zero-padded
    q2: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    cl: np.ndarray         # (S, m_max)
    cu: np.ndarray
    const: np.ndarray      # (S,)
    # column names are bucket-local: the padded layout has slot indices only
    var_names: list | None = None
    version: int = 0

    @classmethod
    def from_problems(cls, problems, quantum: int = 16) -> "BucketedBatch":
        groups: dict = {}
        for i, p in enumerate(problems):
            nq = _quantize(p.num_vars, quantum)
            mq = _quantize(p.num_rows, quantum)
            # a ScenarioBatch takes one integer pattern, and padding can
            # make patterns differ inside a quantized shape
            patt = np.zeros(nq, dtype=bool)
            patt[:p.num_vars] = p.is_int
            groups.setdefault((nq, mq, patt.tobytes()), []).append(i)
        probs = [p.prob for p in problems]
        if all(pr is None for pr in probs):
            problems = [dataclasses.replace(p, prob=1.0 / len(problems))
                        for p in problems]
        elif any(pr is None for pr in probs):
            raise ValueError(
                "either all or no scenarios may carry a probability")
        buckets = []
        for key in sorted(groups):
            idx = np.asarray(groups[key], dtype=np.int64)
            members = [problems[i] for i in idx]
            tot = sum(p.prob for p in members)
            members = [dataclasses.replace(p, prob=p.prob / tot)
                       for p in members]
            buckets.append((idx, ScenarioBatch.from_problems(members)))
        S = len(problems)
        n_max = max(p.num_vars for p in problems)
        m_max = max(p.num_rows for p in problems)

        def pad2(get, width):
            out = np.zeros((S, width))
            for i, p in enumerate(problems):
                v = get(p)
                out[i, :v.shape[0]] = v
            return out

        return cls(
            names=[p.name for p in problems], buckets=buckets,
            tree=build_tree(problems),
            c=pad2(lambda p: p.c, n_max), q2=pad2(lambda p: p.q2, n_max),
            lb=pad2(lambda p: p.lb, n_max),
            ub=pad2(lambda p: p.ub, n_max),    # padded slots clamp at 0
            cl=pad2(lambda p: p.cl, m_max), cu=pad2(lambda p: p.cu, m_max),
            const=np.array([p.const for p in problems]))

    @property
    def num_scenarios(self) -> int:
        return len(self.names)

    @property
    def num_vars(self) -> int:
        return int(self.c.shape[1])

    @property
    def num_rows(self) -> int:
        return int(self.cl.shape[1])

    @property
    def probs(self) -> np.ndarray:
        return self.tree.scen_prob

    @property
    def A(self):
        raise AttributeError(
            "BucketedBatch has no global A tensor (that padding is the "
            "quadratic cost bucketing exists to avoid); iterate .buckets "
            "or disable shape_buckets for features needing batch.A")

    @property
    def A_shared(self):
        """No family-wide shared matrix (a bucket may have its own)."""
        return None

    @property
    def is_int(self):
        if any(sub.is_int.any() for _, sub in self.buckets):
            raise AttributeError(
                "BucketedBatch does not expose a shared is_int pattern "
                "(buckets differ); integer xhat diving requires an "
                "unbucketed batch")
        return np.zeros(self.num_vars, dtype=bool)

    def nonant_mask(self) -> np.ndarray:
        mask = np.zeros(self.num_vars, dtype=bool)
        mask[self.tree.nonant_indices] = True
        return mask

    def padded_elements(self) -> int:
        """A's elements over all buckets (what the solves hold)."""
        return int(sum(idx.size * sub.num_rows * sub.num_vars
                       for idx, sub in self.buckets))

    def objective(self, x: np.ndarray) -> np.ndarray:
        """(S,) per-scenario objectives at x of shape (S, n_max)."""
        out = np.zeros(self.num_scenarios)
        for idx, sub in self.buckets:
            out[idx] = sub.objective(x[idx][:, :sub.num_vars])
        return out


def batch_parts(batch):
    """``[(scenario indices, ScenarioBatch)]``: a bucketed batch's buckets,
    or the whole batch as one part."""
    if isinstance(batch, BucketedBatch):
        return batch.buckets
    return [(np.arange(batch.num_scenarios), batch)]
