"""The batched integer wheel: the integer bound pass, reduced-cost fixing and
the gap-ranked host escalation.

Port of ``tpusppy/solvers/integer.py``.  The reference certifies integer
workloads as mpi-sppy does with a MIP solver behind its Lagrangian spoke
(``mpisppy/cylinders/lagrangian_bounder.py:19-56``): every per-scenario
subproblem minimum is an INTEGER minimum, closing the per-scenario
integrality gap an LP-relaxation bound cannot.  The device path solves LP
relaxations; this module is its three tiers (doc/integer.md):

1. **Inner-bound recovery on the device**: a rounding ladder over the
   consensus xbar plus the two SLAM slams (:func:`candidate_ladder`), each
   candidate fixed onto the nonant box and evaluated by one batched frozen
   solve on the window's factors, gated per candidate by the dtype-aware
   feasibility slack, and the best feasible candidate picked on the device
   (:func:`sweep_partials`, :func:`integer_bound_pass`).
2. **Outer-bound tightening**: reduced-cost fixing from the window's frozen
   duals (:func:`rc_fix_bounds`); one more frozen solve and the
   weak-duality assembly on the shrunk box give a tightened per-scenario
   Lagrangian bound, of which the pass takes the per-scenario max with the
   plain bound (:func:`rc_outer_partials`).
3. **Gap-ranked host escalation**: :class:`EscalationBudget` and
   :func:`escalate_outer` spend HiGHS seconds
   (:func:`.milp_bound.milp_lift`) on the scenarios with the LARGEST
   estimated LP-vs-MILP gap first; :func:`escalate_inner` certifies a
   candidate by per-scenario host MIPs where the family carries
   second-stage integers (the device evaluation relaxes those columns and
   is no incumbent there); :func:`restricted_ef_incumbent` dives the EF
   restricted to the MILP minimizers' agreement.

The reference ``vmap``s the frozen solve over the C candidates, so each
candidate's solve keeps its own batch-wide rules over its own S scenarios
(the stop vote, the restart and gamma rules).  Here the C evaluations are C
frozen solves one after another on the window's factors, each through the
engine's hand kernel (``fused_sweeps`` on the dense engine): one solve over
C*S rows would pool those rules and sweep differently.  The functions of
the device half take the window's :class:`~..parallel.sharded.PHArrays`
and :class:`~..parallel.sharded.PHState` (duck-typed) and read nothing
back to the host.

Validity (as the reference's, ``tpusppy/solvers/integer.py:41-60``):

* Every inner candidate is integral on the integer nonant slots and is
  evaluated with those slots FIXED; where the evaluation is feasible on
  every scenario and the family has no second-stage integers, its expected
  plain objective is an incumbent (the ``Xhat_Eval`` contract).
* Reduced-cost fixing: for any duals y, a scenario-feasible x with a linear
  integer slot j one unit off its bound has W-augmented objective at least
  ``d_s + |g_j|``.  When that exceeds a valid upper bound ``u_s`` on the
  scenario's integer minimum (the candidate's W-augmented value, feasible
  scenarios only, padded by ``rcfix_slack``), every integer minimizer has
  slot j AT the bound, so the shrunk problem's weak-duality bound still
  lower-bounds the original integer minimum.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..obs import metrics as _metrics
from . import admm, cuda_kernels

#: Extra scalars the integer sweep appends to the in-wheel bound tail
#: (after the base ``BOUND_PACK_LEN``): [feasible candidate count, best
#: candidate index, reduced-cost-fixed slot count, untightened outer].
INT_BOUND_EXTRA = 4

#: The default rounding-threshold ladder: nearest (0.5) and two
#: commit-biased entries.
DEFAULT_THRESHOLDS = (0.5, 0.35, 0.25)

#: SLAM candidates after the ladder (up: the per-node max over scenarios,
#: then ceil; down: the per-node min, then floor).
N_SLAM = 2


def n_candidates(thresholds) -> int:
    """Sweep width C of a threshold ladder (the ladder and the slams)."""
    return len(tuple(thresholds)) + N_SLAM


def feas_slack(S: int, dt) -> float:
    """The dtype-aware feasible-mass slack of the all-scenarios gate: an
    all-feasible sum of S probabilities in ``dt`` lands ~S eps below 1.
    ``dt``: a torch or numpy dtype."""
    eps = (torch.finfo(dt).eps if isinstance(dt, torch.dtype)
           else np.finfo(np.dtype(dt)).eps)
    return max(1e-9, 4.0 * int(S) * float(eps))


# ---- the device half ------------------------------------------------------
def candidate_ladder(xbars, xk, int_mask, thresholds, onehot, nid_sk,
                     lb_k, ub_k, include_slams=True):
    """(C, S, K) candidates: the rounding ladder and the SLAM slams.

    ``xbars`` (S, K) is the consensus node mean gathered per scenario, ``xk``
    (S, K) the current nonants (the slams' inputs), ``int_mask`` (K,) bool.
    Ladder entry t rounds integer slots up when their fractional part is at
    least t (``floor(x + 1 - t)``); continuous slots keep xbars.  SLAM-up
    takes every nonant to its node's max over the member scenarios (ceil on
    integer slots), SLAM-down to the min (floor).  Every candidate is
    clipped to the nonant box.  ``include_slams=False`` drops the slams
    (a bucketed leg: per-bucket extremes are not nonanticipative)."""
    mask = torch.as_tensor(int_mask, dtype=torch.bool,
                           device=xbars.device)[None, :]
    cands = [torch.where(mask, torch.floor(xbars + (1.0 - float(t))), xbars)
             for t in thresholds]
    if include_slams:
        member = onehot > 0                               # (S, K, N)
        inf = torch.tensor(float("inf"), dtype=xk.dtype, device=xk.device)
        x3 = xk[:, :, None]
        mx_nk = torch.where(member, x3, -inf).amax(dim=0).T   # (N, K)
        mn_nk = torch.where(member, x3, inf).amin(dim=0).T
        up = mx_nk.gather(0, nid_sk)
        dn = mn_nk.gather(0, nid_sk)
        cands.append(torch.where(mask, torch.ceil(up - 1e-9), up))
        cands.append(torch.where(mask, torch.floor(dn + 1e-9), dn))
    return torch.clamp(torch.stack(cands), lb_k[None], ub_k[None])


def rc_fix_bounds(qL, q2_plain, lb, ub, g, d_cmp, u_s, u_ok, int_cols,
                  rcfix_slack):
    """Reduced-cost fixing masks and the shrunk bounds.

    ``g`` (S, n): the weak-duality reduced costs ``qL + A'y``
    (:func:`.admm.dual_cut`); ``d_cmp`` (S,): the margin-subtracted
    per-scenario dual bound (the conservative side); ``u_s`` (S,): the
    candidate's W-augmented value, valid where ``u_ok``.  A linear integer
    slot fixes at lb when one unit up provably exceeds the scenario's
    integer minimum (``d_cmp + g_j > u_s + slack``, ``g_j >= 0``), at ub
    symmetrically.  Quadratic slots are left alone.  Returns
    ``(lbF, ubF, n_fixed)``."""
    big = admm.BIG
    fin_lb = lb > -big / 2
    fin_ub = ub < big / 2
    room = (ub - lb) >= 0.5           # already-fixed slots are a no-op
    lin = q2_plain < 1e-14
    marg = (rcfix_slack * (1.0 + u_s.abs()))[:, None]
    gate = int_cols[None, :] & lin & room & u_ok[:, None]
    fix_lo = gate & fin_lb & (g >= 0) & (d_cmp[:, None] + g
                                         > u_s[:, None] + marg)
    fix_hi = gate & fin_ub & (g <= 0) & (d_cmp[:, None] - g
                                         > u_s[:, None] + marg)
    fix_hi = fix_hi & ~fix_lo         # g == 0: the lower bound
    lbF = torch.where(fix_hi, ub, lb)
    ubF = torch.where(fix_lo, lb, ub)
    n_fixed = (fix_lo | fix_hi).to(g.dtype).sum()
    return lbF, ubF, n_fixed


def _counted(launches, i, fn):
    """``fn()``, adding the calling thread's kernel launches it made to
    ``launches[i]`` (a list of dicts keyed as :func:`.cuda_kernels.counts`;
    None: no record)."""
    if launches is None:
        return fn()
    before = cuda_kernels.counts(local=True)
    out = fn()
    seen = launches[i]
    for k, v in cuda_kernels.counts(local=True).items():
        if v != before[k]:
            seen[k] = seen.get(k, 0) + v - before[k]
    return out


def sweep_partials(arr, st, idx, q_aug, q2_aug, frozen_fn, factors,
                   settings, feas_tol, int_mask, thresholds,
                   include_slams=True, launches=None):
    """The rounding sweep: ``(inner_c (C,), feas_c (C,), sweeps_c (C,),
    u_cs (C, S), feasmask_cs (C, S))``.  ``inner_c``/``feas_c`` are the
    probability-weighted expected plain objective and feasible mass of
    each candidate's evaluation; ``u_cs`` the W-augmented per-scenario
    value (const-free), the reduced-cost fixing's upper bound;
    ``feasmask_cs`` the scenarios that met the gate.  Candidate c is one
    frozen solve (``frozen_fn``, the engine's) on ``factors`` under the
    PH-augmented objective, warm from the state with the nonants at the
    candidate.  ``launches``: per-candidate launch records
    (:func:`_counted`)."""
    dt = arr.c.dtype
    W = st.W
    cands = candidate_ladder(st.xbars, st.x.index_select(1, idx), int_mask,
                             thresholds, arr.onehot, arr.nid_sk,
                             arr.lb.index_select(1, idx),
                             arr.ub.index_select(1, idx),
                             include_slams=include_slams)
    tol = torch.tensor(float(feas_tol), dtype=dt, device=arr.c.device)
    inner, feas, sweeps, us, oks = [], [], [], [], []
    for ci in range(cands.shape[0]):
        cand = cands[ci]
        lb2 = arr.lb.index_copy(1, idx, cand)
        ub2 = arr.ub.index_copy(1, idx, cand)
        x0 = st.x.index_copy(1, idx, cand)
        sol = _counted(launches, ci, lambda: frozen_fn(
            q_aug, q2_aug, arr.A, arr.cl, arr.cu, lb2, ub2, factors,
            settings=settings, warm=(x0, st.z, st.y, st.yx)))
        lin = torch.einsum("sn,sn->s", arr.c, sol.x)
        quad = 0.5 * torch.einsum("sn,sn->s", arr.q2, sol.x * sol.x)
        feas_s = (sol.pri_res < tol).to(dt)
        inner.append(arr.probs @ (lin + quad + arr.const))
        feas.append(arr.probs @ feas_s)
        sweeps.append(sol.iters.max().to(dt))
        us.append(lin + quad + torch.einsum(
            "sk,sk->s", W, sol.x.index_select(1, idx)))
        oks.append(feas_s > 0)
    return (torch.stack(inner), torch.stack(feas), torch.stack(sweeps),
            torch.stack(us), torch.stack(oks))


def _dual_bound_perscen(qL, arr, lb, ub, y, x):
    """(S,) const-free margin-subtracted weak-duality bound."""
    packed = admm.dual_objective_with_margin(
        qL, arr.q2, arr.A, arr.cl, arr.cu, lb, ub, y, x)
    return packed[0] - packed[1]


def rc_outer_partials(arr, st, idx, q_aug, q2_aug, frozen_fn, factors,
                      settings, int_cols, u_s, u_ok, rcfix_slack=1e-5,
                      want_perscen=False, launches=None, slot=0):
    """The reduced-cost-tightened Lagrangian outer bound:
    ``(outer_tight, outer_base, n_fixed, sweepsF)``, probability-weighted.
    ``u_s``/``u_ok`` come from the selected candidate's
    :func:`sweep_partials` row.  The tightened value is the per-scenario
    max of the plain weak-duality bound and the shrunk box's
    re-certification (one more frozen solve, warm from the state), so it is
    never worse than the LP certificate.  ``want_perscen=True`` returns
    ``(final_s (S,), d_cmp (S,), n_fixed, sweepsF)``, const-free per
    scenario: each entry lower-bounds its scenario's integer minimum of
    the W-augmented objective.  ``launches[slot]`` records the solve's
    launches."""
    dt = arr.c.dtype
    qL = arr.c.index_add(1, idx, st.W)
    d_cmp = _dual_bound_perscen(qL, arr, arr.lb, arr.ub, st.y, st.x)
    outer_base = arr.probs @ (d_cmp + arr.const)
    none = torch.zeros(arr.c.shape[1], dtype=torch.bool, device=arr.c.device)
    _, g = admm.dual_cut(qL, arr.q2, arr.A, arr.cl, arr.cu, arr.lb, arr.ub,
                         st.y, st.x, none)
    lbF, ubF, n_fixed = rc_fix_bounds(qL, arr.q2, arr.lb, arr.ub, g, d_cmp,
                                      u_s, u_ok, int_cols, rcfix_slack)
    solF = _counted(launches, slot, lambda: frozen_fn(
        q_aug, q2_aug, arr.A, arr.cl, arr.cu, lbF, ubF, factors,
        settings=settings, warm=(st.x, st.z, st.y, st.yx)))
    dF = _dual_bound_perscen(qL, arr, lbF, ubF, solF.y, solF.x)
    # the shrunk box's certificate can only help (where nothing was fixed
    # for a scenario, dF is just another valid bound)
    final_s = torch.maximum(d_cmp, dF)
    sweepsF = solF.iters.max().to(dt)
    if want_perscen:
        return final_s, d_cmp, n_fixed, sweepsF
    outer = arr.probs @ (final_s + arr.const)
    return outer, outer_base, n_fixed, sweepsF


def integer_bound_pass(arr, st, idx, q_aug, q2_aug, frozen_fn, factors,
                       settings, feas_tol, int_mask, thresholds, int_cols,
                       rcfix_slack=1e-5, rcfix_enabled=True, launches=None):
    """The INTEGER in-wheel bound pass on a window's final state: the
    best-of-C rounding sweep and the reduced-cost-tightened outer bound.

    ``q_aug``/``q2_aug``: the PH-augmented objective the window's factors
    were built for (on the clamped box the minimizer is the plain one's);
    ``int_mask`` (K,): the integer nonant slots; ``int_cols`` (n,) bool
    tensor: ALL integer columns (fixing reaches past the nonants).  Returns
    the ``BOUND_PACK_LEN + INT_BOUND_EXTRA`` tail: computed flag, tightened
    outer, best inner, its feasible mass, the largest sweep count,
    feasible-candidate count, best index, fixed-slot count, untightened
    outer.  ``rcfix_enabled=False`` skips the fixing and emits the plain
    weak-duality outer twice: on a family with second-stage integers the
    candidate evaluation relaxes them, so ``u_s`` may sit below the
    integer minimum and fixing is not safe.  ``launches``: a list of C + 1
    launch records (the candidates', then the re-certification's)."""
    dt = arr.c.dtype
    S = arr.c.shape[0]
    inner_c, feas_c, sweeps_c, u_cs, feasmask_cs = sweep_partials(
        arr, st, idx, q_aug, q2_aug, frozen_fn, factors, settings, feas_tol,
        int_mask, thresholds, launches=launches)
    ok_c = feas_c >= 1.0 - feas_slack(S, dt)
    inf = torch.tensor(float("inf"), dtype=dt, device=arr.c.device)
    best_idx = torch.argmin(torch.where(ok_c, inner_c, inf))
    n_feas = ok_c.to(dt).sum()
    if rcfix_enabled:
        outer, outer_base, n_fixed, sweepsF = rc_outer_partials(
            arr, st, idx, q_aug, q2_aug, frozen_fn, factors, settings,
            int_cols, u_cs[best_idx], feasmask_cs[best_idx], rcfix_slack,
            launches=launches, slot=inner_c.shape[0])
        sweeps = torch.maximum(sweeps_c.max(), sweepsF)
    else:
        qL = arr.c.index_add(1, idx, st.W)
        outer = outer_base = arr.probs @ (
            _dual_bound_perscen(qL, arr, arr.lb, arr.ub, st.y, st.x)
            + arr.const)
        n_fixed = torch.zeros((), dtype=dt, device=arr.c.device)
        sweeps = sweeps_c.max()
    one = torch.ones((), dtype=dt, device=arr.c.device)
    return torch.stack([
        one, outer, inner_c[best_idx], feas_c[best_idx], sweeps, n_feas,
        best_idx.to(dt), n_fixed, outer_base])


# ---- the host half --------------------------------------------------------
def int_mask_rows(opt) -> np.ndarray:
    """(S, K) per-scenario integer mask of the nonant slots (a bucketed
    batch's buckets each carry their own pattern)."""
    from ..ir import BucketedBatch

    b = opt.batch
    nidg = opt.tree.nonant_indices
    if isinstance(b, BucketedBatch):
        out = np.zeros((b.num_scenarios, len(nidg)), dtype=bool)
        for idx, sub in b.buckets:
            out[np.asarray(idx)] = np.asarray(
                sub.is_int, bool)[sub.tree.nonant_indices]
        return out
    return np.broadcast_to(np.asarray(b.is_int, bool)[nidg],
                           (b.num_scenarios, len(nidg))).copy()


def host_candidates(opt, thresholds=DEFAULT_THRESHOLDS):
    """(C, S, K) host twin of :func:`candidate_ladder` from the opt
    object's host mirrors (xbars, current nonants): the candidate rule
    ``floor(x + 1 - t)`` and the box clip with the per-row integer mask,
    the slams from ``xhatbase.slam_cache``."""
    from ..extensions.xhatbase import slam_cache

    if getattr(opt, "_host_state_stale", False):
        opt._sync_host_state()
    b = opt.batch
    nid = opt.tree.nonant_indices
    ints = int_mask_rows(opt)
    xbars = np.asarray(opt.xbars, dtype=float)
    lo = np.asarray(b.lb)[:, nid]
    hi = np.asarray(b.ub)[:, nid]
    cands = [np.clip(np.where(ints, np.floor(xbars + (1.0 - float(t))),
                              xbars), lo, hi)
             for t in thresholds]
    xk = opt.nonants_of(opt.local_x)
    for how, snap in (("max", lambda c: np.ceil(c - 1e-9)),
                      ("min", lambda c: np.floor(c + 1e-9))):
        cand = slam_cache(opt, xk, how=how)
        cand = np.where(ints, snap(cand), cand)
        cands.append(np.clip(cand, lo, hi))
    return np.stack(cands)


class EscalationBudget:
    """Shared wall-clock budget of the host escalation tier: one a wheel.
    Every escalation takes a grant, runs, and is charged what it used, so
    the whole host-HiGHS tail stays within ``budget_s``.  ``clock`` is
    injectable (fake-clock tests)."""

    def __init__(self, budget_s: float, clock=time.monotonic):
        self.budget_s = float(budget_s)
        self.clock = clock
        self.spent_s = 0.0

    @property
    def remaining(self) -> float:
        return max(0.0, self.budget_s - self.spent_s)

    def take(self, want_s: float | None = None) -> float:
        """Grant up to ``want_s`` seconds (the whole remainder when None);
        0.0 means exhausted."""
        rem = self.remaining
        return rem if want_s is None else min(float(want_s), rem)

    def timed(self):
        """Context manager charging the enclosed wall time."""
        return _BudgetTimer(self)


class _BudgetTimer:
    def __init__(self, budget: EscalationBudget):
        self.b = budget

    def __enter__(self):
        self.t0 = self.b.clock()
        return self

    def __exit__(self, *exc):
        dt = max(0.0, self.b.clock() - self.t0)
        self.b.spent_s += dt
        _metrics.inc("integer.escalation_secs", dt)
        return False


def gap_ranked_order(probs, lp_perscen, upper_perscen) -> np.ndarray:
    """Scenario visit order of the escalation tier: descending estimated
    probability-weighted gap ``p_s (u_s - d_s)`` (clamped at 0; non-finite
    estimates last)."""
    p = np.asarray(probs, dtype=float)
    gap = p * np.clip(np.asarray(upper_perscen, dtype=float)
                      - np.asarray(lp_perscen, dtype=float), 0.0, None)
    gap = np.where(np.isfinite(gap), gap, -np.inf)
    return np.argsort(-gap, kind="stable")


def _waug_q(opt):
    """The W-augmented (W on, prox off) per-scenario objective: the
    Lagrangian subproblem every escalation bound certifies."""
    b = opt.batch
    q = np.array(b.c, copy=True)
    q[:, opt.tree.nonant_indices] += np.asarray(opt.W, dtype=float)
    return q


def declined(what: str, err) -> None:
    """Record one host escalation that raised and declined: counted in
    ``integer.escalation_errors`` and said, loudly."""
    from .. import global_toc

    _metrics.inc("integer.escalation_errors")
    global_toc(f"{what} failed ({err!r}): declined", True)


def candidate_upper_perscen(opt, cand) -> tuple[np.ndarray, np.ndarray]:
    """(u_s, ok_s): the W-augmented per-scenario value of one fixed
    candidate from one frozen solve on the opt object's factors (the
    ranking input of :func:`gap_ranked_order`); ``ok_s`` marks the
    scenarios that met the feasibility gate.  (+inf, False) rows when no
    frozen state exists."""
    from . import hostsync, shared_admm

    b = opt.batch
    S = b.num_scenarios
    if opt._factors is None or opt._warm is None:
        return (np.full(S, np.inf), np.zeros(S, dtype=bool))
    nid = np.asarray(opt.tree.nonant_indices)
    lb = np.array(b.lb, copy=True)
    ub = np.array(b.ub, copy=True)
    lb[:, nid] = cand
    ub[:, nid] = cand
    q, q2 = opt._augmented_q()
    st = opt.admm_settings
    dt = st.tdtype()
    A_d, cl_d, cu_d = opt._device_consts(dt)

    def t(v):
        return admm._tensor(v, dt, opt.device)

    x, z, y, yx = (t(v) for v in opt._warm)
    x0 = x.clone()
    x0[:, nid] = t(cand)
    frozen = (shared_admm.solve_shared_frozen if b.A_shared is not None
              else admm.solve_batch_frozen)
    sol = frozen(t(q), t(q2), A_d, cl_d, cu_d, t(lb), t(ub),
                 factors=opt._factors, settings=st, warm=(x0, z, y, yx))
    xs, pri = (np.asarray(a) for a in hostsync.fetch((sol.x, sol.pri_res)))
    qL = _waug_q(opt)
    u = (np.einsum("sn,sn->s", qL, xs)
         + 0.5 * np.einsum("sn,sn->s", np.asarray(b.q2), xs * xs))
    ok = pri < opt._inwheel_feas_tol()
    return u, ok


def escalate_outer(opt, budget: EscalationBudget, *, want_s=None,
                   time_limit=10.0, mip_rel_gap=1e-4,
                   upper_perscen=None, want_x=False):
    """ONE gap-ranked escalation round: lift per-scenario LP certificates
    to MILP dual bounds, largest estimated gap first, within the shared
    budget.  Returns the lifted expected outer bound (never below the LP
    bound: :func:`.milp_bound.milp_lift` takes the per-scenario max), or
    None when the budget is spent or the family is continuous;
    ``want_x=True`` returns ``(bound, X)`` with the (S, n) MILP minimizers
    (NaN rows where not lifted).  ``upper_perscen``: the ranking's
    per-scenario upper estimates (:func:`candidate_upper_perscen`); without
    them the order is by probability."""
    from . import milp_bound

    b = opt.batch
    if not bool(np.asarray(b.is_int).any()):
        return (None, None) if want_x else None
    grant = budget.take(want_s)
    if grant <= 0.05:
        return (None, None) if want_x else None
    q = _waug_q(opt)
    base = np.asarray(opt.Edualbound_perscen(q=q, q2=b.q2), dtype=float)
    order = None
    if upper_perscen is not None:
        order = gap_ranked_order(opt.probs, base, upper_perscen)
    _metrics.inc("integer.escalations")
    with budget.timed():
        out = milp_bound.milp_lift(
            b, q, base, budget_s=grant, order=order,
            time_limit=min(float(time_limit), grant),
            mip_rel_gap=mip_rel_gap, want_x=want_x)
    lifted, n = out[0], out[1]
    _metrics.inc("integer.escalation_lifts", int(n))
    bound = float(np.asarray(opt.probs, dtype=float) @ lifted)
    return (bound, out[2]) if want_x else bound


def restricted_ef_incumbent(opt, X, budget: EscalationBudget, *,
                            want_s=None, time_limit=20.0,
                            mip_rel_gap=1e-4) -> float | None:
    """The restricted-EF dive seeded by the MILP lift's minimizers: integer
    nonant slots where EVERY scenario minimizer agrees are fixed at the
    agreed value, the rest stay free, and the restricted EF MIP is solved
    time-limited.  Any feasible solution of it is EF-feasible, so its
    objective is an incumbent.  Returns the value, or None (budget spent,
    no solution in time, or a solver error, which declines)."""
    import dataclasses

    from ..ef import solve_ef

    b = opt.batch
    grant = budget.take(want_s)
    if grant <= 0.05:
        return None
    X = np.asarray(X, dtype=float)
    if np.isnan(X[:, 0]).any():
        return None
    nid = np.asarray(opt.tree.nonant_indices)
    ints = np.asarray(b.is_int, bool)[nid]
    xk = np.round(X[:, nid])
    agree = ints[None, :] & (xk == xk[:1]).all(axis=0)[None, :]
    lb = np.array(b.lb, copy=True)
    ub = np.array(b.ub, copy=True)
    lb[:, nid] = np.where(agree, xk, lb[:, nid])
    ub[:, nid] = np.where(agree, xk, ub[:, nid])
    _metrics.inc("integer.escalations")
    with budget.timed():
        try:
            obj, _ = solve_ef(
                dataclasses.replace(b, lb=lb, ub=ub), solver="highs",
                mip=True, time_limit=min(float(time_limit), grant),
                mip_rel_gap=mip_rel_gap)
        except Exception as e:
            declined("restricted-EF incumbent", e)
            return None
    return float(obj) if np.isfinite(obj) else None


def escalate_inner(opt, budget: EscalationBudget, cand, *,
                   want_s=None, time_limit=10.0) -> float | None:
    """Certify ONE candidate by per-scenario host MIPs, the inner leg for
    families with SECOND-STAGE integers (sizes): the nonants fixed at the
    candidate, each scenario's MIP solved.  Returns the expected
    objective, or None (budget spent, a scenario infeasible or timed out
    without an incumbent, a quadratic scenario, or a solver error, which
    declines)."""
    from . import scipy_backend

    b = opt.batch
    grant = budget.take(want_s)
    if grant <= 0.05:
        return None
    nid = opt.tree.nonant_indices
    lb = np.array(b.lb, copy=True)
    ub = np.array(b.ub, copy=True)
    lb[:, nid] = cand
    ub[:, nid] = cand
    is_int = np.asarray(b.is_int, bool)
    probs = np.asarray(opt.probs, dtype=float)
    deadline = budget.clock() + grant
    objs = np.full(b.num_scenarios, np.inf)
    _metrics.inc("integer.escalations")
    with budget.timed():
        try:
            for s in range(b.num_scenarios):
                rem = deadline - budget.clock()
                if rem <= 0.05:
                    return None
                if np.asarray(b.q2[s]).any():
                    return None      # the host MIP tier is LP-objective only
                r = scipy_backend.solve_lp(
                    b.c[s], b.A[s], b.cl[s], b.cu[s], lb[s], ub[s],
                    is_int=is_int, const=float(b.const[s]),
                    time_limit=min(float(time_limit), rem))
                # any integer-feasible incumbent certifies, a time-limited
                # one too
                if not r.feasible or not np.isfinite(r.obj):
                    return None
                objs[s] = r.obj
        except Exception as e:
            declined("integer inner MIP certification", e)
            return None
    return float(probs @ objs)
