"""Segmented solves: the frozen-continuation protocol.

Port of ``tpusppy/solvers/segmented.py`` without its TPU watchdog budgets.
The reference splits sweep loops that would outlast a remote TPU worker's
execution limit into bounded dispatches, re-entered from the host: factors
are computed once and each segment warm-starts from the previous raw
iterate (:func:`continue_frozen`), optionally dispatching segment k+1
before segment k's stop statistics are read
(:func:`_continue_frozen_pipelined`).  The H100 has no execution kill, and
the reference's per-dispatch budgets are sized from TPU v5e measurements,
so here :func:`solve_factored_segmented` and
:func:`solve_frozen_segmented` keep the reference's call shape and run
one dispatch a solve, whose sweep loop runs on the device
(:mod:`.device_loop`), and nothing calls :func:`continue_frozen` yet.

The megastep's window cap (:func:`megastep_cap`) and its billing
(:func:`bill_megastep`, :func:`bill_bound_pass`).  The reference sizes its
cap against a TPU worker's execution kill from TPU v5e sweep rates; the
H100 has no such kill, so the card's rule is a window of at most
:data:`WINDOW_ITERS` PH iterations, whatever the shapes: a window ends
often enough for the hub's sync and termination checks.  The billing is
the reference's, on the model flops of :mod:`.flops`.

Counters, as in the reference: ``dispatch.segments``, ``dispatch.flops``
(with ``seg_flops``), ``speculation.segments``, ``speculation.flops``,
``speculation.discarded_segments`` and ``speculation.discarded_flops``;
``dispatch.megasteps``, ``dispatch.mega_iterations``,
``megastep.rejected_iterations`` and ``megastep.bound_passes``.
"""

from __future__ import annotations

import collections

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from . import flops as flops_model
from . import hostsync

#: PH iterations one megastep window may carry on the card.  The H100 has
#: no per-execution kill, so this bounds only how long the hub goes
#: between window ends, where it syncs with its spokes and checks its gap
#: and convergence: the reference's default cadence (16) runs windows of
#: 15, well inside it.
WINDOW_ITERS = 32

#: The flop model's factor for a :class:`~.sparse.SparseA` sweep, the
#: reference's (``tpusppy/solvers/segmented.py:310``), kept so that both
#: packages bill the same model flops.  It is a counting convention of the
#: model, not a rate measured on this card.
SPARSE_DISPATCH_FACTOR = 0.25


def megastep_cap(bound_pass=False) -> int:
    """Most PH iterations one megastep window may carry on the card (the
    reference's ``megastep_cap``, ``tpusppy/solvers/segmented.py:189``,
    which sizes it against a TPU worker's kill from TPU sweep rates).  The
    card's rule: :data:`WINDOW_ITERS`, less one iteration for each frozen
    evaluation of an in-wheel bound pass the window ends with
    (``bound_pass``: False, True for one, or a count), so a window stays
    at most :data:`WINDOW_ITERS` frozen solves long.  The rule holds for
    a window of several problems too (the bucketed and tenant windows,
    whose cap the reference's ``megastep_cap_multi`` sums over the
    problems' TPU sweep times): the card has no kill to sum against."""
    return max(0, WINDOW_ITERS - int(bound_pass))


def bill_megastep(S, n, m, n_iters, sweeps, sparse_factor=1.0,
                  rejected_sweeps=None, count_dispatch=True):
    """Bill one executed megastep window: ``dispatch.megasteps`` +1,
    ``dispatch.mega_iterations`` + ``n_iters`` (the iterations the window
    accepted), and the model flops of their ``sweeps`` (mean sweeps an
    iteration) into ``dispatch.flops``.  ``rejected_sweeps``: the sweeps
    of an iterate the window's acceptance test discarded, billed into
    ``dispatch.flops`` and counted in ``megastep.rejected_iterations``,
    never as a PH iteration.  ``count_dispatch=False`` bills the flops
    only: a bucketed window is billed once a bucket, on each bucket's
    shapes, and counted once.  Returns the flops billed."""
    if count_dispatch:
        _metrics.inc("dispatch.megasteps")
        _metrics.inc("dispatch.mega_iterations", int(n_iters))
    fl = flops_model.megastep_flops(S, n, m, n_iters, sweeps, sparse_factor)
    if rejected_sweeps is not None:
        if count_dispatch:
            _metrics.inc("megastep.rejected_iterations")
        fl += flops_model.megastep_flops(S, n, m, 1, rejected_sweeps,
                                         sparse_factor)
    if fl:
        _metrics.inc("dispatch.flops", fl)
    if _trace.enabled():
        _trace.instant("dispatch", "megastep", S=S, n=n, m=m,
                       iters=int(n_iters), sweeps=float(sweeps))
    return fl


def bill_bound_pass(S, n, m, sweeps, sparse_factor=1.0, count_pass=True,
                    n_evals=1):
    """Bill one executed in-wheel bound pass: ``megastep.bound_passes`` +1
    and its model flops (``n_evals`` frozen evaluations of ``sweeps``
    sweeps and the dual assembly) into ``dispatch.flops``, never into the
    PH iterations.  ``count_pass=False`` bills the flops only (a bucketed
    pass is billed once a bucket and counted once).  Returns the flops
    billed."""
    if count_pass:
        _metrics.inc("megastep.bound_passes")
    fl = flops_model.bound_pass_flops(S, n, m, sweeps, sparse_factor,
                                      n_evals=n_evals)
    if fl:
        _metrics.inc("dispatch.flops", fl)
    if _trace.enabled():
        _trace.instant("dispatch", "bound_pass", S=S, n=n, m=m,
                       sweeps=float(sweeps))
    return fl


def continue_frozen(run_segment, sol, seg_f, budget, all_done=None,
                    plateau_rtol=None, pipeline=False, overlap=1,
                    check_incoming=False, seg_flops=None):
    """Re-dispatch ``run_segment(warm)`` from the last raw iterate until the
    solve stops, plateaus, or the sweep budget is spent; returns the last
    solution.

    ``all_done(sol)`` decides whether to stop dispatching; the default
    reads the iteration counter (the loop leaves before its cap when every
    scenario met eps or the in-loop plateau exit fired) and the eps vote,
    from ONE fetched 4-vector (:func:`..admm.stop_stats`).  It is a stop
    signal, not a convergence signal (use ``BatchSolution.done``).  A
    caller's ``all_done`` keeps the separate-fetch protocol and never
    speculates.

    ``plateau_rtol``: stop when two consecutive segments each improved the
    worst residual by less than this fraction (one non-improving segment is
    forgiven: ADMM is not monotone segment to segment).

    ``pipeline=True`` (default ``all_done`` only) dispatches segment k+1
    from segment k's iterate before segment k's stop statistics are read,
    each statistic launched right after its segment; a stop verdict
    discards the segments in flight, so the result is the serial
    protocol's on the same verdicts.  The budget is charged at dispatch, so
    the work dispatched never exceeds the serial worst case, and the waste
    is at most ``overlap`` segments.

    ``seg_flops``: model flops of one segment, billed into
    ``dispatch.flops`` and the ``speculation.*`` counters (segment counts
    are billed regardless).  ``check_incoming=True`` first reads the
    incoming solution's statistics and returns it untouched when they
    already say stop."""
    from . import admm as _admm

    def _worst(s):
        return max(float(hostsync.fetch(s.pri_res).max()),
                   float(hostsync.fetch(s.dua_res).max()))

    if all_done is None:
        def _stats_launch(s):
            """The stop statistics of a real BatchSolution, queued on the
            device; scripted stand-ins carry theirs as attributes."""
            if isinstance(s, _admm.BatchSolution):
                return _admm.stop_stats(s)
            return None

        def _stats_read(s, dev, overlapped=False):
            """(stop dispatching, worst residual): ONE host fetch."""
            if dev is not None:
                st = hostsync.fetch(dev, overlapped=overlapped)
                stop = int(st[0]) < seg_f or bool(st[3])
                return stop, max(float(st[1]), float(st[2]))
            stop = int(hostsync.fetch(
                s.iters, overlapped=overlapped).max()) < seg_f
            return stop, _worst(s)
    else:
        pipeline = False

        def _stats_launch(s):
            return None

        def _stats_read(s, dev, overlapped=False):
            return all_done(s), _worst(s) if plateau_rtol else None

    if pipeline and overlap >= 1:
        return _continue_frozen_pipelined(
            run_segment, sol, seg_f, budget, _stats_launch, _stats_read,
            plateau_rtol, check_incoming, overlap, seg_flops)

    # ---- serial protocol ------------------------------------------------
    if check_incoming:
        done, worst = _stats_read(sol, _stats_launch(sol))
        if done:
            return sol
        best = worst if plateau_rtol else None
    else:
        # seeded from the incoming iterate, so a parked batch exits quickly
        best = _worst(sol) if plateau_rtol else None
    stall = 0
    while budget > 0:
        with _trace.span("dispatch", "segment") as _sp:
            if _trace.enabled():
                _sp.add(seg_f=seg_f)
            sol = run_segment(sol.raw)
        _metrics.inc("dispatch.segments")
        if seg_flops:
            _metrics.inc("dispatch.flops", seg_flops)
        budget -= seg_f
        done, worst = _stats_read(sol, _stats_launch(sol))
        if done:
            break
        if plateau_rtol:
            if worst > (1.0 - plateau_rtol) * best:
                stall += 1
                if stall >= 2:
                    break
            else:
                stall = 0
            best = min(best, worst)
    return sol


def _continue_frozen_pipelined(run_segment, sol, seg_f, budget,
                               stats_launch, stats_read, plateau_rtol,
                               check_incoming, overlap, seg_flops=None):
    """The speculative continuation (see :func:`continue_frozen`): per
    segment, the segment, then its stop statistics, then its successor, so
    each statistic is queued before any speculative work and the read of
    segment k's verdict overlaps segment k+1."""
    pend = collections.deque()    # (candidate, its statistics) to validate

    def _fill(newest, newest_read=False):
        """Dispatch from the newest iterate until ``overlap`` segments are
        in flight or the budget is spent, charging the budget at dispatch.
        A dispatch is speculative when its source's verdict is unread:
        every entry of ``pend``, and ``newest`` unless just read."""
        nonlocal budget
        while len(pend) < overlap and budget > 0:
            speculative = bool(pend) or not newest_read
            src = pend[-1][0] if pend else newest
            with _trace.span("dispatch", "segment") as _sp:
                if _trace.enabled():
                    _sp.add(seg_f=seg_f, speculative=speculative)
                cand = run_segment(src.raw)
            _metrics.inc("dispatch.segments")
            if seg_flops:
                _metrics.inc("dispatch.flops", seg_flops)
            if speculative:
                _metrics.inc("speculation.segments")
                if seg_flops:
                    _metrics.inc("speculation.flops", seg_flops)
            budget -= seg_f
            pend.append((cand, stats_launch(cand)))

    def _discard():
        """Bill the segments in flight that a stop verdict just made
        useless (dispatched and paid for, their results dropped)."""
        if not pend:
            return
        _metrics.inc("speculation.discarded_segments", len(pend))
        if seg_flops:
            _metrics.inc("speculation.discarded_flops",
                         len(pend) * seg_flops)
        if _trace.enabled():
            _trace.instant("dispatch", "speculation_discard",
                           segments=len(pend))

    # the incoming statistics are queued before any speculative dispatch
    seed_dev = (stats_launch(sol)
                if (check_incoming or plateau_rtol) else None)
    if check_incoming:
        # read the incoming verdict first: its value is complete, and a
        # solve already converged then dispatches nothing
        done, worst = stats_read(sol, seed_dev)
        if done:
            return sol
        best = worst if plateau_rtol else None
        _fill(sol, newest_read=True)
    else:
        # the first dispatch is work the serial protocol does too: not
        # billed as speculation
        _fill(sol, newest_read=True)
        best = (stats_read(sol, seed_dev, overlapped=bool(pend))[1]
                if plateau_rtol else None)
    stall = 0
    cur = sol
    while pend:
        cand, sdev = pend.popleft()
        _fill(cand)
        cur = cand
        if not pend:
            # budget spent and nothing in flight: the verdict cannot change
            # what is returned
            break
        done, worst = stats_read(cand, sdev, overlapped=True)
        if done:
            _discard()
            break
        if plateau_rtol:
            if worst > (1.0 - plateau_rtol) * best:
                stall += 1
                if stall >= 2:
                    _discard()
                    break
            else:
                stall = 0
            best = min(best, worst)
    return cur


def _continue_frozen(frozen_fn, args, factors, sol, st_f, seg_f, budget,
                     pipeline=False, check_incoming=False, seg_flops=None,
                     plateau_rtol=0.05, **kw):
    """Host-path adapter for :func:`continue_frozen`: segments are frozen
    solves at ``st_f`` (the segment's sweep cap in its ``max_iter``).
    ``plateau_rtol``: the segment plateau exit (the reference's
    ``ADMMSettings.segment_plateau_rtol`` default)."""
    return continue_frozen(
        lambda warm: frozen_fn(*args, factors, settings=st_f, warm=warm,
                               **kw),
        sol, seg_f, budget,
        plateau_rtol=plateau_rtol, pipeline=pipeline,
        check_incoming=check_incoming, seg_flops=seg_flops)


def _conv(sol, want_converged):
    return bool(hostsync.fetch(sol.done).all()) if want_converged else None


def solve_factored_segmented(frozen_fn, factored_fn, args, settings,
                             warm=None, shared=False, want_converged=True):
    """Adaptive solve and factors, ``factored_fn(*args, settings=settings,
    warm=warm)`` in one dispatch (the reference's call shape; ``frozen_fn``
    and ``shared`` serve its segmented regime, which waits for the H100
    dispatch budgets).  Returns ``(sol, factors, converged)``;
    ``want_converged=False`` skips the ``sol.done`` fetch (converged None)
    for callers that read the vote from their own packed fetch."""
    with _trace.span("dispatch", "adaptive_solve"):
        sol, factors = factored_fn(*args, settings=settings, warm=warm)
    return sol, factors, _conv(sol, want_converged)


def solve_frozen_segmented(frozen_fn, args, factors, settings, warm=None,
                           want_converged=True):
    """Frozen solve in one dispatch (the reference's call shape).  Returns
    ``(sol, converged)``; use ``converged`` (from ``BatchSolution.done``),
    not an iteration count, to judge it.  ``want_converged=False`` skips
    that fetch (converged None)."""
    with _trace.span("dispatch", "frozen_solve"):
        sol = frozen_fn(*args, factors, settings=settings, warm=warm)
    return sol, _conv(sol, want_converged)
