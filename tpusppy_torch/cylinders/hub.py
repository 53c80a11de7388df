"""Hub communicators: bound bookkeeping, gap termination, spoke traffic.

A copy of ``tpusppy/cylinders/hub.py``'s ``Hub`` and ``PHHub`` (the analogue
of ``mpisppy/cylinders/hub.py:23-598``).  The hub owns the optimization
object (PH), pushes W / nonant / bound payloads into the per-spoke outbound
mailboxes each ``sync()``, pulls spoke bounds with write-id freshness
checks, tracks the best inner/outer bounds, and terminates the wheel on
``rel_gap`` / ``abs_gap`` / ``max_stalled_iters`` by broadcasting the kill
sentinel.

Bound source chars: a spoke's class char, ``'T'`` the trivial bound, ``'X'``
an in-hub xhat incumbent, and ``'M'`` an in-wheel bound, the megastep's
bound pass (``PHBase._consume_inwheel_bounds``) landing through the same
typed ``OuterBoundUpdate``/``InnerBoundUpdate``, so gaps and termination
treat it as a spoke bound: a hub with no spokes certifies by itself.

Not ported yet: the spoke supervisor, checkpoints and resume, preemption
(ROADMAP Queue 1 item 7, resilience and serving), and the cross-scenario,
APH and L-shaped hubs (Queue 1 item 7); an option only those read raises.
"""

from __future__ import annotations

import time
from math import inf

import numpy as np

from .. import global_toc
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .spcommunicator import SPCommunicator
from .spoke import ConvergerSpokeType

#: Hub options that only the parts not ported read.
UNPORTED_OPTIONS = {
    "checkpoint_dir": "Queue 1 item 7 (resilience)",
    "checkpoint_every_secs": "Queue 1 item 7 (resilience)",
    "checkpoint_every_iters": "Queue 1 item 7 (resilience)",
    "checkpoint_keep": "Queue 1 item 7 (resilience)",
    "resume": "Queue 1 item 7 (resilience)",
    "spoke_timeout_secs": "Queue 1 item 7 (resilience: the supervisor)",
    "spoke_timeout_grace": "Queue 1 item 7 (resilience: the supervisor)",
    "preempt_check": "Queue 1 item 7 (the service tier)",
}


def check_options(options):
    """Raise on a hub option that only a part not ported yet reads."""
    for name, item in UNPORTED_OPTIONS.items():
        if (options or {}).get(name) is not None:
            raise NotImplementedError(
                f"hub option {name!r} is not ported yet (ROADMAP {item})")


class Hub(SPCommunicator):
    """Base hub (hub.py:23-450)."""

    def __init__(self, spbase_object, strata_rank, fabric, spokes,
                 options=None):
        check_options(options)
        super().__init__(spbase_object, strata_rank, fabric, options)
        self.spokes = list(spokes)           # list of dicts with spoke_class
        self.remote_write_ids = {}           # spoke idx -> last accepted id
        self.latest_ib_char = None
        self.latest_ob_char = None
        self.print_init = True
        self.stalled_iter_cnt = 0
        self.last_gap = inf
        self.stop_reason = None

    # ---- spoke typing (hub.py:297-344) --------------------------------------
    def initialize_spoke_indices(self):
        self.outerbound_spoke_indices = set()
        self.innerbound_spoke_indices = set()
        self.nonant_spoke_indices = set()
        self.w_spoke_indices = set()
        self.outerbound_spoke_chars = {}
        self.innerbound_spoke_chars = {}
        for i, spoke in enumerate(self.spokes):
            cls = spoke["spoke_class"]
            for cst in getattr(cls, "converger_spoke_types", ()):
                if cst == ConvergerSpokeType.OUTER_BOUND:
                    self.outerbound_spoke_indices.add(i + 1)
                    self.outerbound_spoke_chars[i + 1] = \
                        cls.converger_spoke_char
                elif cst == ConvergerSpokeType.INNER_BOUND:
                    self.innerbound_spoke_indices.add(i + 1)
                    self.innerbound_spoke_chars[i + 1] = \
                        cls.converger_spoke_char
                elif cst == ConvergerSpokeType.W_GETTER:
                    self.w_spoke_indices.add(i + 1)
                elif cst == ConvergerSpokeType.NONANT_GETTER:
                    self.nonant_spoke_indices.add(i + 1)
        self.bounds_only_indices = (
            (self.outerbound_spoke_indices | self.innerbound_spoke_indices)
            - (self.w_spoke_indices | self.nonant_spoke_indices)
        )
        self.has_outerbound_spokes = bool(self.outerbound_spoke_indices)
        self.has_innerbound_spokes = bool(self.innerbound_spoke_indices)
        self.has_nonant_spokes = bool(self.nonant_spoke_indices)
        self.has_w_spokes = bool(self.w_spoke_indices)
        self.has_bounds_only_spokes = bool(self.bounds_only_indices)

    def initialize_bound_values(self):
        if self.opt.is_minimizing:
            self.BestInnerBound, self.BestOuterBound = inf, -inf
            self._ib_better = lambda new, old: new < old
            self._ob_better = lambda new, old: new > old
        else:
            self.BestInnerBound, self.BestOuterBound = -inf, inf
            self._ib_better = lambda new, old: new > old
            self._ob_better = lambda new, old: new < old

    # ---- gap / termination (hub.py:77-161) ----------------------------------
    def compute_gaps(self):
        if self.opt.is_minimizing:
            abs_gap = self.BestInnerBound - self.BestOuterBound
        else:
            abs_gap = self.BestOuterBound - self.BestInnerBound
        if np.isfinite(abs_gap) and np.isfinite(self.BestOuterBound):
            # a legitimately-zero outer bound (optimum at 0) takes the
            # absolute gap as the "relative" one, as the reference does,
            # so rel_gap termination still fires there
            rel_gap = abs_gap / (abs(self.BestOuterBound) or 1.0)
        else:
            rel_gap = inf
        return abs_gap, rel_gap

    def determine_termination(self) -> bool:
        opts = self.options
        if not any(k in opts for k in ("rel_gap", "abs_gap",
                                       "max_stalled_iters")):
            return False
        abs_gap, rel_gap = self.compute_gaps()
        rel_ok = "rel_gap" in opts and rel_gap <= opts["rel_gap"]
        abs_ok = "abs_gap" in opts and abs_gap <= opts["abs_gap"]
        stalled = False
        if "max_stalled_iters" in opts:
            if abs_gap < self.last_gap:
                self.last_gap = abs_gap
                self.stalled_iter_cnt = 0
            else:
                self.stalled_iter_cnt += 1
                stalled = self.stalled_iter_cnt >= opts["max_stalled_iters"]
        if abs_ok:
            global_toc(f"Terminating: absolute gap {abs_gap:.4f}", True)
        if rel_ok:
            global_toc(f"Terminating: relative gap {rel_gap * 100:.3f}%",
                       True)
        if stalled:
            global_toc(f"Terminating: stalled {self.stalled_iter_cnt} iters",
                       True)
        if abs_ok or rel_ok or stalled:
            self.stop_reason = ("abs_gap" if abs_ok else
                                "rel_gap" if rel_ok else "stalled")
            if _trace.enabled():
                _trace.instant(
                    "hub", "terminate", reason=self.stop_reason,
                    abs_gap=abs_gap, rel_gap=rel_gap,
                    best_outer=self.BestOuterBound,
                    best_inner=self.BestInnerBound)
            return True
        return False

    # ---- screen trace (hub.py:111-123) --------------------------------------
    def _update_string(self):
        ob = self.latest_ob_char or ' '
        ib = self.latest_ib_char or ' '
        return f"{ob} {ib}"

    def screen_trace(self):
        it = self.current_iteration()
        abs_gap, rel_gap = self.compute_gaps()
        if self.print_init:
            global_toc(
                f'{"Iter.":>5s}     {"Best Bound":>14s}  '
                f'{"Best Incumbent":>14s}  {"Rel. Gap":>12s}  '
                f'{"Abs. Gap":>14s}', True)
            self.print_init = False
        global_toc(
            f"{it:5d} {self._update_string()} {self.BestOuterBound:14.4f}  "
            f"{self.BestInnerBound:14.4f}  {rel_gap * 100:12.3f}%  "
            f"{abs_gap:14.4f}", True)
        self.latest_ib_char = None
        self.latest_ob_char = None

    # ---- mailbox traffic (hub.py:370-436) -----------------------------------
    def hub_to_spoke_versioned(self, idx: int, token, build):
        """Put that SKIPS when the payload source (``token``) has not
        advanced since the last send to this spoke; ``build`` is a zero-arg
        payload constructor, called only when a send happens."""
        self.fabric.to_spoke[idx].put_versioned(token, build)

    def hub_from_spoke(self, idx: int):
        """Returns (payload, True) when the spoke's write-id is fresh."""
        data, wid = self.fabric.to_hub[idx].get()
        last = self.remote_write_ids.get(idx, 0)
        if wid > last or wid < 0:
            self.remote_write_ids[idx] = wid
            return data, True
        return data, False

    def receive_outerbounds(self):
        for idx in self.outerbound_spoke_indices:
            data, is_new = self.hub_from_spoke(idx)
            if is_new:
                self.OuterBoundUpdate(float(data[0]), idx)

    def receive_innerbounds(self):
        for idx in self.innerbound_spoke_indices:
            data, is_new = self.hub_from_spoke(idx)
            if is_new:
                self.InnerBoundUpdate(float(data[0]), idx)

    def OuterBoundUpdate(self, new_bound, idx=None, char='*'):
        if self._ob_better(new_bound, self.BestOuterBound):
            old = self.BestOuterBound
            self.latest_ob_char = (
                char if idx is None else self.outerbound_spoke_chars[idx])
            self.BestOuterBound = new_bound
            _metrics.inc("hub.outer_bound_updates")
            if _trace.enabled():
                _trace.instant("hub", "outer_bound_update", old=old,
                               new=new_bound, spoke=idx, char=char)
        return self.BestOuterBound

    def InnerBoundUpdate(self, new_bound, idx=None, char='*'):
        if self._ib_better(new_bound, self.BestInnerBound):
            old = self.BestInnerBound
            self.latest_ib_char = (
                char if idx is None else self.innerbound_spoke_chars[idx])
            self.BestInnerBound = new_bound
            _metrics.inc("hub.inner_bound_updates")
            if _trace.enabled():
                _trace.instant("hub", "inner_bound_update", old=old,
                               new=new_bound, spoke=idx, char=char)
        return self.BestInnerBound

    def send_terminate(self):
        self.fabric.send_terminate()

    def hub_finalize(self):
        if self.has_outerbound_spokes:
            self.receive_outerbounds()
        if self.has_innerbound_spokes:
            self.receive_innerbounds()
        self.print_init = True
        global_toc("Statistics at termination", True)
        self.screen_trace()

    def current_iteration(self):
        raise NotImplementedError


class PHHub(Hub):
    """PH-flavored hub (hub.py:453-598): sends W and nonants, receives
    bounds.

    Payload layouts (flat float64, as the reference's buffers):
      W spokes:       [W.ravel() (S*K), BestOuterBound, BestInnerBound]
      nonant spokes:  [xk.ravel() (S*K), BestOuterBound, BestInnerBound]
      bounds-only:    [BestOuterBound, BestInnerBound]
    """

    def setup_hub(self):
        self.initialize_spoke_indices()
        self.initialize_bound_values()
        if self.outerbound_spoke_indices & self.innerbound_spoke_indices:
            raise RuntimeError(
                "A spoke providing both inner and outer bounds is "
                "unsupported")
        if self.w_spoke_indices & self.nonant_spoke_indices:
            raise RuntimeError(
                "A spoke needing both Ws and nonants is unsupported")

    def sync(self):
        with _trace.span("hub", "sync"):
            if self.has_w_spokes:
                self.send_ws()
            if self.has_nonant_spokes:
                self.send_nonants()
            if self.has_bounds_only_spokes:
                self.send_boundsout()
            if self.has_outerbound_spokes:
                self.receive_outerbounds()
            if self.has_innerbound_spokes:
                self.receive_innerbounds()

    def is_converged(self):
        if self.opt._iter == 1:
            self.OuterBoundUpdate(self.opt.trivial_bound, char='T')
        # in-hub xhat extensions land their incumbents on the opt object
        bib = getattr(self.opt, "best_inner_bound", None)
        if bib is not None and np.isfinite(bib):
            self.InnerBoundUpdate(float(bib), char='X')
        self.screen_trace()
        if not self.has_innerbound_spokes and not np.isfinite(
                self.BestInnerBound):
            # no incumbent can exist: gap termination stays blocked
            return False
        return self.determine_termination()

    def current_iteration(self):
        return self.opt._iter

    def main(self):
        self.opt.ph_main(finalize=False)
        # where and why the hub's own iterations stopped (before the
        # linger harvest)
        reason = self.stop_reason or (
            "PHIterLimit" if self.opt._iter >= self.opt.options["PHIterLimit"]
            else "convthresh")
        self.stopped_at = (self.opt._iter, reason)
        self._linger()

    def _linger(self):
        """Keep syncing after the hub's own iterations finish, harvesting
        late spoke bounds until the gap certifies or ``linger_secs`` pass
        (hub.py ``_linger``): the hub's iterations are fast, and a hub that
        exits at once throws away what the spokes are computing."""
        linger = float(self.options.get("linger_secs", 0.0))
        if linger <= 0.0 or not self.spokes:
            return
        # a re-send every ``linger_nudge_secs`` keeps the spokes refining
        # on the final state (the versioned puts skip unchanged state)
        nudge = float(self.options.get("linger_nudge_secs", 2.0))
        t0 = time.time()
        last_trace = 0.0
        while time.time() - t0 < linger:
            self._nudge_epoch = int((time.time() - t0) / max(nudge, 0.25))
            self.sync()
            # is_converged prints a trace row per call: at most every 5 s
            if time.time() - last_trace > 5.0:
                last_trace = time.time()
                if self.is_converged():
                    global_toc("Hub linger: gap certified", True)
                    break
            elif self.determine_termination():
                global_toc("Hub linger: gap certified", True)
                break
            time.sleep(0.5)

    def finalize(self):
        return self.opt.post_loops()

    def _state_token(self, kind):
        """Freshness token for outbound payloads: the opt's PH state
        version, the bounds that ride every payload, and the linger nudge
        epoch."""
        return (kind, getattr(self.opt, "sync_version", None),
                getattr(self, "_nudge_epoch", 0),
                self.BestOuterBound, self.BestInnerBound)

    @staticmethod
    def _build_once(build):
        """Memoize a payload constructor for one send round: the payload
        is the same for every spoke of the round."""
        box = []

        def cached():
            if not box:
                box.append(build())
            return box[0]

        return cached

    def send_ws(self):
        build = self._build_once(lambda: np.concatenate(
            [np.asarray(self.opt.W, dtype=np.float64).ravel(),
             [self.BestOuterBound, self.BestInnerBound]]))
        token = self._state_token("W")
        for idx in self.w_spoke_indices:
            self.hub_to_spoke_versioned(idx, token, build)

    def _nonant_payload(self):
        return np.concatenate(
            [np.asarray(self.opt._nonants_cached(), dtype=np.float64).ravel(),
             [self.BestOuterBound, self.BestInnerBound]])

    def send_nonants(self):
        token = self._state_token("nonants")
        build = self._build_once(self._nonant_payload)
        for idx in self.nonant_spoke_indices:
            self.hub_to_spoke_versioned(idx, token, build)

    def send_boundsout(self):
        token = self._state_token("bounds")
        build = self._build_once(
            lambda: np.array([self.BestOuterBound, self.BestInnerBound]))
        for idx in self.bounds_only_indices:
            self.hub_to_spoke_versioned(idx, token, build)
