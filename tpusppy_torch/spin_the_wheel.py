"""WheelSpinner: launch a hub and its spokes and spin until termination.

Port of ``tpusppy/spin_the_wheel.py``'s threaded ``WheelSpinner`` (the
analogue of ``mpisppy/spin_the_wheel.py:12-237``).  Each cylinder is a host
thread with its own opt object: the spokes run on threads of their own and
the hub on the calling thread, and the cylinders meet only in the
write-id versioned mailboxes (:mod:`.cylinders.spcommunicator`), whose
payloads are host numpy copies.

On the card every cylinder runs all of its work (its main loop and its
finalize) inside a CUDA stream of its own, made by the cylinder, so the
cylinders' solves overlap on the device, and as the owner of what the
device code keeps between calls (:func:`.solvers.cuda_kernels.owned_by`:
its captured sweep loops and kernel operands, freed when the wheel ends,
unless the opt's ``device_owner`` option names a token that outlives it).
Each cylinder's kernel launches (its thread's view of the counts), host
syncs (its thread's trackers), solves and host-exact straggler re-solves
are recorded in :attr:`WheelSpinner.stats`.

``WheelSpinner(hub_dict, []).spin()`` with ``in_wheel_bounds`` in the hub
opt's options is the hub-only certified wheel: the hub's megastep windows
post their own outer and inner bounds (``'M'``), and no spoke thread runs.

Resilience (:mod:`.resilience`): the hub options ``checkpoint_dir`` (with
``checkpoint_every_secs``, ``checkpoint_every_iters``, ``checkpoint_keep``)
snapshot the wheel on a writer thread, ``resume`` (or ``resume=``) warm
starts from the newest checkpoint, ``spoke_timeout_secs`` (and
``spoke_timeout_grace``) let the supervisor mark a progress-less spoke
wedged, and ``strict_spokes`` raises on a spoke's failure.  By default a
crashed spoke is marked lost (:attr:`WheelSpinner.lost_spokes`), its
finalize skipped, and the wheel completes with the cylinders left.  A
spoke thread that raised has drained its CUDA stream on the way out
(:meth:`_Cylinder.running` synchronizes it: its queued replays are finite,
the flag read one replay ahead at most), so its captured graphs and
kernel operands are freed only after their last replay, and the hub's
stream never waits on it.

Call sequence as the reference's: construct opt + communicator per
cylinder, make the mailboxes, ``setup_hub``, run all mains, the hub sends
the kill sentinel, join, the hub and then each spoke finalize, and
``hub_finalize``.

Not ported yet: the multiprocess spinner (ROADMAP Queue 1 item 7) and
lowered sweep precision inside a wheel (Queue 1 item 5); asking for them
raises.  The AOT prewarm has no counterpart.
"""

from __future__ import annotations

import contextlib
import csv
import os
import threading
import time

import numpy as np
import torch

from . import global_toc
from .cylinders.spcommunicator import WindowFabric
from .obs import metrics as _metrics
from .resilience import checkpoint as _ckpt
from .resilience import supervisor as _supervisor
from .solvers import cuda_kernels, device_loop, hostsync


class _Cylinder:
    """One cylinder's communicator, its CUDA stream (None off the card)
    and what its work launched and fetched."""

    def __init__(self, name, comm):
        self.name = name
        self.comm = comm
        self.stream = None
        self.launches = {}
        self.host_syncs = 0
        self.crashed = False
        # the owner of the cylinder's device state: its opt object, freed
        # when the wheel ends, or a token of the opt's ``device_owner``
        # option, which outlives the wheel (the solve server keeps one a
        # family and cylinder role, so the next request of the family
        # replays the graphs this one captured)
        self.owner = comm.opt.options.get("device_owner") or comm.opt
        self.owned = self.owner is comm.opt

    @contextlib.contextmanager
    def running(self):
        """Run the body as this cylinder's work: inside its stream, as the
        owner of its device state, counting its launches and syncs."""
        dev = self.comm.opt.device
        with contextlib.ExitStack() as stack:
            if dev.type == "cuda":
                if self.stream is None:
                    self.stream = device_loop.claim_stream(dev)
                stack.enter_context(torch.cuda.stream(self.stream))
            stack.enter_context(cuda_kernels.owned_by(self.owner))
            tracker = stack.enter_context(hostsync.track())
            before = cuda_kernels.counts(local=True)
            try:
                yield
            finally:
                if self.stream is not None:
                    self.stream.synchronize()
                after = cuda_kernels.counts(local=True)
                for k, v in after.items():
                    if v != before[k]:
                        self.launches[k] = (self.launches.get(k, 0)
                                            + v - before[k])
                self.host_syncs += tracker.count


def _load_cuda_libraries(devices):
    """Load PyTorch's lazily loaded CUDA linear-algebra library on the
    calling thread, before the cylinder threads start: its loader is not
    safe for two threads' first factorizations at once ("lazy wrapper
    should be called at most once", seen on an H100 when four cylinders
    began with a Cholesky together)."""
    for dev in {d for d in devices if d.type == "cuda"}:
        torch.linalg.cholesky_ex(torch.ones((1, 1), device=dev))


class WheelSpinner:
    """Spin a hub and list of spokes (spin_the_wheel.py:12-159).

    ``resume`` (a checkpoint file or directory; the hub option ``resume``
    otherwise) warm-starts the wheel from its newest checkpoint:
    :attr:`resumed_from` is that checkpoint's iteration.  The hub options
    may carry ``strict_spokes``: a spoke's exception then raises at
    teardown.  By default a crashed spoke is marked lost
    (:attr:`lost_spokes`, :attr:`spoke_errors`) and the wheel completes
    with whatever the remaining bounders certified.
    """

    def __init__(self, hub_dict, list_of_spoke_dict, resume=None):
        self.hub_dict = dict(hub_dict)
        self.list_of_spoke_dict = [dict(d) for d in (list_of_spoke_dict
                                                     or [])]
        self.resume = resume
        self.spun = False
        self.spoke_errors = []
        self.lost_spokes = []
        self.resumed_from = None
        self.stats = {}

    def spin(self, comm_world=None):
        """``comm_world`` is accepted for the reference's API; unused."""
        return self.run()

    def _hub_options(self) -> dict:
        return dict(self.hub_dict.get("hub_kwargs", {}).get("options")
                    or {})

    # ---- resilience ---------------------------------------------------------
    def _load_resume(self):
        """The checkpoint to warm-start from (the ``resume=`` argument
        wins over the hub option), or None for a cold start, also where
        the path holds no checkpoint yet (a retried job's first run)."""
        src = self.resume or self._hub_options().get("resume")
        if not src:
            return None
        ck = _ckpt.load_latest(src)
        if ck is None:
            global_toc(f"resume: no checkpoint under {src!r}: cold start",
                       True)
        return ck

    def _make_checkpointer(self, fresh_start: bool = False):
        """The hub option ``checkpoint_dir``'s manager, or None.
        ``fresh_start``: a cold run clears a reused directory's old
        snapshots (they would out-prune this run's and hijack a later
        resume)."""
        opts = self._hub_options()
        if not opts.get("checkpoint_dir"):
            return None
        return _ckpt.CheckpointManager(
            opts["checkpoint_dir"],
            every_secs=opts.get("checkpoint_every_secs", 60.0),
            every_iters=opts.get("checkpoint_every_iters"),
            keep=opts.get("checkpoint_keep", 3),
            fresh_start=fresh_start)

    def _wire_resilience(self, hub_comm, hub_opt):
        """Resume and checkpointing (after ``setup_hub``): the bounds
        re-seed now, the PH state at the end of the hub's Iter0
        (``PHBase._apply_resume``).  Returns the manager or None."""
        ckpt = self._load_resume()
        if ckpt is not None:
            hub_opt._resume_ckpt = ckpt
            hub_comm.seed_resume(ckpt)
            self.resumed_from = ckpt.iteration
        mgr = self._make_checkpointer(fresh_start=ckpt is None)
        if mgr is not None:
            hub_comm.attach_checkpointer(mgr)
        return mgr

    @staticmethod
    def _warn_unconsumed_resume(hub_opt):
        """A resume checkpoint nobody consumed: the opt class never ran
        ``PHBase.Iter0``, so the bounds were re-seeded but the PH state
        started cold and the iteration count did not continue."""
        if getattr(hub_opt, "_resume_ckpt", None) is not None:
            hub_opt._resume_ckpt = None
            global_toc(
                f"WARNING: resume checkpoint was NOT consumed by "
                f"{type(hub_opt).__name__} (no PHBase.Iter0 in its "
                "loop): bounds were re-seeded but PH state restarted "
                "cold and PHIterLimit did not continue from the snapshot",
                True)

    @staticmethod
    def _final_checkpoint(hub_comm, mgr):
        """Bank the end state (after the bound harvest) and drain the
        writer: a later resume of a finished run reloads its certified
        end state."""
        if mgr is None:
            return
        try:
            mgr.capture(hub_comm.current_iteration(),
                        lambda: _ckpt.capture_ph(hub_comm.opt, hub=hub_comm))
        except Exception as e:     # a capture must never cost the results
            _metrics.inc("checkpoint.capture_errors")
            global_toc(f"WARNING: final checkpoint capture failed: {e!r}",
                       True)
        mgr.close()

    def run(self):
        t_build0 = time.monotonic()
        fabric = WindowFabric()

        hub = self.hub_dict
        hub_opt = hub["opt_class"](**hub["opt_kwargs"])
        hub_comm = hub["hub_class"](
            hub_opt, 0, fabric, spokes=self.list_of_spoke_dict,
            **hub.get("hub_kwargs", {}),
        )
        spoke_comms = []
        for i, sd in enumerate(self.list_of_spoke_dict):
            opt = sd["opt_class"](**sd["opt_kwargs"])
            comm = sd["spoke_class"](opt, i + 1, fabric,
                                     **sd.get("spoke_kwargs", {}))
            to_hub_len, to_spoke_len = comm.buffer_lengths()
            fabric.add_spoke(i + 1, to_spoke_len, to_hub_len)
            spoke_comms.append(comm)
        for comm in [hub_comm] + spoke_comms:
            if comm.opt.admm_settings.sweep_mode() != "highest":
                raise NotImplementedError(
                    "a lowered sweep_precision inside a wheel is not ported "
                    "yet (ROADMAP Queue 1 item 5)")
        hub_comm.setup_hub()
        ckpt_mgr = self._wire_resilience(hub_comm, hub_opt)
        sup = _supervisor.SpokeSupervisor(
            fabric, {i + 1: type(c).__name__
                     for i, c in enumerate(spoke_comms)},
            timeout_secs=self._hub_options().get("spoke_timeout_secs"),
            grace_factor=float(self._hub_options().get(
                "spoke_timeout_grace", 8.0)))
        if spoke_comms:
            hub_comm.attach_supervisor(sup)
        global_toc(
            f"wheel constructed ({1 + len(spoke_comms)} cylinders) in "
            f"{time.monotonic() - t_build0:.1f}s", True)

        _load_cuda_libraries(c.opt.device for c in [hub_comm] + spoke_comms)
        hub_cyl = _Cylinder("hub:" + type(hub_comm).__name__, hub_comm)
        spoke_cyls = [_Cylinder(f"spoke{i + 1}:{type(c).__name__}", c)
                      for i, c in enumerate(spoke_comms)]
        errors = []
        # a new thread's OpenMP team has the default size, whatever the
        # calling thread asked for: each spoke thread takes the caller's
        nthreads = torch.get_num_threads()

        def spoke_runner(cyl, idx):
            torch.set_num_threads(nthreads)
            try:
                with cyl.running():
                    cyl.comm.main()
            except Exception as e:          # surfaced at join
                errors.append((type(cyl.comm).__name__, e))
                cyl.crashed = True
                sup.note_error(idx, e)

        threads = []
        for i, cyl in enumerate(spoke_cyls):
            t = threading.Thread(target=spoke_runner, args=(cyl, i + 1),
                                 name=cyl.name, daemon=True)
            t.start()
            threads.append(t)
            sup.note_thread(i + 1, t)

        try:
            with hub_cyl.running():
                hub_comm.main()
        finally:
            hub_comm.send_terminate()
            # construction + hub loop: gap termination happened here; the
            # spokes' teardown below is bookkeeping, not time to the gap
            self.gap_wall_secs = time.monotonic() - t_build0
        deadline = time.monotonic() + 900.0   # shared across all joins
        for i, t in enumerate(threads):
            # a lost spoke gets a short grace, not the whole deadline
            cap = (5.0 if sup.is_lost(i + 1)
                   else deadline - time.monotonic())
            t.join(timeout=max(0.0, min(cap, deadline - time.monotonic())))
        hung = [t.name for t in threads if t.is_alive()]
        if hung:
            # a spoke still running cannot finalize concurrently with its
            # main: skip its finalize, keep what the hub accepted
            global_toc(
                f"WARNING: spoke thread(s) still running at teardown "
                f"(skipping their finalize): {hung}", True)
        self.hung_spokes = hung
        self.lost_spokes = sup.lost_names()
        self.spoke_errors = list(errors)
        try:
            if errors and self._hub_options().get("strict_spokes"):
                self._final_checkpoint(hub_comm, ckpt_mgr)
                raise RuntimeError(f"Spoke failures: {errors}")
            if errors:
                global_toc(
                    f"WARNING: wheel degraded — spoke failures survived: "
                    f"{[(n, repr(e)) for n, e in errors]}", True)

            # finalize: the hub, then each spoke that ended cleanly, each
            # in its own stream; then the hub collects
            with hub_cyl.running():
                hub_comm.finalize()
            for t, cyl in zip(threads, spoke_cyls):
                if not t.is_alive() and not cyl.crashed:
                    with cyl.running():
                        cyl.comm.finalize()
            hub_comm.hub_finalize()
            self._warn_unconsumed_resume(hub_opt)
            self._final_checkpoint(hub_comm, ckpt_mgr)
        finally:
            # a hung spoke may still replay its loops: only the ended
            # cylinders' device state is freed
            for t, cyl in [(None, hub_cyl)] + list(zip(threads, spoke_cyls)):
                if t is None or not t.is_alive():
                    if cyl.owned:
                        device_loop.release(cyl.owner)
                    if cyl.stream is not None:
                        device_loop.free_stream(cyl.stream)

        self.spcomm = hub_comm
        self.opt = hub_opt
        self.spoke_comms = spoke_comms
        self.spun = True
        self.stats = {
            c.name: {"launches": dict(c.launches),
                     "host_syncs": c.host_syncs,
                     "solves": c.comm.opt.solves,
                     "rescued": c.comm.opt.rescued_scenarios,
                     "stream": (None if c.stream is None
                                else c.stream.cuda_stream)}
            for c in [hub_cyl] + spoke_cyls}
        self.BestInnerBound = hub_comm.BestInnerBound
        self.BestOuterBound = hub_comm.BestOuterBound
        self.local_nonant_cache = self._best_nonant_cache()
        return self

    # ---- solution access (spin_the_wheel.py:166-217) ------------------------
    def _best_nonant_cache(self):
        """(S, K) nonants of the best incumbent seen anywhere in the
        wheel."""
        best = getattr(self.opt, "best_xhat_cache", None)  # in-hub xhat ext
        best_val = getattr(self.opt, "best_inner_bound", np.inf)
        for comm in self.spoke_comms:
            if hasattr(comm, "best_snapshot"):
                v, cand = comm.best_snapshot()
                if cand is not None and v < best_val:
                    best_val = v
                    best = self.opt.nonants_of(cand)
        if best is None and self.opt.local_x is not None:
            best = self.opt.nonants_of(self.opt.local_x)
        return None if best is None else np.asarray(best)

    def write_first_stage_solution(self, solution_file_name: str):
        """CSV (or .npy) of root-stage nonant values (sputils.py:37-68)."""
        cache = self.local_nonant_cache
        if cache is None:
            raise RuntimeError("No solution available to write")
        tree = self.opt.tree
        root_slots = np.where(tree.nonant_stage == 1)[0]
        vals = cache[0, root_slots]
        if solution_file_name.endswith(".npy"):
            np.save(solution_file_name, vals)
            return
        var_names = self.opt.batch.var_names
        idx = tree.nonant_indices[root_slots]
        with open(solution_file_name, "w", newline="") as f:
            w = csv.writer(f)
            for j, v in zip(idx, vals):
                nm = var_names[j] if var_names else f"x[{j}]"
                w.writerow([nm, repr(float(v))])

    def write_tree_solution(self, directory_name: str):
        """One CSV a scenario (or bundle) of its nonant values, named by
        slot (spin_the_wheel.py:199-217)."""
        os.makedirs(directory_name, exist_ok=True)
        cache = self.local_nonant_cache
        if cache is None:
            raise RuntimeError("No solution available to write")
        for s, name in enumerate(self.opt.all_scenario_names):
            with open(os.path.join(directory_name, f"{name}.csv"), "w",
                      newline="") as f:
                w = csv.writer(f)
                for k in range(cache.shape[1]):
                    w.writerow([f"nonant[{k}]", repr(float(cache[s, k]))])


def spin_the_wheel(hub_dict, list_of_spoke_dict, comm_world=None):
    """Functional alias kept for the reference's API."""
    ws = WheelSpinner(hub_dict, list_of_spoke_dict)
    ws.spin(comm_world)
    global_toc("Spinning complete", True)
    return ws


class MultiprocessWheelSpinner(WheelSpinner):
    """The reference's spinner with spokes in separate OS processes over
    its window services: not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "MultiprocessWheelSpinner: the multiprocess spinner and its "
            "window services are not ported yet (ROADMAP Queue 1 item 7)")
