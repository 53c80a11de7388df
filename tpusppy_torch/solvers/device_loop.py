"""The solve cores' sweep loop on the device.

The port's counterpart of the reference's ``lax.while_loop`` in
``tpusppy/solvers/admm.py`` (``_admm_core``) and
``tpusppy/solvers/shared_admm.py`` (``_core``); it has no module twin
there.  A solve core hands :func:`run` a *block*: a function that runs one
``check_every`` block of sweeps and its bookkeeping, in place on a state
held in tensors, and ends with the exit vote.  The state's last tensor is
the stop flag, a 0-dim int32 that stays set once set.  The block's sweep
kernel returns at once where the flag is set, and the block commits every
state tensor through ``torch.where(stop, old, new)``, so a block past the
loop's exit changes nothing: running blocks past the stop gives, bit for
bit, what stopping at once gives.

A block's *phase* is what it does beside the sweeps that not every block
does (the engines' gamma and plateau rules, which fall every so many
blocks).  A run starts at block 0, so the host knows each block's index
and phase: a replay of ``L`` blocks is a *pattern* of ``L`` phases, and
each rule runs only in the blocks where it falls, with no device mask.
The last replay before the sweep cap holds only the blocks left under it
(a shorter pattern), so a run that reaches its cap runs no block past
it.

On a CUDA device :func:`run` captures one CUDA graph of ``L`` blocks for
each pattern its run needs, once per key, and replays them; a later call
with the same key copies its inputs (every floating-point tensor of its
operands, new factors included) into the graphs' buffers and replays the
same graphs.  The host reads the 4-byte flag once a replay, with the next
replay already queued (the reference's pipelined continuation,
``tpusppy/solvers/segmented.py`` ``_continue_frozen_pipelined``, moved
into the loop: blocks past the stop are no-ops, so the speculative replay
needs no discard).  The loop runs at most ``L - 1`` gated blocks past its
exit in the replay that sets the flag, and one speculative replay of ``L``
more.  A capture or a replay that fails raises; nothing falls back to a
host loop.

On the CPU the same blocks run eagerly, ``L`` a replay, with the same
replay queued ahead of each flag read, so the CPU tests hold the graph
body and the protocol themselves.

Several cylinders of a wheel run solves at once, each on a thread and a
CUDA stream of its own.  A captured loop belongs to its owner
(:func:`.cuda_kernels.current_owner`: the cylinder's token, else the
calling thread) and is keyed by it, so two cylinders of the same shapes
never share buffers or graphs; each owner keeps its own ``CACHE_SIZE``
loops, so no owner evicts another's, and :func:`release` frees an owner's
loops when its cylinder ends.  A capture runs on a capture stream of the
calling thread, claimed (:func:`claim_stream`) so that no other thread's
stream is the same, in ``capture_error_mode="thread_local"`` (another
thread's allocation or synchronisation during it is no fault), never
beside a call that another thread's capture makes fail
(:func:`outside_capture`), and records the launches of the capturing
thread alone (``cuda_kernels.counts(local=True)``).

A PH megastep window (:mod:`..parallel.sharded`) runs several frozen
solves, one a PH iteration, with the iteration's other steps between them
(the objective assembly, the acceptance test, the PH update and the stats
write) as a :class:`Program`: steps captured once per owner and signature
into CUDA graphs over buffers the program holds, and replayed.  The
window's stop word (:class:`Gate`) rides the stop flag of every frozen
solve run inside :func:`gated`: :func:`run` ORs it into the solve's
initial flag (:data:`WINDOW_BIT`), so a solve after the window's stop
sweeps nothing and commits nothing, and the flag read the loop makes
anyway tells the host that the window has stopped.  A window reads nothing else until its
packed fetch.

Counters: ``device_loop.captures`` (graphs captured) and
``device_loop.capture_secs`` (host time of the captures and their
warm-ups), ``device_loop.warmups`` (blocks run with the flag set before a
capture), ``device_loop.replays``, ``device_loop.blocks`` (blocks replayed,
gated ones included) and, one per flag read, ``admm.loop_checks`` (each
also a ``host_sync.count``).
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import weakref

import torch

from ..obs import metrics as _metrics
from . import cuda_kernels, hostsync
from .sparse import SparseA

_LOOP_CHECKS = _metrics.counter("admm.loop_checks")
_CAPTURES = _metrics.counter("device_loop.captures")
_CAPTURE_SECS = _metrics.counter("device_loop.capture_secs")
_WARMUPS = _metrics.counter("device_loop.warmups")
_REPLAYS = _metrics.counter("device_loop.replays")
_BLOCKS = _metrics.counter("device_loop.blocks")

#: Captured loops kept per owner (least recently used dropped first); each
#: holds its graphs' memory pools and its buffers.  A lowered PH run keys
#: four loops on one engine (the refresh, the lowered phase, the
#: refinement phase and the guard's full-precision re-run), and an owner
#: may drive several.
CACHE_SIZE = 8

#: owner -> OrderedDict of signature -> _Captured.
_cache: dict = {}
_cache_lock = threading.Lock()
_local = threading.local()

#: Held by a capture from its warm-up to its end, and by
#: :func:`outside_capture` around the calls that fail on the card while
#: another thread captures, in thread_local mode too: a batched
#: ``torch.linalg.solve_ex`` raises "operation not permitted when stream is
#: capturing" there (a wheel's hub polishing while its spokes captured).
_capture_lock = threading.RLock()

#: Draws from PyTorch's stream pool before :func:`claim_stream` gives up
#: (two turns of its 32 streams a priority).
STREAM_DRAWS = 64
#: ``cuda_stream`` handles of the streams claimed and not yet freed.
_claimed: set = set()
_claim_lock = threading.Lock()

#: The bit a window's stop word sets in the stop flag of a frozen solve
#: inside the window (a solve's own vote sets bit 0).
WINDOW_BIT = 2


class Gate:
    """A megastep window's stop word as the frozen solves inside the window
    carry it: ``word`` is a 0-dim int32 device tensor, :data:`WINDOW_BIT`
    once the window has stopped, else 0.  :func:`run` ORs it into a
    solve's initial stop flag and sets ``seen`` when a flag read carries
    the bit, so the window's host loop stops issuing iterations without a
    read of its own."""

    __slots__ = ("word", "seen")

    def __init__(self, word):
        self.word = word
        self.seen = False


@contextlib.contextmanager
def gated(gate: Gate):
    """Run the body's sweep loops (on the calling thread) under the
    window stop word of ``gate``."""
    prev = getattr(_local, "gate", None)
    _local.gate = gate
    try:
        yield
    finally:
        _local.gate = prev


def commit(stop: torch.Tensor, state, new):
    """Write ``new`` into the ``state`` tensors where ``stop`` (a 0-dim
    bool) is clear; keep the old values where it is set.  A state tensor
    handed back as its own new value is left alone."""
    for old, nw in zip(state, new):
        if nw is not old:
            torch.where(stop, old, nw, out=old)


def raise_flag(flag: torch.Tensor, vote: torch.Tensor):
    """Set the stop flag where ``vote`` (a 0-dim bool) is true; a set flag
    stays set."""
    flag.bitwise_or_(vote)


def run(block, ops, state, blocks_per_replay, max_blocks, key, phase):
    """Run ``block(ops, state, phase(b))`` for blocks ``b = 0, 1, ...``
    until the stop flag ``state[-1]`` is set.

    ``ops`` is a tuple of operands.  Their floating-point tensors, also
    inside tuples (NamedTuples: factor operators) and :class:`SparseA`
    values, are inputs that a captured graph reads from buffers of its
    own, refilled at every call; the rest (index arrays, structure, other
    objects) is held by the graph as it is and keys it by identity.
    ``state`` is the initial state (not written).  The block must read
    nothing but ``ops``, ``state`` and its phase besides what ``key``
    names.  ``phase(b)``: block ``b``'s phase, a hashable host value that
    ``key`` determines.  ``max_blocks``: the block count at which the
    block's own vote sets the flag (the sweep cap), so no replay runs past
    it.  Inside :func:`gated`, the window's stop word is ORed into the
    initial flag.  Returns the final state as new tensors."""
    gate = getattr(_local, "gate", None)
    L = max(1, int(blocks_per_replay))
    nb = max(0, int(max_blocks))
    plan = [tuple(map(phase, range(j, min(j + L, nb))))
            for j in range(0, nb, L)]
    if state[-1].device.type != "cuda":
        work = [t.clone() for t in state]
        if gate is not None:
            work[-1].bitwise_or_(gate.word)

        def replay(j):
            for ph in plan[j]:
                block(ops, work, ph)

        queued = _drive(replay, lambda: hostsync.fetch_async(work[-1]),
                        len(plan), gate)
    else:
        entry = _entry(block, ops, state, L, key)
        entry.prepare(plan)
        entry.load(ops, state)
        if gate is not None:
            entry.state[-1].bitwise_or_(gate.word)
        queued = _drive(lambda j: entry.replay(plan[j]), entry.read_flag,
                        len(plan), gate)
        work = [t.clone() for t in entry.state]
    _REPLAYS.inc(queued)
    _BLOCKS.inc(sum(len(p) for p in plan[:queued]))
    return work


def _drive(replay, read_flag, replays, gate=None) -> int:
    """Replay until a flag read says stop or all ``replays`` have run,
    reading each replay's flag with the next replay already queued (a read
    that carries :data:`WINDOW_BIT` sets ``gate.seen``).  Returns the
    replays queued."""
    if replays < 1:
        return 0
    replay(0)
    queued = 1
    for _ in range(replays):
        pending = read_flag()
        spec = queued < replays
        if spec:
            replay(queued)
            queued += 1
        flag = int(pending.result(overlapped=spec))
        _LOOP_CHECKS.inc()
        if gate is not None and flag & WINDOW_BIT:
            gate.seen = True
        if flag:
            break
    return queued


def _values(v) -> list:
    """The floating-point tensors of an operand, in walk order."""
    if isinstance(v, torch.Tensor):
        return [v] if v.is_floating_point() else []
    if isinstance(v, SparseA):
        return list(v.values())
    if isinstance(v, tuple):
        return [t for c in v for t in _values(c)]
    return []


def _skeleton(v):
    """What keys a graph in an operand: the shape, type and device of its
    floating-point tensors, and the identity of everything else."""
    if isinstance(v, torch.Tensor):
        return (("t", tuple(v.shape), v.dtype, v.device)
                if v.is_floating_point() else ("id", id(v)))
    if isinstance(v, SparseA):
        return ("sparse", id(v.rows), tuple(_skeleton(t) for t in
                                            v.values()))
    if isinstance(v, tuple):
        return (type(v),) + tuple(_skeleton(c) for c in v)
    return ("id", id(v))


def _rebuild(v, bufs):
    """``v`` with its floating-point tensors taken, in walk order, from the
    iterator ``bufs``."""
    if isinstance(v, torch.Tensor):
        return next(bufs) if v.is_floating_point() else v
    if isinstance(v, SparseA):
        return v.with_values(*(next(bufs) for _ in v.values()))
    if isinstance(v, tuple):
        parts = [_rebuild(c, bufs) for c in v]
        return type(v)(*parts) if hasattr(v, "_fields") else tuple(parts)
    return v


def _signature(ops, state, L, key):
    return (key, L, _skeleton(tuple(ops)),
            tuple((tuple(t.shape), t.dtype, t.device) for t in state))


def _entry(block, ops, state, L, key):
    """The calling owner's captured loop for this signature."""
    return _owned(_signature(ops, state, L, key),
                  lambda: _Captured(block, ops, state))


def _owned(sig, make):
    """The calling owner's cache entry for ``sig`` (``make()``, and the
    owner's least recently used entry dropped past ``CACHE_SIZE``, on a
    miss)."""
    owner = cuda_kernels.current_owner()
    with _cache_lock:
        loops = _cache.setdefault(owner, collections.OrderedDict())
        entry = loops.get(sig)
        if entry is not None:
            loops.move_to_end(sig)
            return entry
    entry = make()
    with _cache_lock:
        loops = _cache.setdefault(owner, collections.OrderedDict())
        loops[sig] = entry
        while len(loops) > CACHE_SIZE:
            loops.popitem(last=False)
    return entry


def program(key, templates: dict, gate: str):
    """The calling owner's :class:`Program` for ``key`` and the shapes of
    ``templates`` (name -> tensor), made from them on a miss; it takes a
    slot of the owner's ``CACHE_SIZE``."""
    sig = ("program", key, tuple((k, tuple(t.shape), t.dtype, t.device)
                                 for k, t in templates.items()))
    return _owned(sig, lambda: Program(templates, gate))


def release(token):
    """Free every captured loop and kernel operand of the owner
    ``token`` (a cylinder that has ended)."""
    with _cache_lock:
        _cache.pop(token, None)
    cuda_kernels.release_operands(token)


@contextlib.contextmanager
def outside_capture(device):
    """Run the body while no thread of the process captures a graph (a
    no-op off the card)."""
    if device.type != "cuda":
        yield
        return
    with _capture_lock:
        yield


def claim_stream(dev, make=None):
    """A CUDA stream on ``dev`` that no other claimant holds until
    :func:`free_stream`.  ``torch.cuda.Stream()`` hands out the streams of
    a fixed pool in turn, so two streams made far apart can be one and the
    same: a cylinder's stream could be another thread's capture stream,
    and its work would then be issued into that capture.  ``make``: the
    stream factory (default ``torch.cuda.Stream(dev)``)."""
    make = make or (lambda: torch.cuda.Stream(dev))
    with _claim_lock:
        for _ in range(STREAM_DRAWS):
            s = make()
            if s.cuda_stream not in _claimed:
                _claimed.add(s.cuda_stream)
                return s
    raise RuntimeError(f"no free CUDA stream on {dev} in {STREAM_DRAWS} "
                       f"draws from the pool ({len(_claimed)} claimed)")


def free_stream(s):
    """End the claim on ``s`` (from :func:`claim_stream`)."""
    with _claim_lock:
        _claimed.discard(s.cuda_stream)


def _capture_stream(dev):
    """The calling thread's capture stream on ``dev``, claimed until the
    thread's object is gone."""
    streams = getattr(_local, "streams", None)
    if streams is None:
        streams = _local.streams = {}
    s = streams.get(dev)
    if s is None:
        s = streams[dev] = claim_stream(dev)
        weakref.finalize(threading.current_thread(), free_stream, s)
    return s


def _buffer(t):
    return torch.empty(t.shape, dtype=t.dtype, device=t.device).copy_(t)


class _Captured:
    """One captured loop: the buffers its graphs read and write, a graph
    and the kernel launches one replay of it makes for each pattern, and
    the pinned flag buffer."""

    def __init__(self, block, ops, state):
        self.block = block
        # the operands are held (the identity of their index arrays and
        # objects keys the graphs), their values copied into buffers
        self.held = ops
        self.values = [_buffer(t) for t in _values(tuple(ops))]
        self.ops = _rebuild(tuple(ops), iter(self.values))
        self.state = [_buffer(t) for t in state]
        self._fresh = True
        self.graphs = {}
        self.pinned = torch.empty((), dtype=torch.int32, pin_memory=True)
        self.event = torch.cuda.Event()

    def prepare(self, plan):
        """Capture the graph of every pattern in ``plan`` not captured
        yet (before :meth:`load`: a capture's warm-up writes the flag)."""
        for pattern in dict.fromkeys(plan):
            if pattern not in self.graphs:
                self._capture(pattern)

    def _capture(self, pattern):
        t0 = time.perf_counter()
        dev = self.state[-1].device
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with _capture_lock, torch.cuda.stream(stream):
            # warm-up: one block of each phase with the flag set runs
            # every lazy set-up (libraries, handles, kernel attributes)
            # outside the capture, and changes no state
            self.state[-1].fill_(1)
            phases = list(dict.fromkeys(pattern))
            for ph in phases:
                self.block(self.ops, self.state, ph)
            before = cuda_kernels.counts(local=True)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                for ph in pattern:
                    self.block(self.ops, self.state, ph)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        # the launches captured did not run: each replay counts them
        after = cuda_kernels.counts(local=True)
        delta = {k: after[k] - before[k] for k in after
                 if after[k] != before[k]}
        cuda_kernels.add_counts({k: -v for k, v in delta.items()})
        self.graphs[pattern] = (graph, delta)
        _WARMUPS.inc(len(phases))
        _CAPTURES.inc()
        _CAPTURE_SECS.inc(time.perf_counter() - t0)

    def load(self, ops, state):
        """Copy a call's inputs and initial state into the buffers."""
        if not self._fresh:
            for buf, t in zip(self.values, _values(tuple(ops))):
                buf.copy_(t)
        self._fresh = False
        for buf, t in zip(self.state, state):
            buf.copy_(t)

    def replay(self, pattern):
        graph, delta = self.graphs[pattern]
        graph.replay()
        cuda_kernels.add_counts(delta)

    def read_flag(self):
        return hostsync.fetch_async(self.state[-1], out=self.pinned,
                                    event=self.event)


class Program:
    """Steps captured over buffers the program holds (a megastep window's
    per-iteration steps).  ``bufs`` are copies of the templates, refilled
    with :meth:`load`; a step ``fn(bufs)`` reads and writes buffers alone
    and, while ``bufs[gate]`` is nonzero, writes none but its scratch and
    the gate itself.  On CUDA each step is captured into a graph at its
    first run (after a warm-up run with the gate set, which changes
    nothing) and replayed from then on; on the CPU it runs eagerly."""

    def __init__(self, templates: dict, gate: str):
        self.bufs = {k: _buffer(t) for k, t in templates.items()}
        self.gate = gate
        self.graphs = {}

    def load(self, values: dict):
        """Copy ``values`` (name -> tensor) into the buffers."""
        for k, v in values.items():
            self.bufs[k].copy_(v)

    def run(self, name, fn):
        """Run the step ``fn`` under ``name`` (replay its graph on CUDA)."""
        if self.bufs[self.gate].device.type != "cuda":
            fn(self.bufs)
            return
        graph = self.graphs.get(name)
        if graph is None:
            graph = self.graphs[name] = self._capture(fn)
        graph.replay()

    def _capture(self, fn):
        t0 = time.perf_counter()
        word = self.bufs[self.gate]
        dev = word.device
        stream = _capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with _capture_lock, torch.cuda.stream(stream):
            held = word.clone()
            word.fill_(WINDOW_BIT)
            fn(self.bufs)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                fn(self.bufs)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass
                raise
            graph.capture_end()
            word.copy_(held)
        torch.cuda.current_stream(dev).wait_stream(stream)
        _WARMUPS.inc()
        _CAPTURES.inc()
        _CAPTURE_SECS.inc(time.perf_counter() - t0)
        return graph
