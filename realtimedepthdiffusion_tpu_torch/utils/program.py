"""A function captured once into a CUDA graph and replayed: the port's
counterpart of a ``jax.jit`` executable (``pipeline.py``'s programs, the
sharded step of ``parallel/sharded.py:batched_step``).

A call's arguments are a flat tuple whose items are tensors or tuples of
tensors (a pyramid, a depth state); ``signature`` keys a program by their
structure, shapes, dtypes and devices.
"""

from __future__ import annotations

import collections
import gc
import time

import torch

from .. import ops
from ..core.solver import read_exit_log
from ..ops import defocus, dispatch
from .timing import span


def leaves(args) -> list:
    """The tensors of a call's arguments, a tuple of tensors standing for
    its tensors (the pyramids)."""
    out = []
    for a in args:
        out.extend(a if isinstance(a, (tuple, list)) else (a,))
    return out


def signature(args):
    """(the arguments' structure, each leaf's shape, dtype and device), or
    None where a leaf is not a tensor."""
    flat = leaves(args)
    if not all(isinstance(t, torch.Tensor) for t in flat):
        return None
    return (tuple(len(a) if isinstance(a, (tuple, list)) else None for a in args),
            tuple((tuple(t.shape), t.dtype, t.device) for t in flat))


def map_tensors(fn, tree):
    """``fn`` on every tensor of a (possibly nested) tuple."""
    if isinstance(tree, (tuple, list)):
        return tuple(map_tensors(fn, t) for t in tree)
    return fn(tree)


def fresh(tree):
    """A copy of every tensor of ``tree``; a tensor that stands twice is
    copied once, and both places get that copy."""
    copies = {}

    def one(t):
        if id(t) not in copies:
            copies[id(t)] = t.clone()
        return copies[id(t)]

    return map_tensors(one, tree)


class Program:
    """One program: ``fn(*args, exit_log)`` for the arguments' signature.
    On a card, the call captured once into a CUDA graph that reads static
    copies of the arguments, each on ``device`` (a host centre's too), in
    the contiguous layout (an ``expand`` view becomes a full tensor); each
    call copies its arguments in, replays the graph and returns fresh
    copies of the outputs, so that no later replay changes a tensor a
    caller holds. Outputs that are one tensor (depth0 and level 0 of the
    state) stay one. Under the early exit the capture keeps the levels'
    device counts (``core/solver.py:_chunked_early_exit``), and a call
    given an ``exit_log`` reads them after its replay. On the CPU, the
    eager function itself.

    The capture runs on the caller's thread, on a side stream, into the
    memory pool ``pool``, in ``thread_local`` mode: a CUDA call that is
    unsafe during a capture fails it only when it comes from this thread,
    while the server's IO threads and a prewarm thread go on. The kernel
    wrappers count what the capture would have launched; those counts are
    taken back out, and each replay adds them (``ops.add_launches``). So
    do ``counter``, a ``collections.Counter`` that ``fn`` adds to (the
    sharded step's ``block_calls``), and, in every program,
    ``ops/dispatch.py:smooth_passes``, the V-cycle's smoothing passes by
    route, and ``ops/defocus.py:render_counts``, the defocus renders.

    Spans (``utils/timing.py``; in ``timer`` where one is given, on a
    running profiler's timeline always): ``program.capture`` around the
    capture, and per call ``program.copy_in``, ``program.replay`` and
    ``program.copy_out``, or ``program.eager`` for the eager function on
    the CPU."""

    def __init__(self, fn, args, device: torch.device, pool=None, stream=None, counter=None,
                 timer=None):
        self.fn = fn
        self.timer = timer
        self.sig = signature(args)
        self.graph = None
        self.tally = {}
        # The counters ``fn`` adds to, and what the capture added to each.
        self.counters = [dispatch.smooth_passes, defocus.render_counts] + (
            [counter] if counter is not None else [])
        self.counted = [collections.Counter() for _ in self.counters]
        self.capture_s = 0.0
        if device.type != "cuda":
            return
        # A graph holds no reference to its owner (``fn`` is often a bound
        # method of it), so an owner dropped by its caller goes at once
        # rather than to the cyclic collector, which could otherwise destroy
        # its graphs in the middle of another capture, an operation that
        # invalidates that capture. The collector is held off during a
        # capture for the same reason.
        self.fn = None
        t0 = time.perf_counter()
        collecting = gc.isenabled()
        gc.disable()
        try:
            with span("program.capture", timer), torch.cuda.device(device):
                self.static_in = map_tensors(lambda t: torch.empty_like(
                    t, device=device, memory_format=torch.contiguous_format), args)
                self.sig = signature(self.static_in)
                self.static_log = []
                graph = torch.cuda.CUDAGraph()
                before = ops.launch_counts()
                counters_before = [collections.Counter(c) for c in self.counters]
                with torch.cuda.graph(graph, pool=pool, stream=stream,
                                      capture_error_mode="thread_local"):
                    self.static_out = fn(*self.static_in, self.static_log)
                after = ops.launch_counts()
        finally:
            if collecting:
                gc.enable()
        self.tally = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        ops.add_launches({k: -n for k, n in self.tally.items()})
        self.counted = [collections.Counter(c) - b for c, b in zip(self.counters, counters_before)]
        for c, n in zip(self.counters, self.counted):
            c.subtract(n)
        self.graph, self.device = graph, device
        self.capture_s = time.perf_counter() - t0

    def matches(self, args) -> bool:
        return self.sig is not None and signature(args) == self.sig

    def __call__(self, args, exit_log=None, wait: bool = True):
        """Replay for ``args``; under the early exit a list given as
        ``exit_log`` receives the replay's counts, read as
        ``read_exit_log(exit_log, wait)`` reads them."""
        if self.graph is None:
            with span("program.eager", self.timer):
                return self.fn(*args, exit_log)
        with torch.cuda.device(self.device):
            with span("program.copy_in", self.timer):
                for dst, src in zip(leaves(self.static_in), leaves(args)):
                    dst.copy_(src)
            with span("program.replay", self.timer):
                self.graph.replay()
            ops.add_launches(self.tally)
            for c, n in zip(self.counters, self.counted):
                c.update(n)
            if exit_log is not None:
                # The replay's own counts, copied now, before a later
                # replay writes them again.
                exit_log.extend(dict(e) for e in self.static_log)
                read_exit_log(exit_log, wait)
            with span("program.copy_out", self.timer):
                return fresh(self.static_out)
