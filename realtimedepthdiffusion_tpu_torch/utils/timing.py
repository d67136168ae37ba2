"""Per-stage timing, spans, counters and structured logging (port of
``realtimedepthdiffusion_tpu/utils/timing.py``).

Every pipeline stage can be timed on the host's clock, accumulated and
reported. CUDA work is queued, not run, when a call returns, so a timer
that was given a CUDA device waits for that device at the end of each
stage. A span is timed on the host's clock with no wait, and a counter
counts; both accumulate in the same timer. While a ``torch.profiler``
runs, every stage and span is also a range on the profiler's timeline,
which the device trace shares, so the host's spans name what the card was
waiting on. ``device_trace`` wraps a region in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

logger = logging.getLogger("rtdd")

# Whether a ``torch.profiler`` is recording.
profiling = torch.autograd._profiler_enabled


class span:
    """``with span(name, timer):`` a span on the host's clock, with no
    device sync: its seconds add to ``timer.totals[name]`` and one to
    ``timer.counts[name]``, so a span's count is also its counter. While a
    ``torch.profiler`` runs it is also a ``record_function`` range named
    ``name`` (``args`` is the range's argument string); with none running,
    ``record_function`` is not entered at all, since it costs several times
    the span itself. With ``timer=None``, the profiler's range alone."""

    __slots__ = ("name", "timer", "args", "_t0", "_range")

    def __init__(self, name: str, timer: Optional["StageTimer"] = None,
                 args: Optional[str] = None) -> None:
        self.name, self.timer, self.args = name, timer, args

    def __enter__(self) -> "span":
        self._range = None
        if profiling():
            self._range = torch.profiler.record_function(self.name, self.args)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        if self.timer is not None:
            self.timer.totals[self.name] += time.perf_counter() - self._t0
            self.timer.counts[self.name] += 1
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class StageTimer:
    """Accumulating wall-clock stage timer, spans and counters. With a CUDA
    ``device`` a stage ends when the device has finished the work queued in
    it (``torch.cuda.synchronize``); without one, when the host returns.
    On the profiler's timeline a stage is named ``prefix + name``."""

    def __init__(self, device=None, prefix: str = "") -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.counters: set = set()  # the names that ``count`` keeps
        self.prefix = prefix
        self.sync = None
        if device is not None:
            device = torch.device(device)
            if device.type == "cuda":
                self.sync = lambda: torch.cuda.synchronize(device)

    @contextlib.contextmanager
    def stage(self, name: str, args: Optional[str] = None) -> Iterator[None]:
        with span(self.prefix + name, None, args):
            t0 = time.perf_counter()
            try:
                yield
                if self.sync is not None:
                    self.sync()
            finally:
                dt = time.perf_counter() - t0
                self.totals[name] += dt
                self.counts[name] += 1
                logger.debug("stage %s: %.3f ms", name, dt * 1000)

    def span(self, name: str) -> span:
        """A span (the module's ``span``) that this timer accumulates."""
        return span(name, self)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``; its ``totals`` entry stays 0.0,
        so that a reader of ``totals`` finds it beside the spans."""
        self.counters.add(name)
        self.totals[name] += 0.0
        self.counts[name] += n

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            if name in self.counters:
                lines.append(f"  {name}: {n}")
                continue
            tot = self.totals[name] * 1000
            lines.append(f"  {name}: {tot:.2f} ms total / {n} calls = {tot / n:.2f} ms")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.counters.clear()


@contextlib.contextmanager
def device_trace(out_dir: str, device=None) -> Iterator[None]:
    """Wrap a region in a ``torch.profiler`` trace: of the host, and of the
    card when ``device`` names a CUDA device (it is waited for before the
    trace closes). On exit ``out_dir/trace.json`` holds the trace in
    Chrome's format (chrome://tracing, Perfetto), with the stages and spans
    of every ``StageTimer`` and ``span`` entered inside it."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    on_card = device is not None and torch.device(device).type == "cuda"
    if on_card:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(out_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if on_card:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
