"""Per-stage timing and structured logging (port of ``realtimedepthdiffusion_tpu/utils/timing.py``).

Every pipeline stage can be timed on the host's clock, accumulated and
reported. CUDA work is queued, not run, when a call returns, so a timer
that was given a CUDA device waits for that device at the end of each
stage. ``device_trace`` wraps a region in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from typing import Dict, Iterator

logger = logging.getLogger("rtdd")


class StageTimer:
    """Accumulating wall-clock stage timer. With a CUDA ``device`` a stage
    ends when the device has finished the work queued in it
    (``torch.cuda.synchronize``); without one, when the host returns."""

    def __init__(self, device=None) -> None:
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync = None
        if device is not None:
            import torch

            device = torch.device(device)
            if device.type == "cuda":
                self.sync = lambda: torch.cuda.synchronize(device)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
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

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            n = self.counts[name]
            tot = self.totals[name] * 1000
            lines.append(f"  {name}: {tot:.2f} ms total / {n} calls = {tot / n:.2f} ms")
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(out_dir: str, device=None) -> Iterator[None]:
    """Wrap a region in a ``torch.profiler`` trace: of the host, and of the
    card when ``device`` names a CUDA device (it is waited for before the
    trace closes). On exit ``out_dir/trace.json`` holds the trace in
    Chrome's format (chrome://tracing, Perfetto)."""
    import torch

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
