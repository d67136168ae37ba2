"""The traced run's record, taken from a ``torch.profiler`` trace.

``record(prof, window_name)`` reduces the profiler's events to what the
per-layer readers (``metrics/*.py``) read: each device operation (kernel,
memcpy, memset) with its start and length, the union of their intervals
(``busy_s``) inside the benchmark's window span, the device time by
operation, and the idle gaps labelled by what the host was doing.
"""

from __future__ import annotations

import collections
import re

def bare_name(name: str) -> str:
    """A kernel's name without its namespace, template and argument list;
    a copy's or a fill's name as it is."""
    if kind_of(name) != "kernel":
        return name
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ").strip()
    head = re.split(r"[<(]", name)[0].strip()
    return head.split("::")[-1] or name


def kind_of(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def union(intervals):
    """Merged (start, end) intervals of ``intervals``, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def record(events, window_name: str, is_device):
    """The record of a traced window from profiler events (``prof.events()``,
    or any objects with ``name``, ``time_range.start``/``.end`` in us).
    ``is_device(e)`` says whether an event ran on the device. The window
    is the host span named ``window_name``; its length is ``window_s``."""
    win = [e for e in events if e.name == window_name]
    if not win:
        raise RuntimeError(f"the trace holds no span {window_name!r}")
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    device, host = [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if is_device(e):
            if t > w0 and s < w1:
                device.append((e.name, max(s, w0), min(t, w1)))
        elif e.name != window_name and t > w0 and s < w1:
            host.append((e.name, s, t))
    busy = union([(s, t) for _, s, t in device])
    busy_us = sum(t - s for s, t in busy)
    by_op = collections.Counter()
    for name, s, t in device:
        by_op[bare_name(name)] += (t - s) / 1e6
    gaps = collections.Counter()
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    mids = [((edges[i] + edges[i + 1]) / 2, edges[i + 1] - edges[i])
            for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    for label, us in zip(_host_labels(host, [m for m, _ in mids]), [g for _, g in mids]):
        gaps[label] += us / 1e6
    return {
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_us / 1e6,
        "device": [(bare_name(n), kind_of(n), (t - s) / 1e6) for n, s, t in device],
        "device_ops": [[k, v] for k, v in by_op.most_common(10)],
        "idle_gaps": [[k, v] for k, v in gaps.most_common(10)],
    }


def _host_labels(host, times):
    """What the host was doing at each of the ascending ``times``: the
    benchmark's own span around it (``bench.*``), then the innermost other
    host event (the one that started last), as "span/op"."""
    host = sorted(host, key=lambda h: h[1])
    active, nxt, out = [], 0, []
    for t in times:
        while nxt < len(host) and host[nxt][1] <= t:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[2] >= t]
        span = inner = None
        for name, _, _ in active:
            if name.startswith("bench."):
                span = name[6:]
            else:
                inner = name
        parts = [p for p in (span, inner) if p]
        out.append("/".join(parts) if parts else "none")
    return out


def device_seconds(rec, pattern: str) -> float:
    """Device seconds of the operations whose bare name matches ``pattern``."""
    rx = re.compile(pattern)
    return sum(d for n, _, d in rec["device"] if rx.search(n))
