"""The port's spans and counters (``utils/timing.py``) and where the port
records them: the recorder's semantics; no ``record_function`` entered
while no profiler runs; under ``torch.profiler`` (CPU activity) the
session's, the program layer's and the server's spans on the profiler's
clock, nested in the caller's range, as ``benchmark/trace.py`` labels
them; the early exit's and the upload's counters under a profiler only;
and the same outputs, bit for bit, with tracing on and off."""

import os

import numpy as np
import pytest
import torch

from benchmark import trace
from realtimedepthdiffusion_tpu_torch import io
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import solver
from realtimedepthdiffusion_tpu_torch.live.session import DepthSession
from realtimedepthdiffusion_tpu_torch.pipeline import DepthPipeline
from realtimedepthdiffusion_tpu_torch.serve import discover_pairs, solve_pairs
from realtimedepthdiffusion_tpu_torch.utils import timing
from tests.conftest import synthetic_pair

H, W = 96, 128
CONFIGS = {
    # the Jacobi-Chebyshev cascade, no early exit, no windowed path
    "faithful": dict(max_iterations=60),
    # red-black under the early exit, with the windowed re-solve
    "fast": dict(solver="red_black", early_exit=True, residual_check_every=5, tolerance=1e-3,
                 max_iterations=60, incremental_iterations=20, incremental_window=32,
                 fast_start=True),
    # the V-cycle: the cascade, then the polish in its span
    "vcycle": dict(max_iterations=60, multigrid="vcycle"),
}
# Per update: the drag's events (x, y); small, so that the fast config's
# later updates take the windowed path.
STROKES = [[(40, 40), (42, 41)], [(60, 50), (62, 50)], [(64, 52), (66, 53)],
           [(68, 54), (70, 55)]]
SERVE_SPANS = ["serve.decode_wait", "serve.upload", "serve.dispatch", "serve.readback_wait",
               "serve.encode_wait"]


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _session(name):
    rgb, _, _ = synthetic_pair(H, W, 5)
    s = DepthSession(rgb, DiffusionConfig(**CONFIGS[name]), device="cpu")
    s.set_effect_key("b")
    return s


def _updates(s, strokes, span=None):
    """One solve per stroke, each inside ``span("bench.solve")`` where one
    is given; returns each update's u8 map, effect image and depth state."""
    out = []
    for k, events in enumerate(strokes):
        s.set_color_key(k % 5)
        for x, y in events:
            s.paint(x, y)
        if span is None:
            u8 = s.solve()
        else:
            with span("bench.solve"):
                u8 = s.solve()
        out.append((u8, s.artistic.numpy().copy(), [d.numpy().copy() for d in s.depth_state]))
    return out


def _host(prof):
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()]


# ------------------------------------------------------------- the recorder
def test_span_and_count_semantics():
    t = timing.StageTimer()
    with t.span("outer"):
        with t.span("inner"):
            pass
        with t.span("inner"):
            pass
    t.count("c")
    t.count("c", 4)
    assert dict(t.counts) == {"outer": 1, "inner": 2, "c": 5}
    assert t.totals["c"] == 0.0 and t.totals["outer"] >= t.totals["inner"] > 0.0
    assert t.counters == {"c"}
    with pytest.raises(ValueError):
        with t.span("outer"):
            raise ValueError("a span that raises still counts")
    assert t.counts["outer"] == 2
    with timing.span("untimed"):  # no timer: the profiler's range alone
        pass
    assert "untimed" not in t.totals
    t.reset()
    assert not t.totals and not t.counts and not t.counters


def test_report_prints_counters_as_counts():
    t = timing.StageTimer()
    with t.stage("solve"):
        pass
    t.count("exit.chunks_live", 3)
    lines = dict(ln.strip().split(": ", 1) for ln in t.report().splitlines())
    assert lines["exit.chunks_live"] == "3"
    assert lines["solve"].endswith("ms") and "1 calls" in lines["solve"]


def test_no_profiler_enters_no_record_function(monkeypatch):
    """With no profiler running, neither the recorder nor a whole session's
    solves, nor the server, enter ``record_function``."""
    def refuse(*args, **kw):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    t = timing.StageTimer(prefix="session.")
    with t.stage("solve"), t.span("program.call"), timing.span("serve.dispatch"):
        pass
    for name in CONFIGS:
        _updates(_session(name), STROKES)


# ---------------------------------------------------------- on the timeline
@pytest.mark.parametrize("name", list(CONFIGS))
def test_session_spans_on_the_profilers_clock(name):
    s = _session(name)
    _updates(s, STROKES[:2])  # the first solve, and the one that captures
    with _cpu_profile() as prof:
        _updates(s, STROKES[2:], torch.profiler.record_function)
    host = _host(prof)
    solves = [(a, b) for n, a, b in host if n == "bench.solve"]
    ours = [(n, a, b) for n, a, b in host if n.startswith(("session.", "program."))]
    names = {n for n, _, _ in ours}
    assert {"session.upload", "session.solve", "session.mask", "session.u8_readback",
            "program.call", "program.eager"} <= names
    if name == "fast":
        assert "session.window_solve" in names
    polish = [(a, b) for n, a, b in host if n == "vcycle.polish"]
    assert len(polish) == (len(STROKES[2:]) if name == "vcycle" else 0)
    for a, b in polish:  # inside the solve's eager run
        assert any(sa <= a and b <= sb for n, sa, sb in ours if n == "program.eager")
    for n, a, b in ours:  # each nested inside a bench.solve range
        assert any(sa <= a and b <= sb for sa, sb in solves), n
    # What the benchmark's breakdown says the host was doing where only a
    # program span is open: solve/<that span>.
    labels = set()
    for n, a, b in ours:
        if n.startswith("program."):
            inside = sorted((x, y) for m, x, y in host if a < x < b and m != n)
            ends = [a] + [y for _, y in inside]
            starts = [x for x, _ in inside] + [b]
            points = [(e + st) / 2 for e, st in zip(ends, starts) if st > e]
            labels.update(l for l in trace._host_labels(host, points) if l == f"solve/{n}")
    assert labels & {"solve/program.call", "solve/program.eager"}
    # The stages keep their keys in the timer; the timeline calls them session.*.
    assert s.timer.counts["upload"] == s.timer.counts["solve"] == len(STROKES)
    assert "upload" not in names and "solve" not in names


def test_exit_counters_under_a_profiler_only():
    s = _session("fast")
    _updates(s, STROKES[:2])
    s.timer.reset()
    _updates(s, STROKES[2:3])
    assert not any(k.startswith("exit.") for k in s.timer.totals)
    s.timer.reset()
    with _cpu_profile():
        _updates(s, STROKES[3:])
    c = {k: s.timer.counts[k] for k in s.timer.counters}
    assert set(c) == {"exit.chunks_issued", "exit.chunks_live", "exit.px",
                      "exit.px_iters_run", "sweep.fused_levels", "sweep.fused_px",
                      "sweep.fused_px_sweeps", "sweep.resident_sweeps",
                      "sweep.resident_exchanges", "upload.full", "upload.rects",
                      "upload.px", "defocus.renders", "defocus.approx"}
    # the windowed path: one 32 px window's bytes, no whole plane, no rect write
    assert (c["upload.full"], c["upload.rects"], c["upload.px"]) == (0, 0, 32 * 32)
    # red-black sends no level to K6 or K2
    assert c["sweep.fused_levels"] == c["sweep.fused_px"] == c["sweep.fused_px_sweeps"] == 0
    assert c["sweep.resident_sweeps"] == c["sweep.resident_exchanges"] == 0
    # one render with the effect latched, exact at max_half 2
    assert (c["defocus.renders"], c["defocus.approx"]) == (1, 0)
    assert 0 < c["exit.chunks_live"] <= c["exit.chunks_issued"]
    assert 0 < c["exit.px_iters_run"] <= c["exit.px"] * 60
    assert all(s.timer.totals[k] == 0.0 for k in c)
    assert s.timer.counts["session.window_solve"] == 1


def test_upload_counters_under_a_profiler_only():
    """The faithful config's first solve sends both whole planes; a stroke
    then writes its one rect, whose area is the pixels that crossed. With
    no profiler running nothing is counted."""
    s = _session("faithful")
    with _cpu_profile():
        _updates(s, STROKES[:1])
    c = {k: s.timer.counts[k] for k in s.timer.counters}
    assert (c["upload.full"], c["upload.rects"], c["upload.px"]) == (1, 0, H * W)
    s.timer.reset()
    s.set_color_key(3)
    s.paint(*STROKES[1][0])
    (y0, x0, y1, x1), = s.dirty_rects
    with _cpu_profile():
        s.solve()
    c = {k: s.timer.counts[k] for k in s.timer.counters}
    assert (c["upload.full"], c["upload.rects"]) == (0, 1)
    assert c["upload.px"] == (y1 - y0 + 1) * (x1 - x0 + 1) == s.last_upload_bytes // 2
    s.timer.reset()
    _updates(s, STROKES[2:])
    assert s.last_upload_bytes > 0
    assert not any(k.startswith("upload.") for k in s.timer.totals)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_outputs_bit_equal_with_tracing_on_and_off(name):
    plain = _updates(_session(name), STROKES)
    with _cpu_profile():
        traced = _updates(_session(name), STROKES, torch.profiler.record_function)
    for (u8, art, st), (u8_t, art_t, st_t) in zip(plain, traced):
        assert np.array_equal(u8, u8_t) and np.array_equal(art, art_t)
        assert all(np.array_equal(a, b) for a, b in zip(st, st_t))


def test_serve_spans_and_same_bytes(tmp_path):
    d = str(tmp_path)
    for sub in ("images", "annotations"):
        os.makedirs(os.path.join(d, sub))
    for i, name in enumerate("abc"):
        rgb, mask, value = synthetic_pair(64, 80, i + 1)
        io.imwrite(os.path.join(d, "images", f"{name}.png"), rgb)
        io.save_annotation(os.path.join(d, "annotations", f"{name}.png"), mask, value)
    pairs = discover_pairs(os.path.join(d, "images"), os.path.join(d, "annotations"))
    cfg = DiffusionConfig(max_iterations=40)
    plain = solve_pairs(pairs, os.path.join(d, "plain"), cfg, 1, device="cpu")
    with _cpu_profile() as prof:
        traced = solve_pairs(pairs, os.path.join(d, "traced"), cfg, 1, device="cpu")
    names = [n for n, _, _ in _host(prof)]
    for n in SERVE_SPANS:
        assert n in names, n
    for p, q in zip(plain, traced):
        for suffix in ("_depth.png", "_effect.png"):
            with open(p.replace("_depth.png", suffix), "rb") as f, \
                    open(q.replace("_depth.png", suffix), "rb") as g:
                assert f.read() == g.read(), suffix


# ------------------------------------------------- the early exit's read
def test_exit_log_copies_then_waits(monkeypatch):
    """A pipeline with ``exit_wait`` off leaves the card's loop counts
    copied but unread; ``read_exit_log`` then fills them in as a pipeline
    that waits does."""
    monkeypatch.setattr(solver, "_host_loop", lambda device: False)
    cfg = DiffusionConfig(**CONFIGS["fast"])
    rgb, mask, value = synthetic_pair(H, W, 9)
    logs = []
    for wait in (True, False):
        pipe = DepthPipeline(H, W, cfg, device="cpu")
        pipe.exit_wait = wait
        _, g = pipe.prepare_image(rgb)
        log = []
        pipe.solve(g, torch.from_numpy(mask), torch.from_numpy(value), pipe.initial_state(),
                   log)
        assert all(("_host" in e) != wait and "_device" not in e for e in log)
        logs.append(solver.read_exit_log(log))
    assert logs[0] == logs[1] and all(e["iters"] >= 1 for e in logs[0])
