"""K2's sweeps per exchange, on the CPU: the rule ``ops/sweep.py:
resident_plan`` that picks them per launch from the level's shape and the
launch's sweeps, the layouts that hold the extended band, and the session's
counters ``sweep.resident_sweeps`` and ``sweep.resident_exchanges``
(``live/session.py``), counted on the host from the level calls while a
profiler runs. The kernel itself runs only on a card
(``tests/test_torch_cuda.py``)."""

import pytest
import torch

from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.live.session import DepthSession
from realtimedepthdiffusion_tpu_torch.ops import dispatch, sweep
from tests.conftest import synthetic_pair

CPU = torch.device("cpu")
COUNTERS = ("sweep.resident_sweeps", "sweep.resident_exchanges")
# Every level shape K2 runs on the main paths: 1080p L4/L3/L2 (4K L5/L4/L3),
# the windowed re-solve's 192 and 256 windows; and odd ones.
SHAPES = [(67, 120), (135, 240), (270, 480), (192, 192), (256, 256), (1, 1), (5, 7),
          (133, 251), (270, 512)]


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("n", [1, 2, 3, 8, 25, 60, 250, 1000])
def test_plan_is_a_layout_that_holds_it(h, w, n):
    """At most ``RESIDENT_MAX_S``, the band's rows and ``n`` sweeps per
    exchange, in a layout whose threads and shared memory hold the
    extended band: the first blocked layout with room for ghost rows, at
    the most sweeps it holds; else the one-row layout at one a sweep."""
    c = sweep.resident_cluster(h, w, sweep.H100_MAX_CLUSTER)
    rows = -(-h // c)
    s, r = sweep.resident_plan(h, w, c, n)
    assert 1 <= s <= min(sweep.RESIDENT_MAX_S, rows, n)
    assert r in sweep.resident_layouts(rows, w, s)
    ext, bx = rows + 2 * (s - 1), -(-w // 32) * 32
    one_row = (sweep.RESIDENT_ROWS, sweep.RESIDENT_MAX_W)
    threads = dict(sweep.RESIDENT_BLOCKED_LAYOUTS + (one_row,))[r]
    assert bx * -(-ext // r) <= threads
    assert sweep.resident_smem(-(-ext // r) * r, w, s) <= sweep.resident_smem(
        sweep.RESIDENT_ROWS, sweep.RESIDENT_MAX_W, 1) <= sweep.SMEM_PER_CTA
    blocked = [b for b, _ in sweep.RESIDENT_BLOCKED_LAYOUTS]
    room = [(t, b) for b in blocked for t in range(2, min(n, sweep.RESIDENT_MAX_S) + 1)
            if b in sweep.resident_layouts(rows, w, t)]
    if room:
        first = min(blocked.index(b) for _, b in room)
        assert (s, r) == max((t, b) for t, b in room if blocked.index(b) == first)
    else:
        assert (s, r) == (1, sweep.RESIDENT_ROWS)
    assert dispatch.resident_work(h, w, CPU, "jacobi_chebyshev", n) == (n, -(-n // s))


@pytest.mark.parametrize("h,w,n,plan", [
    # 1080p and 4K: L4 (L5), L3 (L4), L2 (L3) at their sweeps, and the early
    # exit's chunks of 25
    (67, 120, 1000, (5, 2)), (135, 240, 500, (4, 4)), (270, 480, 250, (1, 17)),
    (67, 120, 25, (5, 2)), (135, 240, 25, (4, 4)),
    # the windowed re-solve's windows
    (192, 192, 60, (5, 4)), (256, 256, 60, (5, 6)),
    # fewer sweeps than the band allows
    (67, 120, 3, (3, 2)), (67, 120, 1, (1, 17)),
])
def test_plan_at_the_main_paths(h, w, n, plan):
    """The bands of 5 rows (1080p L4) exchange once every 5 sweeps, on
    thread rows of 2; those of 9 (L3) once every 4 on thread rows of 4,
    where 1024 threads of 4 rows hold 16 rows of 240; the 17-row bands of
    L2 have no room for ghost rows and keep one exchange a sweep."""
    assert sweep.resident_plan(h, w, sweep.resident_cluster(h, w, 16), n) == plan


def test_layouts_refuse_what_they_cannot_hold():
    assert sweep.resident_layouts(5, 120, 6) == []  # ghost rows past the neighbour's band
    assert sweep.resident_layouts(17, 120, 9) == []  # past RESIDENT_MAX_S
    assert sweep.resident_layouts(17, 480, 2) == []  # 19 rows of 480 in no layout
    assert sweep.resident_layouts(9, 240, 5) == [6]  # 17 rows of 240: 1280 threads of 4 rows
    assert sweep.resident_layouts(5, 120, 1) == [2, 4, 6, 17]
    assert sweep.resident_layouts(17, 480, 1) == [17]


def test_resident_work_counts_launches_and_blocks():
    """One launch of every sweep, or the early exit's chunks (the last one
    short); nothing off K2's route."""
    assert dispatch.resident_work(67, 120, CPU, "jacobi_chebyshev", 1000) == (1000, 200)
    assert dispatch.resident_work(135, 240, CPU, "jacobi_chebyshev", 500) == (500, 125)
    assert dispatch.resident_work(270, 480, CPU, "jacobi_chebyshev", 250) == (250, 250)
    # chunks of 25, 25 and 10: 5 + 5 + 2 blocks of 5
    assert dispatch.resident_work(67, 120, CPU, "jacobi", 60, chunk=25) == (60, 12)
    assert dispatch.resident_work(67, 120, CPU, "red_black", 1000) == (0, 0)
    assert dispatch.resident_work(540, 960, CPU, "jacobi_chebyshev", 125) == (0, 0)
    assert dispatch.resident_work(67, 120, CPU, "jacobi_chebyshev", 0) == (0, 0)


def _session(**kw):
    rgb, _, _ = synthetic_pair(96, 128, 5)
    s = DepthSession(rgb, DiffusionConfig(max_iterations=60, **kw), device="cpu")
    s.set_effect_key("b")
    return s


def _profiled_updates(s, strokes):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for x, y in strokes:
            s.paint(x, y)
            s.solve()


@pytest.mark.parametrize("early_exit", [False, True])
def test_counters_over_the_level_calls(early_exit):
    """At 96 x 128 both levels go to K2: L1 (48 x 64, bands of 3 rows) and
    L0 (96 x 128, bands of 6). The cascade runs 60 and 30 sweeps in one
    launch each, 3 and 6 a block: 20 + 5 exchanges. Under an early exit
    that never fires, chunks of 5 run them, 3 then 2 a block on L1 and 5 on
    L0: 12 * 2 + 6 * 1."""
    extra = dict(early_exit=True, residual_check_every=5, tolerance=0.0) if early_exit else {}
    s = _session(**extra)
    assert [c[:3] for c in s.pipe.level_calls()] == [(48, 64, 60), (96, 128, 30)]
    s.solve()  # no profiler: nothing counted
    assert not any(c in s.timer.counts for c in COUNTERS)
    _profiled_updates(s, [(40, 40), (60, 50)])
    got = [s.timer.counts[c] for c in COUNTERS]
    if early_exit:
        assert s.timer.counts["exit.px_iters_run"] == 2 * (48 * 64 * 60 + 96 * 128 * 30)
    assert got == [2 * (60 + 30), 2 * (12 * 2 + 6 * 1 if early_exit else 20 + 5)]
    assert all(s.timer.totals[c] == 0.0 for c in COUNTERS)


def test_counters_read_zero_off_the_route():
    """Red-black runs no level on K2."""
    s = _session(solver="red_black")
    _profiled_updates(s, [(40, 40)])
    assert [s.timer.counts[c] for c in COUNTERS] == [0, 0]


def test_window_counters():
    """A windowed re-solve's level calls: each window a launch of its own
    sweeps, counted once per rect."""
    s = _session(incremental_iterations=20, incremental_window=32, fast_start=True)
    calls = s.pipe.level_calls(windowed=True)
    assert [c[:3] for c in calls] == [(16, 16, 10), (32, 32, 20)]
    # 16 x 16 on 16 CTAs: bands of 1 row, one sweep a block; 32 x 32: 2 rows
    assert [dispatch.resident_work(h, w, CPU, "jacobi_chebyshev", n) for h, w, n, _ in calls] \
        == [(10, 10), (20, 10)]
    assert [sweep.resident_plan(h, w, 16, n)[0] for h, w, n, _ in calls] == [1, 2]
