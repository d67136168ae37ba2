"""The live session with K6's route taken, on the CPU at a small size: the
L2 cache that ``ops/dispatch.py`` routes by is made a few KB, so that the
wide levels of a small image go to K6's plain version as 4K's L0 goes to
K6 on an H100. The session's u8 map, effect and depth state against the
benchmark's plain reference (``benchmark/reference/plain.py``); the
counters ``sweep.fused_*`` against the routed levels' shapes, under a
profiler only; and the ``faithful_4k`` configuration and the reader
``roofline.jc_fused`` of the benchmark."""

import copy

import numpy as np
import pytest
import torch

from benchmark import check, gen, spec, trace, work
from benchmark.reference import plain
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import effects
from realtimedepthdiffusion_tpu_torch.live.session import DepthSession
from realtimedepthdiffusion_tpu_torch.ops import defocus, dispatch
from realtimedepthdiffusion_tpu_torch.pipeline import DepthPipeline

BENCH = spec.load()
FAITHFUL_4K = spec.config(BENCH, "faithful_4k")
# A few KB: every level that K2's cluster does not hold (wider than 512
# columns) goes to K6.
TINY_L2 = 4096
COUNTERS = ("sweep.fused_levels", "sweep.fused_px", "sweep.fused_px_sweeps")
# Per update: the drag's events (x, y) and the depth key.
STROKES = [([(100, 60), (108, 64), (116, 68), (124, 72)], 1),
           ([(400, 120), (392, 126), (384, 132), (376, 138)], 4)]
# The numbers' tolerances. The port's plain versions and the reference
# differ in rounding alone: the reference writes the Chebyshev step as
# omega * (gamma * (r - u) + u - prev) + prev, K6's plain version as
# a*r + b*u + c*prev, each in float32, so the depth differs by float32
# ulps (~1e-5 of 255) amplified over at most 64 sweeps per level.
STATE_TOL = 1e-2   # depth units: ~1000 ulps of 255 in float32
U8_TOL = 0.1       # gray levels RMS: a depth within 1e-2 of a half flips ~1 % of pixels
EFFECT_TOL = 0.1   # RMS over the channels: a box's half-width flips with such a pixel
SCRIBBLE_TOL = 0   # scribbles are pinned in both: exact


def small_cfg(**kw):
    """The ``faithful_4k`` configuration's solver settings at a CPU test's
    budget: 64 iterations (16/32/64 over three levels)."""
    d = dict(FAITHFUL_4K["diffusion"], max_iterations=64)
    d.update(kw)
    return d


def _session(h, w, dcfg, seed=2**33 + 19):
    rng = np.random.default_rng(seed)
    rgb = gen.photo_like(rng, h, w)
    mask, value = gen.dense_scribbles(rng, h, w)
    s = DepthSession(rgb, DiffusionConfig(**dcfg), device="cpu")
    np.copyto(s.mask_np, mask.astype(np.uint8))
    np.copyto(s.value_np, value)
    s.mark_all_dirty()
    s.set_effect_key(FAITHFUL_4K["effect"])
    return s, rgb, mask, value


def _reference(dcfg, rgb, mask, value, state):
    """The reference's u8 map, effect and state of one full solve from
    ``state``."""
    rgb_t = torch.from_numpy(rgb)
    grays = plain.gray_pyramid(dcfg, plain.rgb_to_gray(rgb_t))
    masks, values = plain.annotation_pyramids(dcfg, torch.from_numpy(mask),
                                              torch.from_numpy(value))
    depth0, st = plain.cascade(dcfg, grays, masks, values, list(state), torch.float32)
    effect = plain.defocus(dcfg, rgb_t, depth0)
    return plain.to_u8(depth0).numpy(), effect.numpy(), st


def test_session_on_k6s_route_agrees_with_the_reference(monkeypatch):
    """A first solve and two stroke updates at 192 x 576 (three levels, L0
    wider than K2's cluster holds) with L0 on K6's plain version."""
    monkeypatch.setattr(dispatch, "l2_bytes", lambda device: TINY_L2)
    h, w = 192, 576
    dcfg = small_cfg()
    s, rgb, mask, value = _session(h, w, dcfg)
    routes = [dispatch.fused_level(t, dcfg["solver"]) for t in s.depth_state]
    assert routes == [True, False, False]
    assert effects.resolved_defocus_quality(s.cfg, s.cfg.defocus_kernel_size(h, w) // 2) == "exact"
    mask, value = mask.copy(), value.copy()
    before = s.depth_state
    rows = []
    for k, (events, key) in enumerate([([], 0)] + STROKES):
        s.set_color_key(key)
        for x, y in events:
            s.paint(x, y)
            plain.paint(mask, value, x, y, plain.scribble_value(key), s.scribble_radius)
        u8 = s.solve()
        assert np.array_equal(s.mask_np != 0, mask) and np.array_equal(s.value_np, value)
        ref_u8, ref_fx, ref_st = _reference(dcfg, rgb, mask, value, before)
        rows.append(check.compare(u8, s.artistic.numpy(), s.depth_state, ref_u8, ref_fx,
                                  ref_st, mask, value))
        before = s.depth_state
    worst = check.worst(rows)
    assert worst["state_rmse"] <= STATE_TOL, worst
    assert worst["u8_rmse"] <= U8_TOL, worst
    assert worst["effect_rmse"] <= EFFECT_TOL, worst
    assert worst["scribble_err"] <= SCRIBBLE_TOL, worst


def _profiled_solves(s, n):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(n):
            s.solve()


@pytest.mark.parametrize("early_exit", [False, True])
def test_fused_counters_follow_the_route(monkeypatch, early_exit):
    """At 96 x 1152 both levels are wider than K2's cluster holds: with the
    small L2 both go to K6, and the counters count both (no fixed level);
    under the early exit with the iterations each ran, which the early
    exit's own counters give."""
    monkeypatch.setattr(dispatch, "l2_bytes", lambda device: TINY_L2)
    h, w = 96, 1152
    extra = dict(early_exit=True, residual_check_every=4, tolerance=1e-3) if early_exit else {}
    s, *_ = _session(h, w, small_cfg(**extra))
    assert [dispatch.fused_level(t, "jacobi_chebyshev") for t in s.depth_state] == [True, True]
    s.solve()  # no profiler: nothing counted
    assert not any(c in s.timer.counts for c in COUNTERS)
    _profiled_solves(s, 2)
    px = h * w + (h // 2) * (w // 2)
    assert s.timer.counts["sweep.fused_levels"] == 2 * 2
    assert s.timer.counts["sweep.fused_px"] == 2 * px
    if early_exit:
        assert s.timer.counts["sweep.fused_px_sweeps"] == s.timer.counts["exit.px_iters_run"]
        assert s.timer.counts["sweep.fused_px"] == s.timer.counts["exit.px"]
        assert s.timer.counts["exit.px_iters_run"] < 2 * (h * w * 32 + (h // 2) * (w // 2) * 64)
    else:  # L1 64 sweeps, L0 32
        assert s.timer.counts["sweep.fused_px_sweeps"] == 2 * (h * w * 32
                                                              + (h // 2) * (w // 2) * 64)


def test_fused_counters_are_zero_off_the_route():
    """The card's own L2 (the H100's on the CPU): no level of a small image
    goes to K6, and the counters read 0."""
    s, *_ = _session(96, 1152, small_cfg())
    _profiled_solves(s, 1)
    assert [s.timer.counts[c] for c in COUNTERS] == [0, 0, 0]


def test_level_calls_of_a_windowed_solve(monkeypatch):
    """The level calls by hand: a full solve's levels at the cascade's
    budget; a windowed re-solve's global smoothing and window at each
    windowed level. A window is small enough for K2, its level's global
    sweeps go to K6."""
    monkeypatch.setattr(dispatch, "l2_bytes", lambda device: TINY_L2)
    cfg = DiffusionConfig(**small_cfg(incremental_iterations=20, incremental_window=64,
                                      incremental_global_smooth=3))
    pipe = DepthPipeline(96, 1152, cfg, device="cpu")
    assert pipe.level_calls() == [(48, 576, 64, True), (96, 1152, 32, True)]
    assert pipe.level_calls(windowed=True) == [(48, 576, 3, True), (32, 32, 10, False),
                                               (96, 1152, 3, True), (64, 64, 20, False)]


@pytest.mark.parametrize("kind", ["cascade", "vcycle", "windowed"])
def test_level_calls_are_the_solves_own(kind):
    """``level_calls`` names the level solves that the solve itself runs:
    under the early exit each of them logs its shape and its cap."""
    h, w = 96, 320
    cfg = DiffusionConfig(**small_cfg(
        early_exit=True, residual_check_every=4, tolerance=1e-3, incremental_iterations=20,
        incremental_window=64, incremental_global_smooth=3,
        multigrid="vcycle" if kind == "vcycle" else "cascadic"))
    rng = np.random.default_rng(2**34 + 3)
    mask, value = gen.dense_scribbles(rng, h, w)
    pipe = DepthPipeline(h, w, cfg, device="cpu")
    _, gray = pipe.prepare_image(gen.photo_like(rng, h, w))
    args = (gray, torch.from_numpy(mask), torch.from_numpy(value), pipe.initial_state())
    log = []
    if kind == "windowed":
        pipe._inc_eager(*args, (40, 200), log)
    else:
        pipe._solve_eager(*args, log)
    calls = pipe.level_calls(windowed=kind == "windowed")
    assert [(tuple(e["shape"]), e["cap"]) for e in log] == [((ch, cw), n) for ch, cw, n, _ in calls]


# ------------------------------------------------------- the configuration
def test_faithful_4k_config_routes():
    """``faithful_4k`` at 2160 x 3840: 6 levels and 1968 sweeps, K6 on L0
    alone under the H100's L2, the exact defocus on K3's 96-tile route."""
    cfg = DiffusionConfig(**FAITHFUL_4K["diffusion"])
    h, w = FAITHFUL_4K["rows"], FAITHFUL_4K["cols"]
    assert (h, w) == (2160, 3840) and FAITHFUL_4K["reduced"] == []
    levels = cfg.num_levels(h, w)
    assert levels == 6
    assert sum(cfg.level_iterations(levels, lv) for lv in range(levels)) == 1968
    fused = [dispatch.fused_route(*cfg.level_size(h, w, lv), torch.device("cpu"), cfg.solver)
             for lv in range(levels)]
    assert fused == [True] + [False] * 5
    max_half = cfg.defocus_kernel_size(h, w) // 2
    assert max_half == 55
    assert effects.resolved_defocus_quality(cfg, max_half) == "exact"
    assert defocus.defocus_route(max_half) == ("tile", 96)
    assert cfg.brush_radius(h, w) == 43


def test_faithful_4k_differs_from_1080p_only_where_stated():
    """The copy of ``faithful_1080p`` with the size and the defocus quality
    changed, and its cell's metrics: every session metric but
    ``roofline.jc_sweep`` (K1's and K2's time alone) and the fast cells',
    and ``roofline.jc_fused``."""
    a = copy.deepcopy(spec.config(BENCH, "faithful_1080p"))
    b = FAITHFUL_4K
    assert {k for k in a["diffusion"] if a["diffusion"][k] != b["diffusion"][k]} == {
        "pallas_defocus_quality"}
    assert b["diffusion"]["pallas_defocus_quality"] == "exact"
    assert a["effect"] == b["effect"] == "b"
    assert len(b["assumed"]) == 3
    cell = spec.cell(BENCH, "faithful_4k.strokes")
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("faithful_4k", "strokes", 1)
    per_layer = {m["name"] for m in spec.metrics_of(BENCH, cell["name"], "per_layer")}
    assert per_layer == {"paint_us", "upload_ms", "readback_ms", "kernels_per_update",
                         "device_ms", "idle_share", "update_mfu", "roofline.defocus",
                         "program_host_ms", "solve_wait_ms", "replay_share",
                         "roofline.jc_fused"}
    e2e = {m["name"] for m in spec.metrics_of(BENCH, cell["name"], "end_to_end")}
    assert e2e == {"update_ms", "update_p95_ms", "setup_s"}


# ------------------------------------------------------------- the reader
def _record(counters, k6_s):
    device = [("jc_sweep_tiles_kernel", "kernel", 0.002)]
    if k6_s:
        device.append(("jc_sweep_fused_kernel", "kernel", k6_s))
    return {"updates": 2, "rows": 2160, "cols": 3840, "config": FAITHFUL_4K["diffusion"],
            "device": device, "stages": {k: (0.0, n) for k, n in counters.items()}}


def test_roofline_jc_fused_reads_the_counters():
    read = spec.reader("roofline.jc_fused")
    px = 2160 * 3840
    counters = {"sweep.fused_levels": 2, "sweep.fused_px": 2 * px,
                "sweep.fused_px_sweeps": 2 * px * 31}
    # two updates of 4K's L0, 31 sweeps each: 14 * px * 31 FLOPs at 67
    # TFLOP/s (53.73 us) against 21 * px bytes at 3.35 TB/s (51.99 us)
    least = 2 * 14 * px * 31 / 67e12
    assert least > 2 * 21 * px / 3.35e12
    assert read(_record(counters, 0.0026)) == pytest.approx(100.0 * least / 0.0026)
    assert read(_record(counters, 0.0026)) == pytest.approx(4.133, abs=1e-3)
    assert work.least_s(14 * px * 31, 21 * px) == pytest.approx(least / 2)
    # nothing to read: no counters, zero counters, or no K6 in the trace
    assert read(_record({}, 0.0026)) is None
    assert read(_record({c: 0 for c in COUNTERS}, 0.0026)) is None
    assert read(_record(counters, 0.0)) is None


def test_roofline_jc_fused_names_k6_as_the_trace_does():
    """The kernel's name as ``benchmark/trace.py`` bares it from a
    profiler's event."""
    assert trace.bare_name("void jc_sweep_fused_kernel<8>(float const*, float*)") == \
        "jc_sweep_fused_kernel"
