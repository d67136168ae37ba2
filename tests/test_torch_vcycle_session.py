"""The V-cycle live session (``multigrid="vcycle"``) on the CPU at small
sizes: the port's ``solve_vcycle`` and a ``DepthSession`` against the
benchmark's V-cycle reference (``benchmark/reference/vcycle_1080p.py``),
and that reference against the JAX package's V-cycle; the polish's span
and counters (``vcycle.polish``, ``vcycle.*``); the ``vcycle_1080p``
configuration's routes; and the readers ``polish_ms``,
``roofline.vcycle_polish`` and ``update_mfu.vcycle``."""

import copy
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark import check, gen, polish_work, spec, trace, work
from benchmark.reference import plain
from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.core import multigrid as jmg
from realtimedepthdiffusion_tpu.pipeline import DepthPipeline as JPipeline
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import effects
from realtimedepthdiffusion_tpu_torch.core import multigrid as tmg
from realtimedepthdiffusion_tpu_torch.live.session import DepthSession
from realtimedepthdiffusion_tpu_torch.ops import defocus, dispatch, sweep
from realtimedepthdiffusion_tpu_torch.pipeline import DepthPipeline

BENCH = spec.load()
VCYCLE = spec.config(BENCH, "vcycle_1080p")
REF = spec.reference("vcycle_1080p")
CELL = "vcycle_1080p.strokes"
COUNTERS = ("vcycle.cycles", "vcycle.px_sweeps", "vcycle.px", "vcycle.smooth_kernel")
# (rows, cols, pyramid_base_size): 3 and 4 levels.
SIZES = [(96, 160, 24), (128, 224, 16)]
# Per update: the drag's events (x, y) and the depth key.
STROKES = [([(40, 30), (46, 34), (52, 38), (58, 42)], 1),
           ([(120, 70), (114, 64), (108, 58), (102, 52)], 4)]
# The numbers' tolerances. The port and the reference differ in rounding
# alone: the warm cascade's Chebyshev step is a*r + b*u + c*prev in the
# port's plain versions and omega * (gamma * (r - u) + u - prev) + prev in
# the reference, each in float32, so the warm depth differs by float32 ulps
# (~1e-4 depth units RMS here), and the polish is linear in the error and
# carries that through. But a level's weights switch on the truncated depth
# of neighbours (level 0 on any difference, the levels above at 4): where a
# depth sits within rounding of a whole number a weight flips, and a patch
# of some 20 pixels moves by up to ~2.5 (these cases read 0.038 RMS at most
# in the state, 0.096 in the u8 map). The same reference in bfloat16 (8 bits
# of mantissa: a depth near 255 is held to 1 gray level) reads 10 or more.
STATE_TOL = 0.1    # depth units: two such patches in a 96 x 160 level
U8_TOL = 0.25      # gray levels RMS: such a patch flips its pixels' rounding
EFFECT_TOL = 0.1   # RMS over the channels: a box's half-width flips with such a pixel
SCRIBBLE_TOL = 0   # scribbles are pinned in both: exact
TOLS = {"state_rmse": STATE_TOL, "u8_rmse": U8_TOL, "effect_rmse": EFFECT_TOL,
        "scribble_err": SCRIBBLE_TOL}


def small_cfg(base, **kw):
    """The ``vcycle_1080p`` configuration's settings at a CPU test's budget:
    160 iterations, pyramids of ``base`` px."""
    d = dict(VCYCLE["diffusion"], max_iterations=160, pyramid_base_size=base)
    d.update(kw)
    return d


def _scene(h, w, seed):
    rng = np.random.default_rng(seed)
    return gen.photo_like(rng, h, w), *gen.dense_scribbles(rng, h, w)


def _reference(dcfg, rgb, mask, value, state, dt=torch.float32):
    """The reference's u8 map, effect and state of one full solve from
    ``state`` in ``dt``."""
    rgb_t = torch.from_numpy(rgb)
    grays = REF.gray_pyramid(dcfg, REF.rgb_to_gray(rgb_t))
    masks, values = REF.annotation_pyramids(dcfg, torch.from_numpy(mask),
                                            torch.from_numpy(value))
    depth0, st = REF.cascade(dcfg, grays, masks, values, [s.to(dt) for s in state], dt)
    effect = REF.defocus(dcfg, rgb_t, depth0.to(torch.float32))
    return REF.to_u8(depth0).numpy(), effect.numpy(), [s.to(torch.float32) for s in st]


def _within(numbers):
    return all(numbers[k] <= tol for k, tol in TOLS.items())


# ------------------------------------------------------ port vs reference
@pytest.mark.parametrize("h,w,base", SIZES)
def test_solve_vcycle_agrees_with_the_reference(h, w, base):
    """``solve_vcycle`` from a fresh state against the reference's
    ``cascade``: within the tolerances in float32, outside them in
    bfloat16."""
    dcfg = small_cfg(base)
    cfg = DiffusionConfig(**dcfg)
    rgb, mask, value = _scene(h, w, 2**33 + h)
    pipe = DepthPipeline(h, w, cfg, device="cpu")
    assert pipe.levels == (3 if h == 96 else 4)
    _, gray = pipe.prepare_image(rgb)
    m, v = torch.from_numpy(mask), torch.from_numpy(value)
    depth, state = tmg.solve_vcycle(gray, m, v, pipe.initial_state(), cfg)
    fx = effects.apply_effect(effects.EFFECT_DEFOCUS, torch.from_numpy(rgb), gray[0],
                              depth.clamp(0.0, 255.0), cfg).numpy()
    got = (plain.to_u8(depth).numpy(), fx, state)
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        want = _reference(dcfg, rgb, mask, value, pipe.initial_state(), dt)
        rows[dt] = check.compare(*got, *want, mask, value)
    assert _within(rows[torch.float32]), rows[torch.float32]
    assert not _within(rows[torch.bfloat16]), rows[torch.bfloat16]
    # The polish moves the warm cascade, so the comparison sees it.
    warm, _ = tmg.solve_cascade(gray, m, v, pipe.initial_state(), tmg.vcycle_warm_config(cfg))
    assert check.rmse(warm, depth) > 5 * STATE_TOL


@pytest.mark.parametrize("h,w,base", SIZES)
def test_session_agrees_with_the_reference(h, w, base):
    """A ``DepthSession`` under ``multigrid="vcycle"``: a first solve and
    two stroke updates, each a full warm re-solve through the program
    layer, against the reference from the session's own state before it;
    the reference in bfloat16 fails the same tolerances on every update."""
    dcfg = small_cfg(base)
    rgb, mask, value = _scene(h, w, 2**34 + w)
    s = DepthSession(rgb, DiffusionConfig(**dcfg), device="cpu")
    np.copyto(s.mask_np, mask.astype(np.uint8))
    np.copyto(s.value_np, value)
    s.mark_all_dirty()
    s.set_effect_key(VCYCLE["effect"])
    mask, value = mask.copy(), value.copy()
    before = s.depth_state
    rows = []
    for events, key in [([], 0)] + STROKES:
        s.set_color_key(key)
        for x, y in events:
            s.paint(x, y)
            plain.paint(mask, value, x, y, plain.scribble_value(key), s.scribble_radius)
        u8 = s.solve()
        got = (u8, s.artistic.numpy(), s.depth_state)
        row = check.compare(*got, *_reference(dcfg, rgb, mask, value, before), mask, value)
        ctl = check.compare(*got, *_reference(dcfg, rgb, mask, value, before, torch.bfloat16),
                            mask, value)
        assert not _within(ctl), ctl
        rows.append(row)
        before = s.depth_state
    assert s.timer.counts["program.eager"] == 3 and "session.window_solve" not in s.timer.counts
    worst = check.worst(rows)
    assert _within(worst), worst


class _Unpolished:
    """The cell's reference, whose ``cascade`` asked in float64 (the check's
    stand-in, which it asks for in that precision) runs in float32 with
    ``cfg`` overridden: a port that skips some or all of the polish. Asked
    in float32 (the check's own reference) it is the reference."""

    def __init__(self, **override):
        self.override = override

    def __getattr__(self, name):
        return getattr(REF, name)

    def cascade(self, cfg, grays, masks, values, state, dt, **kw):
        if dt == torch.float64:
            cfg, dt = dict(cfg, **self.override), torch.float32
        return REF.cascade(cfg, grays, masks, values, state, dt, **kw)


@pytest.mark.parametrize("vcycles", [0, 1])
def test_cell_limits_see_the_polish(vcycles):
    """The cell's limits (``benchmark/limits/vcycle_1080p.strokes.json``)
    fail a port that runs ``vcycles`` of the configuration's 2 cycles, here
    the reference so cut put in the program's place over the small cell's
    drawn updates, while they pass the port itself."""
    from benchmark import harness
    from benchmark.tests import small

    cell = spec.cell(BENCH, CELL)
    limits = spec.limits(CELL)
    cfg, traffic = small.config(cell), small.traffic(cell)
    with tempfile.TemporaryDirectory() as tmp:
        run = harness.DRIVERS[traffic["driver"]](cfg, traffic, 2**33 + 5, "cpu", tmp, REF)
        run.setup()
        run.window(0.3)
        run.release()
        assert check.verdict(run.check(), limits)[0]
        run.ref = _Unpolished(vcycles=vcycles)
        faulty = run.check(stand_in=torch.float64)
    assert not check.verdict(faulty, limits)[0], faulty


# ---------------------------------------------------- reference vs JAX
@pytest.mark.parametrize("h,w,base", SIZES)
def test_reference_agrees_with_the_jax_vcycle(h, w, base):
    """The reference's V-cycle against the JAX package's ``solve_vcycle``
    on the CPU: depth and every level of the state within RMSE 1e-3 on
    [0, 1] (the V-cycle's bound between implementations, README), the
    scribbles exact."""
    dcfg = small_cfg(base)
    rgb, mask, value = _scene(h, w, 2**35 + h + w)
    jcfg = JConfig(**dict(dcfg, backend="xla", fast_start=False))
    jpipe = JPipeline(h, w, jcfg)
    _, jgray = jpipe.prepare_image(rgb)
    jdepth, jstate = jmg.solve_vcycle(jgray, jnp.asarray(mask), jnp.asarray(value),
                                      jpipe.initial_state(), jcfg)
    fresh = [torch.full(tuple(g.shape), float(dcfg["depth_init"])) for g in jgray]
    _, _, st = _reference(dcfg, rgb, mask, value, fresh)
    assert len(st) == len(jstate)
    for ours, theirs in zip(st, jstate):
        assert check.rmse(ours, torch.from_numpy(np.array(theirs))) / 255.0 <= 1e-3
    d = st[0].numpy()
    assert np.array_equal(d[mask], value[mask].astype(np.float32))
    assert check.rmse(d, np.asarray(jdepth)) / 255.0 <= 1e-3


def test_reference_refuses_the_cascade_and_keeps_plain():
    assert REF is not plain and REF.cascade is not plain.cascade
    assert all(getattr(REF, f) is getattr(plain, f) for f in plain.INTERFACE if f != "cascade")
    with pytest.raises(ValueError, match="V-cycle only"):
        REF.cascade(dict(VCYCLE["diffusion"], multigrid="cascadic"), [], [], [], [],
                    torch.float32)
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert REF.warm_iterations(VCYCLE["diffusion"]) == 1000
    assert REF.warm_iterations(dict(VCYCLE["diffusion"], vcycle_warm_fraction=0.01)) == 40


# --------------------------------------------------- the span and counters
def test_vcycle_work_by_hand():
    """1080p's five levels: 16 sweeps a level on L0-L3 and 200 on L4, two
    cycles."""
    cfg = DiffusionConfig(**VCYCLE["diffusion"])
    sizes = [cfg.level_size(1080, 1920, lv) for lv in range(5)]
    assert sizes == [(1080, 1920), (540, 960), (270, 480), (135, 240), (67, 120)]
    px = [h * w for h, w in sizes]
    assert tmg.vcycle_work(sizes, cfg) == (2, 2 * (16 * sum(px[:4]) + 200 * px[4]),
                                           2 * sum(px))
    assert tmg.vcycle_work(sizes[:1], cfg) == (2, 2 * 200 * px[0], 2 * px[0])


def _profiled_solves(s, n):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(n):
            s.solve()


@pytest.mark.parametrize("h,w,base", SIZES)
def test_polish_counters_count_the_smoothing(monkeypatch, h, w, base):
    """``vcycle.*`` against ``_smooth_error``'s own calls in an
    instrumented run (pre 3, post 5, coarse 7 sweeps, so that each call
    names its kind): nothing without a profiler; under one, per solve, the
    cycles, the pixel-sweeps and the pixels of each level visit."""
    dcfg = small_cfg(base, vcycle_pre_smooth=3, vcycle_post_smooth=5, vcycle_coarse_iters=7,
                     vcycles=3)
    calls = []
    real = tmg._smooth_error

    def counted(e, rhs, mask, wts, sweeps):
        calls.append((e.numel(), sweeps))
        return real(e, rhs, mask, wts, sweeps)

    monkeypatch.setattr(tmg, "_smooth_error", counted)
    s = DepthSession(_scene(h, w, 5)[0], DiffusionConfig(**dcfg), device="cpu")
    s.set_effect_key("b")
    s.solve()
    assert not any(c in s.timer.counts for c in COUNTERS) and calls
    calls.clear()
    _profiled_solves(s, 2)
    finest = h * w
    pre = [px for px, n in calls if n == 3]
    coarse = [px for px, n in calls if n == 7]
    assert len(calls) == len(pre) + len(coarse) + len([1 for _, n in calls if n == 5])
    assert s.timer.counts["vcycle.cycles"] == sum(1 for px in pre if px == finest) == 2 * 3
    assert s.timer.counts["vcycle.px_sweeps"] == sum(px * n for px, n in calls)
    assert s.timer.counts["vcycle.px"] == sum(pre) + sum(coarse)
    assert len(coarse) == 2 * 3 and s.timer.counts["vcycle.px"] > 2 * 3 * finest


@pytest.mark.parametrize("h,w,base", SIZES)
def test_smooth_kernel_counter_reads_zero_on_the_cpu(h, w, base):
    """``vcycle.smooth_kernel`` counts the smoothing passes on the kernel
    route: under a profiler it is there after each full V-cycle solve and
    reads 0 on the CPU, where every pass takes the plain route
    (``ops/dispatch.py:smooth_passes``), two a finer level and one at the
    coarsest, each cycle."""
    dcfg = small_cfg(base)
    s = DepthSession(_scene(h, w, 8)[0], DiffusionConfig(**dcfg), device="cpu")
    s.set_effect_key("b")
    plain = dispatch.smooth_passes["plain"]
    _profiled_solves(s, 2)
    assert s.timer.counts["vcycle.smooth_kernel"] == 0 and "vcycle.smooth_kernel" in s.timer.totals
    levels = s.pipe.levels
    assert dispatch.smooth_passes["plain"] - plain == 2 * dcfg["vcycles"] * (2 * levels - 1)


def test_polish_counters_stay_off_the_cascade():
    s = DepthSession(_scene(96, 160, 6)[0],
                     DiffusionConfig(**small_cfg(24, multigrid="cascadic")), device="cpu")
    _profiled_solves(s, 1)
    assert not any(c in s.timer.counts for c in COUNTERS)
    assert "vcycle.polish" not in s.timer.counts


def test_polish_span_in_the_timing_report():
    """The span ``vcycle.polish`` counts each solve's polish (eager on the
    CPU) in the session's timer and its report."""
    s = DepthSession(_scene(96, 160, 7)[0], DiffusionConfig(**small_cfg(24)), device="cpu")
    s.solve()
    s.solve()
    assert s.timer.counts["vcycle.polish"] == 2 and s.timer.totals["vcycle.polish"] > 0.0
    assert "vcycle.polish:" in s.timing_report()


# ------------------------------------------------------- the configuration
def test_vcycle_1080p_config_routes():
    """``vcycle_1080p`` at 1080 x 1920: 5 levels, a 1937-sweep warm cascade
    (the whole budget), K2 on L4-L2 and K1 on L1-L0 by the H100's cluster
    and L2, the exact defocus on K3's 64-tile route, the 21 px brush."""
    cfg = DiffusionConfig(**VCYCLE["diffusion"])
    h, w = VCYCLE["rows"], VCYCLE["cols"]
    assert (h, w) == (1080, 1920) and VCYCLE["reduced"] == []
    assert cfg.multigrid == "vcycle" and cfg.incremental_iterations == 0
    levels = cfg.num_levels(h, w)
    assert levels == 5
    warm = tmg.vcycle_warm_config(cfg)
    assert sum(warm.level_iterations(levels, lv) for lv in range(levels)) == 1937
    cpu = torch.device("cpu")
    routes = [sweep.strip_route(*cfg.level_size(h, w, lv), dispatch.l2_bytes(cpu),
                                sweep.resident_max_cluster(cpu)) for lv in range(levels)]
    assert routes == ["K1", "K1", "K2", "K2", "K2"]
    assert [c[3] for c in DepthPipeline(h, w, cfg, device="cpu").level_calls()] == [False] * 5
    max_half = cfg.defocus_kernel_size(h, w) // 2
    assert max_half == 27
    assert effects.resolved_defocus_quality(cfg, max_half) == "exact"
    assert defocus.defocus_route(max_half) == ("tile", 64)
    assert cfg.brush_radius(h, w) == 21


def test_vcycle_1080p_differs_from_faithful_only_in_its_scheme():
    """The copy of ``faithful_1080p`` with ``multigrid`` changed and the V-cycle
    keys at their defaults, and its cell's metrics: every session metric of
    ``faithful_1080p.strokes`` but the two that read a cascade only, and the
    three of the polish."""
    a = copy.deepcopy(spec.config(BENCH, "faithful_1080p"))
    b = VCYCLE
    assert {k for k in a["diffusion"] if a["diffusion"][k] != b["diffusion"][k]} == {
        "multigrid"}
    assert set(a["diffusion"]) == set(b["diffusion"])
    defaults = DiffusionConfig()
    for k in ("vcycle_warm_fraction", "vcycle_pre_smooth", "vcycle_post_smooth",
              "vcycle_coarse_iters", "vcycles"):
        assert b["diffusion"][k] == getattr(defaults, k), k
    assert (a["rows"], a["cols"], a["effect"], a["assumed"]) == (
        b["rows"], b["cols"], b["effect"], b["assumed"])
    entry = [c for c in BENCH["configs"] if c["name"] == "vcycle_1080p"][0]
    assert entry["source"] == b["source"] and entry["reduced"] == b["reduced"] == []
    cell = spec.cell(BENCH, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("vcycle_1080p", "strokes", 1)
    per_layer = {m["name"] for m in spec.metrics_of(BENCH, CELL, "per_layer")}
    faithful = {m["name"] for m in spec.metrics_of(BENCH, "faithful_1080p.strokes", "per_layer")}
    assert per_layer == (faithful - {"update_mfu", "roofline.jc_sweep"}) | {
        "polish_ms", "roofline.vcycle_polish", "update_mfu.vcycle"}
    e2e = {m["name"] for m in spec.metrics_of(BENCH, CELL, "end_to_end")}
    assert e2e == {"update_ms", "update_p95_ms", "setup_s"}


# ------------------------------------------------------------- the readers
def _ev(name, seconds, kind="kernel"):
    return (name, kind, seconds)


def _record(device, counters=None, multigrid="vcycle", updates=2, window_s=0.05):
    """A traced record of ``updates`` V-cycle updates at 1080p."""
    c = dict(VCYCLE["diffusion"], multigrid=multigrid)
    return {"updates": updates, "rows": 1080, "cols": 1920, "config": c, "device": device,
            "busy_s": 0.04, "window_s": window_s,
            "stages": {k: (0.0, n) for k, n in (counters or {}).items()}}


def _update(polish):
    """One update's device operations: K2, K1 twice, the polish's ``polish``
    operations, K3, the readback."""
    return ([_ev("jc_sweep_resident_kernel", 1e-3), _ev("jc_sweep_tiles_kernel", 2e-4),
             _ev("elementwise_kernel", 5e-5), _ev("jc_sweep_tiles_kernel", 2e-4)]
            + [_ev(n, s, k) for n, s, k in polish]
            + [_ev("defocus_tile_kernel", 7e-5), _ev("Memcpy DtoH (Device -> Pageable)", 6e-4,
                                                    "memcpy")])


POLISH = [("vectorized_elementwise_kernel", 4e-3, "kernel"),
          ("reduce_kernel", 1e-3, "kernel"), ("Memset (Device)", 1e-5, "memset")]
WORK = tmg.vcycle_work([(1080 >> lv, 1920 >> lv) for lv in range(5)],
                       DiffusionConfig(**VCYCLE["diffusion"]))


def test_polish_ms_reads_the_window_between_k1_and_k3():
    read = spec.reader("polish_ms")
    rec = _record(_update(POLISH) + _update(POLISH[:1]))
    # (4 + 1 + 0.01) ms and 4 ms over two updates
    assert read(rec) == pytest.approx((5.01 + 4.0) / 2)
    assert read(_record(_update(POLISH), updates=1)) == pytest.approx(5.01)
    # nothing to read: a cascade, no K3, no K1
    assert read(_record(_update(POLISH), multigrid="cascadic")) is None
    assert read(_record(_update(POLISH)[:-2])) is None
    assert read(_record([d for d in _update(POLISH) if "tiles" not in d[0]])) is None


def test_polish_ms_names_the_kernels_as_the_trace_does():
    assert trace.bare_name("void jc_sweep_tiles_kernel<8>(float const*, float*)") == \
        "jc_sweep_tiles_kernel"
    assert trace.bare_name("void (anonymous namespace)::defocus_tile_kernel<64, 2>(U8Image)") \
        == "defocus_tile_kernel"


def test_roofline_vcycle_polish_reads_the_counters():
    read = spec.reader("roofline.vcycle_polish")
    cycles, px_sweeps, px = WORK
    counters = {"vcycle.cycles": 2 * cycles, "vcycle.px_sweeps": 2 * px_sweeps,
                "vcycle.px": 2 * px}
    rec = _record(_update(POLISH) * 2, counters)
    # 9 FLOPs a pixel-sweep at 67 TFLOP/s against 21 bytes a pixel per
    # smoothing pass at 3.35 TB/s, two passes a visit of L0-L3 and one of
    # L4 (67 x 120): the bytes bound at 1080p
    coarse = 2 * cycles * 67 * 120
    passes = 2 * (2 * px) - coarse
    least = max(9 * 2 * px_sweeps / 67e12, 21 * passes / 3.35e12)
    assert least == 21 * passes / 3.35e12
    assert polish_work.least_s(2 * px_sweeps, 2 * px, coarse) == pytest.approx(least)
    assert read(rec) == pytest.approx(100.0 * least / (2 * 5.01e-3))
    assert read(rec) == pytest.approx(1.3804, abs=1e-4)
    assert read(_record(_update(POLISH) * 2)) is None
    assert read(_record(_update(POLISH) * 2, {c: 0 for c in counters})) is None
    assert read(_record(_update(POLISH) * 2, dict(counters, **{"vcycle.cycles": 0}))) is None
    assert read(_record(_update(POLISH)[:-2] * 2, counters)) is None


def test_update_mfu_vcycle_counts_cascade_polish_and_defocus():
    read = spec.reader("update_mfu.vcycle")
    cycles, px_sweeps, px = WORK
    counters = {"vcycle.cycles": 2 * cycles, "vcycle.px_sweeps": 2 * px_sweeps,
                "vcycle.px": 2 * px}
    rec = _record(_update(POLISH) * 2, counters)
    cascade = sum(14 * h * w * n for h, w, n in work.cascade_levels(1080, 1920, 45, 1000))
    flops = 2 * (cascade + 20 * 1080 * 1920) + 9 * 2 * px_sweeps
    assert read(rec) == pytest.approx(100.0 * flops / (0.05 * 67e12))
    # The warm budget, not max_iterations: a quarter of it halves no level
    # below the Chebyshev floor here.
    quarter = _record(_update(POLISH) * 2, counters)
    quarter["config"]["vcycle_warm_fraction"] = 0.25
    cascade_q = sum(14 * h * w * n for h, w, n in work.cascade_levels(1080, 1920, 45, 250))
    assert read(quarter) == pytest.approx(
        100.0 * (2 * (cascade_q + 20 * 1080 * 1920) + 9 * 2 * px_sweeps) / (0.05 * 67e12))
    assert read(_record(_update(POLISH) * 2)) is None
    assert read(_record(_update(POLISH) * 2, counters, multigrid="cascadic")) is None
