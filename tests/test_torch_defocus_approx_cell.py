"""The default 4K live session, whose ``auto`` defocus resolves to the
approximate blur (``faithful_4k_approx``), on the CPU at small sizes: its
reference's ``defocus`` (``benchmark/reference/faithful_4k_approx.py``)
bit for bit against the port's ``defocus_sat`` and the JAX package's
``defocus_xla``; ``auto`` resolved alike in the reference and the port;
the cell's limits, which pass the port and fail the exact blur put in its
place; the counters ``defocus.renders`` and ``defocus.approx`` and their
reader ``approx_share``; and the configuration against ``faithful_4k``."""

import collections
import tempfile
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark import check, gen, harness, spec
from benchmark.reference import plain
from benchmark.tests import small
from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.core import effects as jfx
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import effects as tfx
from realtimedepthdiffusion_tpu_torch.live.session import DepthSession
from realtimedepthdiffusion_tpu_torch.ops import defocus as tpd
from realtimedepthdiffusion_tpu_torch.utils.program import Program

BENCH = spec.load()
CONFIG = spec.config(BENCH, "faithful_4k_approx")
REF = spec.reference("faithful_4k_approx")
CELL = "faithful_4k_approx.strokes"
# (pallas_defocus_exact_upto, pallas_defocus_stride): the configuration's,
# a stride that does not divide max_half - exact_upto, and the smallest.
SNAPS = [(16, 4), (8, 3), (3, 2)]
# The small cell's 192 x 256 image has max_half 4: with these thresholds
# 'auto' snaps there (half-widths 2 and 4 go to 3), as it does at 4K.
SMALL_AUTO = {"pallas_defocus_auto_max_half": 3, "pallas_defocus_exact_upto": 1,
              "pallas_defocus_stride": 2}


def _dcfg(**kw):
    return dict(CONFIG["diffusion"], **kw)


def _case(shape, seed):
    r = np.random.default_rng(seed)
    rgb = r.integers(0, 256, shape + (3,), dtype=np.uint8)
    # Depth past both ends of the clip range, so that every half-width occurs.
    depth = (r.random(shape) * 300.0 - 20.0).astype(np.float32)
    return rgb, depth


def _port_cfg(dcfg):
    return DiffusionConfig(**dcfg)


def _jax_cfg(dcfg):
    return JConfig(**{k: v for k, v in dcfg.items() if k != "fast_start"})


# ----------------------------------------------------- reference vs port
@pytest.mark.parametrize("shape", [(96, 160), (130, 97)])
@pytest.mark.parametrize("upto,stride", SNAPS)
@pytest.mark.parametrize("quality", ["approx", "auto"])
def test_reference_defocus_equals_port_and_jax(shape, upto, stride, quality):
    """At aperture 0.3 max_half is 22 (96 x 160) or 24 (130 x 97), above
    every ``exact_upto`` here and above ``auto``'s threshold of 20, so both
    qualities snap; the three blurs agree bit for bit and differ from the
    exact one."""
    rgb, depth = _case(shape, 100 * upto + stride)
    dcfg = _dcfg(defocus_aperture=0.3, pallas_defocus_quality=quality,
                 pallas_defocus_exact_upto=upto, pallas_defocus_stride=stride,
                 pallas_defocus_auto_max_half=20)
    got = REF.defocus(dcfg, torch.from_numpy(rgb), torch.from_numpy(depth)).numpy()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        port = tfx.defocus_sat(torch.from_numpy(rgb), torch.from_numpy(depth),
                               _port_cfg(dcfg)).numpy()
    want = np.asarray(jfx.defocus_xla(jnp.asarray(rgb), jnp.asarray(depth), _jax_cfg(dcfg)))
    assert got.dtype == np.uint8 and got.shape == shape + (3,)
    assert np.array_equal(got, port) and np.array_equal(got, want)
    exact = plain.defocus(dict(dcfg, pallas_defocus_quality="exact"), torch.from_numpy(rgb),
                          torch.from_numpy(depth)).numpy()
    assert not np.array_equal(got, exact)


@pytest.mark.parametrize("quality", ["exact", "auto"])
def test_reference_defocus_equals_plain_where_exact(quality):
    """Where the quality resolves to exact (``auto`` at the default
    aperture: max_half 2 at 96 x 160) the reference is ``plain.defocus``."""
    rgb, depth = _case((96, 160), 7)
    dcfg = _dcfg(pallas_defocus_quality=quality)
    args = (torch.from_numpy(rgb), torch.from_numpy(depth))
    assert torch.equal(REF.defocus(dcfg, *args), plain.defocus(dict(dcfg, pallas_defocus_quality=
                                                                     "exact"), *args))


def test_reference_snaps_4k_halves_as_the_port():
    """At 2160 x 3840 (max_half 55) the configuration's halves 0-16 stay,
    17-55 go to 16 + 4j, ties upward, clamped to 52: the port's
    ``snap_half_widths`` and the JAX package's, every half-width."""
    dcfg = CONFIG["diffusion"]
    half = torch.arange(0, 56, dtype=torch.int32)
    got = REF.snap(dcfg, half, 55)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        port = tpd.snap_half_widths(half, 55, _port_cfg(dcfg))
    want = np.asarray(jfx.snap_half_widths(jnp.arange(0, 56, dtype=jnp.int32), 55,
                                           _jax_cfg(dcfg)))
    assert torch.equal(got, port) and np.array_equal(got.numpy(), want)
    by_hand = [h if h <= 16 else min(16 + 4 * ((h - 16 + 2) // 4), 52) for h in range(56)]
    assert got.tolist() == by_hand
    assert sorted(set(got.tolist()) - set(range(17))) == list(range(20, 53, 4))


@pytest.mark.parametrize("threshold", [1, 3, 27, 40, 55])
def test_auto_resolves_as_the_port(threshold):
    """``auto`` is exact while max_half <= ``pallas_defocus_auto_max_half``
    and approx above it, in the reference, the port and the JAX package;
    ``exact`` and ``approx`` stay as given."""
    for max_half in range(0, 60):
        for quality in ("auto", "exact", "approx"):
            dcfg = _dcfg(pallas_defocus_quality=quality, pallas_defocus_auto_max_half=threshold)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                port = tpd.resolved_defocus_quality(_port_cfg(dcfg), max_half)
            want = quality if quality != "auto" else (
                "exact" if max_half <= threshold else "approx")
            assert REF.quality(dcfg, max_half) == port == want, (max_half, quality)
            assert jfx.resolved_defocus_quality(_jax_cfg(dcfg), max_half) == want


def test_config_resolves_to_approx_at_4k_and_exact_at_1080p():
    dcfg = CONFIG["diffusion"]
    assert REF.aperture(dcfg, 2160, 3840) // 2 == 55
    assert REF.quality(dcfg, 55) == "approx"
    assert REF.quality(dcfg, REF.aperture(dcfg, 1080, 1920) // 2) == "exact"
    with pytest.warns(RuntimeWarning, match="max_half 55"):
        assert tpd.resolved_defocus_quality(_port_cfg(dcfg), 55) == "approx"


# --------------------------------------------------- the cell's limits
class _Faulty:
    """The cell's reference, whose solve asked in float64 (the check's
    stand-in) runs in float32 and is followed by the defocus of
    ``override``: the reference with one change put in the program's
    place. Asked in float32 (the check's own reference) it is the
    reference."""

    def __init__(self, **override):
        self.override, self.fault = override, False

    def __getattr__(self, name):
        return getattr(REF, name)

    def cascade(self, cfg, grays, masks, values, state, dt, **kw):
        self.fault = dt == torch.float64
        return REF.cascade(cfg, grays, masks, values, state,
                           torch.float32 if self.fault else dt, **kw)

    def defocus(self, cfg, rgb, depth):
        return REF.defocus(dict(cfg, **self.override) if self.fault else cfg, rgb, depth)


def _small_readings(*faults):
    """The small cell's numbers at ``SMALL_AUTO``: the port's, then each
    fault's (a dict of the defocus keys it overrides)."""
    cell = spec.cell(BENCH, CELL)
    cfg, traffic = small.config(cell), small.traffic(cell)
    cfg["diffusion"].update(SMALL_AUTO)
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        run = harness.DRIVERS[traffic["driver"]](cfg, traffic, 2**33 + 11, "cpu", tmp, REF)
        run.setup()
        run.window(0.3)
        run.release()
        out = [run.check()]
        for override in faults:
            run.ref = _Faulty(**override)
            out.append(run.check(stand_in=torch.float64))
    return out


def test_small_cell_limits_see_the_approximation():
    """The cell's limits (``benchmark/limits/faithful_4k_approx.strokes.json``)
    pass the port's approximate blur and fail planted fault (a), the exact
    blur in its place: on ``effect_rmse`` alone, since the fault's solve is
    the reference's own."""
    limits = spec.limits(CELL)
    port, exact = _small_readings({"pallas_defocus_quality": "exact"})
    assert check.verdict(port, limits)[0], port
    assert not check.verdict(exact, limits)[0], exact
    assert exact["effect_rmse"] > limits["effect_rmse"]
    assert exact["u8_rmse"] == exact["state_rmse"] == exact["scribble_err"] == 0


# ------------------------------------------------------------ counters
@pytest.mark.parametrize("quality,snaps", [("exact", 0), ("approx", 1), ("auto", 1)])
def test_render_counts_count_each_render_and_the_snapped(quality, snaps):
    """``render_counts`` grows by one render per ``defocus_sat`` call, and
    by one ``approx`` where the half-widths were snapped (``auto`` at
    max_half 22 over a threshold of 20)."""
    rgb, depth = _case((96, 160), 3)
    cfg = DiffusionConfig(defocus_aperture=0.3, pallas_defocus_quality=quality,
                          pallas_defocus_auto_max_half=20)
    before = collections.Counter(tpd.render_counts)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for _ in range(3):
            tfx.defocus(torch.from_numpy(rgb), torch.from_numpy(depth), cfg)
    grown = collections.Counter(tpd.render_counts)
    grown.subtract(before)
    assert (grown["renders"], grown["approx"]) == (3, 3 * snaps)


def test_every_program_replays_the_render_counts():
    """A ``Program`` takes the defocus renders of its capture back out and
    adds them at each replay, as it does the launch tallies: the render
    counter is among those of every program."""
    prog = Program(lambda *a: a, (torch.zeros(2),), torch.device("cpu"))
    assert any(c is tpd.render_counts for c in prog.counters)


def _session(dcfg, h=96, w=128):
    rng = np.random.default_rng(5)
    s = DepthSession(gen.photo_like(rng, h, w), DiffusionConfig(**dcfg), device="cpu")
    mask, value = gen.dense_scribbles(rng, h, w)
    s.mask_np[:], s.value_np[:] = mask, value
    s.mark_all_dirty()
    s.set_effect_key("b")
    return s


def _profiled_updates(s, n):
    s.timer.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for i in range(n):
            s.set_color_key(i % 5)
            s.paint(30 + 6 * i, 40)
            s.solve()
    return {k: s.timer.counts[k] for k in ("defocus.renders", "defocus.approx")}


@pytest.mark.parametrize("auto_max_half,approx", [(1, 3), (40, 0)])
def test_session_counts_its_renders_under_a_profiler_only(auto_max_half, approx):
    """Each solve with the effect latched renders once: ``defocus.renders``
    counts it, ``defocus.approx`` where ``auto`` snapped (max_half 4 at
    96 x 128, over a threshold of 1; not over 40). Without a profiler,
    neither counter is kept."""
    dcfg = _dcfg(max_iterations=40, pyramid_base_size=24,
                 pallas_defocus_auto_max_half=auto_max_half, pallas_defocus_exact_upto=1)
    s = _session(dcfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        s.solve()
        assert not any(k.startswith("defocus.") for k in s.timer.totals)
        assert _profiled_updates(s, 3) == {"defocus.renders": 3, "defocus.approx": approx}
        s.set_effect_key("b")
        s.effect = tfx.EFFECT_NONE
        assert _profiled_updates(s, 2) == {"defocus.renders": 0, "defocus.approx": 0}


# ------------------------------------------------------------ the reader
def _record(renders=None, approx=None):
    stages = {}
    if renders is not None:
        stages["defocus.renders"] = (0.0, renders)
        stages["defocus.approx"] = (0.0, approx)
    return {"stages": stages}


def test_approx_share_reads_the_counters():
    read = spec.reader("approx_share")
    assert read(_record(64, 64)) == 100.0
    assert read(_record(64, 0)) == 0.0
    assert read(_record(64, 16)) == 25.0
    assert read(_record(0, 0)) is None
    assert read(_record()) is None  # a port without the counters


def test_small_cell_traced_window_reads_approx_share():
    """The small cell's traced window on the CPU, the record read as the
    harness reads it: at ``SMALL_AUTO`` every update's one render snapped,
    so ``approx_share`` reads 100; under the exact quality 0."""
    cell = spec.cell(BENCH, CELL)
    cfg, traffic = small.config(cell), small.traffic(cell)
    cfg["diffusion"].update(SMALL_AUTO)
    for quality, share in (("auto", 100.0), ("exact", 0.0)):
        cfg["diffusion"]["pallas_defocus_quality"] = quality
        with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            run = harness.DRIVERS[traffic["driver"]](cfg, traffic, 2**33 + 13, "cpu", tmp, REF)
            run.setup()
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                rec = run.traced_window()
            run.release()
        assert rec["stages"]["defocus.renders"][1] == traffic["trace_updates"]
        assert spec.reader("approx_share")(rec) == share, quality


# ---------------------------------------------------- the configuration
def test_config_is_faithful_4k_at_the_default_defocus():
    """``faithful_4k_approx`` is ``faithful_4k`` but for the defocus quality,
    ``auto`` as the CLI leaves it, and every diffusion key is at the port's
    default; its reference re-exports ``plain`` but for ``defocus``."""
    exact = spec.config(BENCH, "faithful_4k")
    assert {k: v for k, v in CONFIG.items() if k not in ("source", "deployment", "assumed")} == {
        k: v for k, v in exact.items() if k not in ("source", "deployment", "assumed")} | {
        "diffusion": dict(exact["diffusion"], pallas_defocus_quality="auto")}
    # tests/conftest.py turns fast_start's default off through the environment.
    defaults = DiffusionConfig(fast_start=True)
    assert all(getattr(defaults, k) == v for k, v in CONFIG["diffusion"].items())
    entry = next(c for c in BENCH["configs"] if c["name"] == "faithful_4k_approx")
    assert entry["reduced"] == CONFIG["reduced"] == [] and entry["source"] == CONFIG["source"]
    assert REF is not plain and REF.defocus is not plain.defocus
    for f in plain.INTERFACE:
        if f != "defocus":
            assert getattr(REF, f) is getattr(plain, f), f
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32


def test_cell_reports_the_4k_metrics_and_approx_share():
    """The new cell reports what ``faithful_4k.strokes`` reports, and
    ``approx_share``, which no other cell lists."""
    names = {m["name"] for m in spec.metrics_of(BENCH, CELL, "per_layer")}
    exact = {m["name"] for m in spec.metrics_of(BENCH, "faithful_4k.strokes", "per_layer")}
    assert names == exact | {"approx_share"}
    e2e = {m["name"] for m in spec.metrics_of(BENCH, CELL, "end_to_end")}
    assert e2e == {"update_ms", "update_p95_ms", "setup_s"}
    share = next(m for m in BENCH["per_layer"] if m["name"] == "approx_share")
    assert share["workloads"] == [CELL] and share["moves"] == "update_ms"
    assert spec.cell(BENCH, CELL)["chips"] == 1
