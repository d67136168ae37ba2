"""The port's windowed incremental re-solve (``core/incremental.py`` and its
entry points on ``DepthPipeline``) against the JAX package on the CPU.

Each case starts from JAX's own full solve, carried over with
``interop.state_from_numpy``, adds a scribble near the edit's centre, and
runs ``solve_incremental`` on both sides: depth and every level of the new
state within RMSE 1e-3 on [0, 1] (tests/test_golden.py), scribbles exact.
The centres lie inside the image, at (0, 0) and past the far corner, where
the window's origin is clamped into the level. Past the far edges that is
what ``lax.dynamic_slice`` does too. A negative start it first wraps (it
adds the axis length, then clamps), which puts the reference's window of an
edit near the top or left edge at the far side of the image: a fault the
port does not copy. There JAX is given the centre whose window starts at 0,
the window the port clamps to. JAX runs at ``backend="xla",
fast_start=False``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.core import effects as jfx
from realtimedepthdiffusion_tpu.pipeline import DepthPipeline as JPipeline
from realtimedepthdiffusion_tpu_torch import DepthPipeline, interop, ops
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import effects as tfx
from realtimedepthdiffusion_tpu_torch.core import incremental
from tests.conftest import synthetic_pair

H, W = 200, 260  # 3 levels: 200x260, 100x130, 50x65
BASE = {"max_iterations": 100, "incremental_window": 64}
# (solver, incremental_iterations, incremental_global_smooth, incremental_window_levels)
CONFIGS = [
    ("jacobi_chebyshev", 40, 0, 2),
    ("jacobi_chebyshev", 0, 4, 2),
    ("jacobi_chebyshev", 40, 4, 1),
    ("red_black", 40, 0, 2),
    ("red_black", 0, 4, 1),
]
# centre (y, x), the centre JAX is given for the same window, and the
# scribble added before the re-solve (rows, columns, value)
EDITS = {
    "inside": ((100, 130), (100, 130), (slice(95, 105), slice(125, 135), 64)),
    "origin": ((0, 0), (32, 32), (slice(2, 8), slice(2, 8), 192)),
    "past_far_corner": ((400, 600), (400, 600), (slice(190, 196), slice(250, 256), 128)),
}


def _rmse(a, b):
    return float(np.sqrt(np.mean(((np.asarray(a) - np.asarray(b)) / 255.0) ** 2)))


def _kw(solver, inc, glob, levels):
    return dict(BASE, solver=solver, incremental_iterations=inc, incremental_global_smooth=glob,
                incremental_window_levels=levels)


def _edit(mask, value, name):
    center, jcenter, (rows, cols, val) = EDITS[name]
    mask2, value2 = mask.copy(), value.copy()
    mask2[rows, cols] = True
    value2[rows, cols] = val
    return center, jcenter, mask2, value2


@pytest.fixture(scope="module", params=CONFIGS, ids=lambda c: "-".join(map(str, c)))
def base_run(request):
    """JAX's full solve under one config, and both pipelines."""
    kw = _kw(*request.param)
    rgb, mask, value = synthetic_pair(H, W)
    jpipe = JPipeline(H, W, JConfig(backend="xla", fast_start=False, **kw))
    jrgb, jg = jpipe.prepare_image(rgb)
    _, js = jpipe.solve(jg, jnp.asarray(mask), jnp.asarray(value), jpipe.initial_state())
    pipe = DepthPipeline(H, W, DiffusionConfig(**kw), device="cpu")
    rgb_d, g = pipe.prepare_image(rgb)
    return {"rgb": rgb, "mask": mask, "value": value, "jpipe": jpipe, "jg": jg, "jrgb": jrgb,
            "jstate": tuple(np.asarray(s) for s in js), "pipe": pipe, "g": g, "rgb_d": rgb_d}


def _jax_incremental(run, mask2, value2, center):
    state = tuple(jnp.array(s) for s in run["jstate"])  # the call may donate it
    d, s = run["jpipe"].solve_incremental(run["jg"], jnp.asarray(mask2), jnp.asarray(value2),
                                          state, jnp.asarray(center, jnp.int32))
    return np.asarray(d), tuple(np.asarray(x) for x in s)


@pytest.mark.parametrize("edit", list(EDITS))
def test_solve_incremental_matches_jax(base_run, edit):
    center, jcenter, mask2, value2 = _edit(base_run["mask"], base_run["value"], edit)
    jd, jstate = _jax_incremental(base_run, mask2, value2, jcenter)
    state = interop.state_from_numpy(base_run["jstate"], "cpu")
    kept = tuple(s.clone() for s in state)
    m, v = interop.annotation_from_numpy(mask2, value2, "cpu")
    ops.reset_launch_counts()
    depth, new_state = base_run["pipe"].solve_incremental(base_run["g"], m, v, state, center)
    d = depth.numpy()
    assert _rmse(d, jd) <= 1e-3
    assert np.array_equal(d[mask2], value2[mask2].astype(np.float32))
    assert new_state[0] is depth and len(new_state) == len(jstate)
    for s, js in zip(new_state, jstate):
        assert _rmse(s.numpy(), js) <= 1e-3
    for s, k in zip(state, kept):  # the caller's state is not changed in place
        assert torch.equal(s, k)
    assert _rmse(d, base_run["jstate"][0]) > 1e-4  # the edit did move the depth
    assert not any(ops.launch_counts().values())
    if jcenter != center:  # a clamped window is the window of the centre that needs no clamp
        again, _ = base_run["pipe"].solve_incremental(base_run["g"], m, v, state, jcenter)
        assert torch.equal(again, depth)


@pytest.fixture(scope="module")
def port_run():
    """The port's own full solve under the first config (no JAX)."""
    rgb, mask, value = synthetic_pair(H, W)
    pipe = DepthPipeline(H, W, DiffusionConfig(**_kw(*CONFIGS[0])), device="cpu")
    _, g = pipe.prepare_image(rgb)
    _, _, mask2, value2 = _edit(mask, value, "inside")
    _, state = pipe.solve(g, *interop.annotation_from_numpy(mask, value, "cpu"),
                          pipe.initial_state())
    return pipe, g, interop.annotation_from_numpy(mask2, value2, "cpu"), state


@pytest.mark.parametrize("center", [[100, 130], np.array([100, 130]), torch.tensor([100, 130]),
                                    np.array([100, 130], np.int32)],
                         ids=["list", "numpy", "cpu_tensor", "int32"])
def test_center_forms_agree(port_run, center):
    """A pair, a numpy array and a CPU tensor name the same centre."""
    pipe, g, (m, v), state = port_run
    want, _ = pipe.solve_incremental(g, m, v, state, (100, 130))
    got, _ = pipe.solve_incremental(g, m, v, state, center)
    assert torch.equal(got, want)


def test_device_center_is_refused():
    """A centre on a device other than the CPU and the pipeline's is
    refused: the solve would read it across devices. (One on the
    pipeline's device is used as it is, and a host centre is uploaded.)"""
    pipe = DepthPipeline(64, 64, DiffusionConfig(max_iterations=8), device="cpu")
    z = torch.zeros(64, 64)
    with pytest.raises(ValueError, match="host integers"):
        pipe.solve_incremental((z.to(torch.uint8),), z.bool(), z.to(torch.uint8), (z,),
                               torch.empty(2, dtype=torch.int32, device="meta"))


def test_outside_the_window_only_the_injected_field_moves(base_run):
    """With one windowed level and no global sweeps, level 0 outside the
    window is the old state plus the pyrUp'd coarse correction, re-seeded:
    the window solve writes nothing there."""
    from realtimedepthdiffusion_tpu_torch.core.annotation import seed_depth
    from realtimedepthdiffusion_tpu_torch.core.pyramid import pyr_up

    cfg = base_run["pipe"].cfg
    if cfg.incremental_window_levels != 1 or cfg.incremental_global_smooth:
        cfg = DiffusionConfig(**dict(_kw("jacobi_chebyshev", 40, 0, 1)))
    pipe = DepthPipeline(H, W, cfg, device="cpu")
    center, _, mask2, value2 = _edit(base_run["mask"], base_run["value"], "inside")
    m, v = interop.annotation_from_numpy(mask2, value2, "cpu")
    state = interop.state_from_numpy(base_run["jstate"], "cpu")
    depth, new_state = pipe.solve_incremental(base_run["g"], m, v, state, center)
    injected = seed_depth(state[0] + pyr_up(new_state[1] - state[1], (H, W)), m, v)
    win = cfg.incremental_window
    oy, ox = center[0] - win // 2, center[1] - win // 2
    outside = torch.ones(H, W, dtype=torch.bool)
    outside[oy + 1:oy + win - 1, ox + 1:ox + win - 1] = False  # the ring is frozen too
    assert torch.equal(depth[outside], injected[outside])
    assert not torch.equal(depth[~outside], injected[~outside])


@pytest.mark.parametrize("solver", ["jacobi_chebyshev", "red_black"])
def test_small_image_takes_no_windowed_level(solver):
    """An image no larger than the window re-solves every level whole: the
    centre changes nothing, and the result tracks JAX's."""
    h, w = 60, 80
    kw = dict(BASE, solver=solver, incremental_iterations=40)
    rgb, mask, value = synthetic_pair(h, w)
    jpipe = JPipeline(h, w, JConfig(backend="xla", fast_start=False, **kw))
    _, jg = jpipe.prepare_image(rgb)
    _, js = jpipe.solve(jg, jnp.asarray(mask), jnp.asarray(value), jpipe.initial_state())
    js = tuple(np.asarray(s) for s in js)
    mask2, value2 = mask.copy(), value.copy()
    mask2[5:9, 60:66] = True
    value2[5:9, 60:66] = 128
    jd, _ = jpipe.solve_incremental(jg, jnp.asarray(mask2), jnp.asarray(value2),
                                    tuple(jnp.array(s) for s in js),
                                    jnp.asarray([7, 63], jnp.int32))
    pipe = DepthPipeline(h, w, DiffusionConfig(**kw), device="cpu")
    _, g = pipe.prepare_image(rgb)
    m, v = interop.annotation_from_numpy(mask2, value2, "cpu")
    state = interop.state_from_numpy(js, "cpu")
    d1, _ = pipe.solve_incremental(g, m, v, state, (7, 63))
    d2, _ = pipe.solve_incremental(g, m, v, state, (50, 10))
    assert torch.equal(d1, d2)
    assert _rmse(d1.numpy(), np.asarray(jd)) <= 1e-3
    assert np.array_equal(d1.numpy()[mask2], value2[mask2].astype(np.float32))


@pytest.mark.parametrize("origin", [(10, 20), (-5, -5), (190, 250), (-3, 500), (136, 196)])
def test_update_annotation_window_matches_jax(origin):
    """The dirty-window upload writes where ``lax.dynamic_update_slice``
    writes: an origin that would put the window past an edge is clamped. A
    negative origin clamps to 0, where JAX is given 0 (it would wrap)."""
    r = np.random.default_rng(3)
    mask = r.random((H, W)) < 0.1
    value = r.integers(0, 255, (H, W), dtype=np.uint8)
    mask_win = r.random((64, 64)) < 0.5
    value_win = r.integers(0, 255, (64, 64), dtype=np.uint8)
    jpipe = JPipeline(H, W, JConfig(backend="xla", fast_start=False))
    jm, jv = jpipe.update_annotation_window(jnp.asarray(mask), jnp.asarray(value),
                                            jnp.asarray(mask_win), jnp.asarray(value_win),
                                            jnp.asarray([max(o, 0) for o in origin], jnp.int32))
    pipe = DepthPipeline(H, W, DiffusionConfig(), device="cpu")
    m, v = interop.annotation_from_numpy(mask, value, "cpu")
    m2, v2 = pipe.update_annotation_window(m, v, mask_win, torch.from_numpy(value_win), origin)
    assert m2.dtype == torch.bool and v2.dtype == torch.uint8
    assert np.array_equal(m2.numpy(), np.asarray(jm)) and np.array_equal(v2.numpy(), np.asarray(jv))
    assert np.array_equal(m.numpy(), mask) and np.array_equal(v.numpy(), value)  # new planes


@pytest.mark.parametrize("center,level,win,size,want", [
    (5, 0, 384, 1080, 0), (5, 1, 192, 540, 0), (1079, 0, 384, 1080, 696),
    (-9, 1, 32, 100, 0), (-9, 0, 8, 100, 0), (50, 0, 8, 100, 46), (10_000, 2, 16, 50, 34),
])
def test_window_origin_clamps_like_dynamic_slice(center, level, win, size, want):
    """(centre >> level) - win // 2, clamped into [0, size - win]: the start
    ``lax.dynamic_slice`` reads from, unless the start is negative (which
    JAX wraps to the far side before it clamps; the port clamps to 0).
    ``>>`` floors a negative centre in Python as in int32."""
    from jax import lax

    start = (center >> level) - win // 2
    assert start == int((jnp.int32(center) >> level) - win // 2)
    got, _ = incremental.clamp_origin(start, 0, win, 1, size, 1)
    assert got == want
    if start >= 0:
        probe = lax.dynamic_slice(jnp.arange(size), (jnp.int32(start),), (win,))
        assert int(probe[0]) == want


@pytest.mark.parametrize("win", [2, 3, 32])
def test_ring_matches_jax(win):
    from realtimedepthdiffusion_tpu.core import incremental as jinc

    got = incremental._ring(win)
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(jinc._ring(win)))


@pytest.mark.parametrize("effect", ["haze", "defocus"])
def test_solve_incremental_and_effect_matches_jax(base_run, effect):
    """Depth within the bar; the effect is the port's own effect of that
    depth, clipped, and within a gray level of JAX's on average."""
    jeff, teff = {"haze": (jfx.EFFECT_HAZE, tfx.EFFECT_HAZE),
                  "defocus": (jfx.EFFECT_DEFOCUS, tfx.EFFECT_DEFOCUS)}[effect]
    center, _, mask2, value2 = _edit(base_run["mask"], base_run["value"], "inside")
    jd, _, jout = base_run["jpipe"].solve_incremental_and_effect(
        jeff, base_run["jg"], base_run["jrgb"], jnp.asarray(mask2), jnp.asarray(value2),
        tuple(jnp.array(s) for s in base_run["jstate"]), jnp.asarray(center, jnp.int32))
    pipe = base_run["pipe"]
    m, v = interop.annotation_from_numpy(mask2, value2, "cpu")
    state = interop.state_from_numpy(base_run["jstate"], "cpu")
    depth, new_state, out = pipe.solve_incremental_and_effect(
        teff, base_run["g"], base_run["rgb_d"], m, v, state, center)
    assert _rmse(depth.numpy(), np.asarray(jd)) <= 1e-3
    assert new_state[0] is depth
    want = pipe.effect(teff, base_run["rgb_d"], base_run["g"][0], torch.clamp(depth, 0.0, 255.0))
    assert out.dtype == torch.uint8 and torch.equal(out, want)
    diff = np.abs(out.numpy().astype(np.int32) - np.asarray(jout).astype(np.int32))
    assert float(diff.mean()) <= 0.5


@pytest.mark.parametrize("solver", ["jacobi_chebyshev", "red_black"])
def test_incremental_early_exit_reports_levels(solver):
    """``exit_log`` passes through: under the early exit every level solve,
    windows and global sweeps included, reports in the order run."""
    kw = dict(BASE, solver=solver, incremental_iterations=40, incremental_global_smooth=4,
              early_exit=True, residual_check_every=10, tolerance=1e-9)
    rgb, mask, value = synthetic_pair(H, W)
    pipe = DepthPipeline(H, W, DiffusionConfig(**kw), device="cpu")
    _, g = pipe.prepare_image(rgb)
    m, v = interop.annotation_from_numpy(mask, value, "cpu")
    _, state = pipe.solve(g, m, v, pipe.initial_state())
    log = []
    pipe.solve_incremental(g, m, v, state, (100, 130), log)
    assert [(e["shape"], e["iters"]) for e in log] == [
        ((50, 65), 100), ((100, 130), 4), ((32, 32), 20), ((200, 260), 4), ((64, 64), 40)]
