"""The port's glue ops against the JAX package on the CPU: color, pyramids,
annotation pyrDown, edge weights, the config and the Chebyshev schedule.

Inputs come from numpy seeds; both sides get the same arrays."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu import config as jcfg
from realtimedepthdiffusion_tpu.core import annotation as jann
from realtimedepthdiffusion_tpu.core import color as jcolor
from realtimedepthdiffusion_tpu.core import effects as jfx
from realtimedepthdiffusion_tpu.core import pyramid as jpyr
from realtimedepthdiffusion_tpu.core import solver as jsolver
from realtimedepthdiffusion_tpu.core import weights as jweights
from realtimedepthdiffusion_tpu.ops import pallas_sweep as jps
from realtimedepthdiffusion_tpu_torch import config as tcfg
from realtimedepthdiffusion_tpu_torch import interop
from realtimedepthdiffusion_tpu_torch.core import annotation as tann
from realtimedepthdiffusion_tpu_torch.core import color as tcolor
from realtimedepthdiffusion_tpu_torch.core import effects as tfx
from realtimedepthdiffusion_tpu_torch.core import pyramid as tpyr
from realtimedepthdiffusion_tpu_torch.core import solver as tsolver
from realtimedepthdiffusion_tpu_torch.core import weights as tweights

SHAPES = [(37, 52), (48, 64), (23, 70)]  # odd/odd, even/even, odd/even


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("shape", SHAPES)
def test_rgb_to_gray_exact(shape):
    rgb = np.random.default_rng(1).integers(0, 256, shape + (3,), dtype=np.uint8)
    want = np.asarray(jcolor.rgb_to_gray(jnp.asarray(rgb)))
    got = tcolor.rgb_to_gray(_t(rgb)).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("fn", ["pyr_down_gray", "pyr_down_gray_ceil"])
def test_pyr_down_exact(shape, fn):
    gray = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    want = np.asarray(getattr(jpyr, fn)(jnp.asarray(gray)))
    got = getattr(tpyr, fn)(_t(gray)).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, want)


@pytest.mark.parametrize("src,out", [((20, 31), (40, 62)), ((20, 31), (41, 63)),
                                     ((19, 24), (39, 48)), ((11, 9), (22, 19))])
def test_pyr_up_within_one_ulp(src, out):
    a = (np.random.default_rng(3).random(src) * 255.0).astype(np.float32)
    want = np.asarray(jpyr.pyr_up(jnp.asarray(a), out))
    got = tpyr.pyr_up(_t(a), out).numpy()
    assert got.shape == want.shape == out and got.dtype == np.float32
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert np.all(np.abs(got - want) <= ulp)


@pytest.mark.parametrize("shape", SHAPES)
def test_annotation_pyr_down_exact(shape):
    r = np.random.default_rng(4)
    mask = r.random(shape) < 0.3
    value = r.integers(0, 256, shape, dtype=np.uint8)
    out = (shape[0] // 2, shape[1] // 2)
    wm, wv = jann.annotation_pyr_down(jnp.asarray(mask), jnp.asarray(value), out)
    gm, gv = tann.annotation_pyr_down(_t(mask), _t(value), out)
    assert np.array_equal(gm.numpy(), np.asarray(wm))
    assert np.array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("mode", ["opencv", "floor"])
def test_gray_pyramid_exact(mode):
    """Both gray-chain conventions on an odd 3-level image (ceil-crop vs floor)."""
    from realtimedepthdiffusion_tpu.core import multigrid as jmg
    from realtimedepthdiffusion_tpu_torch.core import multigrid as tmg

    gray = np.random.default_rng(7).integers(0, 256, (187, 371), dtype=np.uint8)
    want = jmg.build_gray_pyramid(jnp.asarray(gray), jcfg.DiffusionConfig(gray_pyramid=mode))
    got = tmg.build_gray_pyramid(_t(gray), tcfg.DiffusionConfig(gray_pyramid=mode))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_annotation_pyramids_exact():
    from realtimedepthdiffusion_tpu.core import multigrid as jmg
    from realtimedepthdiffusion_tpu_torch.core import multigrid as tmg

    r = np.random.default_rng(8)
    mask = r.random((187, 371)) < 0.1
    value = r.integers(0, 256, (187, 371), dtype=np.uint8)
    wm, wv = jmg.build_annotation_pyramids(jnp.asarray(mask), jnp.asarray(value),
                                           jcfg.DiffusionConfig())
    gm, gv = tmg.build_annotation_pyramids(_t(mask), _t(value), tcfg.DiffusionConfig())
    for a, b in zip(gm + gv, wm + wv):
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_seed_depth_exact():
    r = np.random.default_rng(5)
    depth = (r.random((17, 23)) * 300 - 20).astype(np.float32)
    mask = r.random((17, 23)) < 0.2
    value = r.integers(0, 256, (17, 23), dtype=np.uint8)
    want = np.asarray(jann.seed_depth(jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(value)))
    got = tann.seed_depth(_t(depth), _t(mask), _t(value)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("level,max_level", [(2, 2), (1, 2), (0, 2)])
def test_edge_weights(level, max_level):
    """rtol 1e-6: torch's and XLA's exp may differ in the last bits. The
    threshold rule (which weights are exactly 1 or 0) and the tiny pins
    (which pixels are isolated) must agree exactly."""
    r = np.random.default_rng(6)
    h, w = 41, 57
    gray = r.integers(0, 256, (h, w), dtype=np.uint8)
    gray[5:9, :] = 255  # contrast 255 rows next to 0: weights pinned to 0
    gray[9:12, :] = 0
    gray[20, 20] = 0  # an isolated pixel: every neighbour at contrast 255
    gray[19, 20] = gray[21, 20] = gray[20, 19] = gray[20, 21] = 255
    depth = (r.random((h, w)) * 300 - 20).astype(np.float32)
    want = jweights.edge_weights(jnp.asarray(gray), jnp.asarray(depth), level, max_level)
    got = tweights.edge_weights(_t(gray), _t(depth), level, max_level)
    for name in tweights.EdgeWeights._fields:
        g = getattr(got, name).numpy()
        wnt = np.asarray(getattr(want, name))
        assert g.dtype == np.float32 and g.shape == wnt.shape
        np.testing.assert_allclose(g, wnt, rtol=1e-6, atol=0, err_msg=name)
        assert np.array_equal(g == 0, wnt == 0), name
        assert np.array_equal(g == 1, wnt == 1), name
    assert got.inv_count[20, 20] == 0


def test_config_matches_reference():
    jf = {f.name: f for f in dataclasses.fields(jcfg.DiffusionConfig)}
    tf = {f.name: f for f in dataclasses.fields(tcfg.DiffusionConfig)}
    assert list(jf) == list(tf)
    assert dataclasses.asdict(jcfg.DiffusionConfig()) == dataclasses.asdict(tcfg.DiffusionConfig())
    assert tcfg.SCRIBBLE_DEPTH_VALUES == jcfg.SCRIBBLE_DEPTH_VALUES
    for rows, cols in [(1080, 1920), (181, 243), (2160, 3840), (44, 90)]:
        j, t = jcfg.DEFAULT_CONFIG, tcfg.DEFAULT_CONFIG
        n = j.num_levels(rows, cols)
        assert t.num_levels(rows, cols) == n
        assert t.defocus_kernel_size(rows, cols) == j.defocus_kernel_size(rows, cols)
        for l in range(n):
            assert t.level_size(rows, cols, l) == j.level_size(rows, cols, l)
            assert t.level_iterations(n, l) == j.level_iterations(n, l)


@pytest.mark.parametrize("kw", [
    {"residual_metric": "median"},
    {"pallas_defocus_variant": "stackd"},
    {"pallas_defocus_quality": "fast"},
    {"pallas_defocus_stride": 1},
    {"pallas_defocus_variant": "coldiff"},
])
def test_config_validation_matches_reference(kw):
    with pytest.raises(ValueError):
        jcfg.DiffusionConfig(**kw)
    with pytest.raises(ValueError):
        tcfg.DiffusionConfig(**kw)


def test_config_refuses_auto_threshold_below_one():
    """The one deliberate difference: the reference accepts any threshold."""
    jcfg.DiffusionConfig(pallas_defocus_auto_max_half=0)
    with pytest.raises(ValueError, match="auto_max_half"):
        tcfg.DiffusionConfig(pallas_defocus_auto_max_half=0)
    tcfg.DiffusionConfig(pallas_defocus_auto_max_half=0, pallas_defocus_quality="exact")


def test_config_from_dict_round_trip():
    j = jcfg.DiffusionConfig(beta=0.5, pallas_defocus_quality="approx", backend="xla")
    t = interop.config_from_dict(dataclasses.asdict(j))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    with pytest.raises(ValueError, match="unknown"):
        interop.config_from_dict({"beta": 0.4, "not_a_field": 1})


@pytest.mark.parametrize("iters", [1, 10, 11, 62, 1000])
def test_chebyshev_schedule_bit_identical(iters):
    cfg = tcfg.DiffusionConfig()
    assert np.array_equal(tsolver.chebyshev_omegas(iters, cfg),
                          jsolver.chebyshev_omegas(iters, jcfg.DiffusionConfig()))
    got = tsolver.abc_schedule(iters, cfg)
    want = jps._abc_schedule(iters, jcfg.DiffusionConfig())
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_desaturation_and_haze(rng):
    """Pointwise f32 effects, truncated to u8: within one level (XLA may
    contract an FMA that torch rounds twice, and exp differs in the last bit)."""
    rgb = rng.integers(0, 256, (31, 45, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (31, 45), dtype=np.uint8)
    depth = (rng.random((31, 45)) * 255).astype(np.float32)
    pairs = [
        (jfx.desaturation(jnp.asarray(rgb), jnp.asarray(gray), jnp.asarray(depth)),
         tfx.desaturation(_t(rgb), _t(gray), _t(depth))),
        (jfx.haze(jnp.asarray(rgb), jnp.asarray(depth)), tfx.haze(_t(rgb), _t(depth))),
    ]
    for want, got in pairs:
        want = np.asarray(want).astype(np.int32)
        assert got.dtype == torch.uint8
        assert np.abs(got.numpy().astype(np.int32) - want).max() <= 1
