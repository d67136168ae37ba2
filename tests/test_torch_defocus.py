"""The port's plain defocus (what kernel K3 is held to on the card) against
the JAX package's ``defocus_xla`` and its Pallas kernel in interpret mode.
Integer box sums, one f32 divide and a u8 truncation: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.core import effects as jfx
from realtimedepthdiffusion_tpu.ops import pallas_defocus as jpd
from realtimedepthdiffusion_tpu_torch import ops
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import effects as tfx
from realtimedepthdiffusion_tpu_torch.ops import defocus as tpd

# The default aperture gives max_half 2-3 at these sizes; 0.3 gives 22 and
# 24, above exact_upto=16, so 'approx' really snaps.
QUALITIES = [
    {"pallas_defocus_quality": "exact"},
    {"pallas_defocus_quality": "approx", "pallas_defocus_exact_upto": 16,
     "pallas_defocus_stride": 4},
]


def _case(shape, seed):
    r = np.random.default_rng(seed)
    rgb = r.integers(0, 256, shape + (3,), dtype=np.uint8)
    # Depth spans the clip range and beyond, so every half 0..max_half occurs.
    depth = (r.random(shape) * 300.0 - 20.0).astype(np.float32)
    return rgb, depth


@pytest.mark.parametrize("shape", [(96, 160), (257, 130)])
@pytest.mark.parametrize("aperture", [0.025, 0.3])
@pytest.mark.parametrize("quality", QUALITIES, ids=["exact", "approx"])
def test_defocus_sat_bit_exact(shape, aperture, quality):
    rgb, depth = _case(shape, 11)
    jcfg = JConfig(defocus_aperture=aperture, **quality)
    tcfg = DiffusionConfig(defocus_aperture=aperture, **quality)
    got = tfx.defocus_sat(torch.from_numpy(rgb), torch.from_numpy(depth), tcfg).numpy()
    want_xla = np.asarray(jfx.defocus_xla(jnp.asarray(rgb), jnp.asarray(depth), jcfg))
    assert got.dtype == np.uint8 and got.shape == shape + (3,)
    assert np.array_equal(got, want_xla)
    if aperture == 0.3 and shape == (96, 160):
        # The Pallas interpreter is slow at large apertures: one case each.
        want_pallas = np.asarray(jpd.defocus_pallas(jnp.asarray(rgb), jnp.asarray(depth),
                                                    jcfg, interpret=True))
        assert np.array_equal(got, want_pallas)


@pytest.mark.parametrize("quality", QUALITIES, ids=["exact", "approx"])
def test_defocus_pallas_small_aperture_bit_exact(quality):
    rgb, depth = _case((257, 130), 12)
    jcfg, tcfg = JConfig(**quality), DiffusionConfig(**quality)
    want = np.asarray(jpd.defocus_pallas(jnp.asarray(rgb), jnp.asarray(depth), jcfg,
                                         interpret=True))
    got = tfx.defocus_sat(torch.from_numpy(rgb), torch.from_numpy(depth), tcfg).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(96, 160), (257, 130), (1080, 1920)])
@pytest.mark.parametrize("quality", QUALITIES, ids=["exact", "approx"])
def test_half_widths_equal_reference(shape, quality):
    """The half field at the pinned form, including 1080p's max_half 27."""
    _, depth = _case(shape, 13)
    jcfg, tcfg = JConfig(defocus_aperture=0.3, **quality), DiffusionConfig(defocus_aperture=0.3, **quality)
    if shape == (1080, 1920):
        jcfg, tcfg = JConfig(**quality), DiffusionConfig(**quality)
    want = np.asarray(jpd.defocus_half_widths(jnp.asarray(depth), *shape, jcfg))
    got = tpd.defocus_half_widths(torch.from_numpy(depth), *shape, tcfg).numpy()
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    k = tcfg.defocus_kernel_size(*shape)
    assert set(np.unique(got)) <= {0, *tpd.defocus_candidates(k // 2, tcfg)}


@pytest.mark.parametrize("max_half", [10, 16, 27, 55])
def test_candidates_and_snap_match_reference(max_half):
    cfg_kw = {"pallas_defocus_quality": "approx"}
    tcfg, jcfg = DiffusionConfig(**cfg_kw), JConfig(**cfg_kw)
    assert tpd.defocus_candidates(max_half, tcfg) == jfx.defocus_candidates(max_half, jcfg)
    half = np.arange(max_half + 1, dtype=np.int32)
    want = np.asarray(jfx.snap_half_widths(jnp.asarray(half), max_half, jcfg))
    got = tpd.snap_half_widths(torch.from_numpy(half), max_half, tcfg).numpy()
    assert np.array_equal(got, want)


def test_auto_quality_resolution_and_warning():
    cfg = DiffusionConfig()
    assert tpd.resolved_defocus_quality(cfg, 27) == "exact"
    with pytest.warns(RuntimeWarning, match="max_half 55"):
        assert tpd.resolved_defocus_quality(cfg, 55) == "approx"


def test_defocus_on_cpu_uses_plain_version():
    ops.reset_launch_counts()
    rgb, depth = _case((40, 50), 14)
    a = tfx.defocus(torch.from_numpy(rgb), torch.from_numpy(depth))
    b = tfx.defocus_sat(torch.from_numpy(rgb), torch.from_numpy(depth))
    assert torch.equal(a, b)
    assert ops.launch_counts()["defocus_box"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        tpd.defocus_box(torch.from_numpy(rgb), torch.from_numpy(depth))
    assert ops.launch_counts()["defocus_box"] == 0
