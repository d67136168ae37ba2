"""The port's plain defocus (what kernel K3 is held to on the card) against
the JAX package's ``defocus_xla`` and its Pallas kernel in interpret mode,
K3's route rule, and the plain twin of its tile route (every tile from the
table of its own neighbourhood). Integer box sums, one f32 divide and a u8
truncation: every comparison is exact."""

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
from realtimedepthdiffusion_tpu_torch.ops.sweep import SMEM_PER_CTA

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


# max_half of the 1080p frame, the last two 64-tiles share an SM at and the
# first they do not, the 4K frame's, DCI 4K's, the last the tile route
# serves and the first it leaves to the table, the last a forced 64-tile
# holds and the first it does not, and the largest a u8 half-width allows.
@pytest.mark.parametrize("max_half,route,forced_tile", [
    (27, ("tile", 64), 64), (52, ("tile", 64), 64), (53, ("tile", 96), 96),
    (55, ("tile", 96), 96), (57, ("tile", 96), 96), (72, ("tile", 96), 96),
    (73, ("table", None), 64), (88, ("table", None), 64), (89, ("table", None), None),
    (255, ("table", None), None)])
def test_defocus_route(max_half, route, forced_tile):
    assert tpd.defocus_route(max_half) == route
    assert tpd.defocus_route(max_half, "table") == ("table", None)
    if route[0] == "tile":
        assert max_half <= tpd.DEFOCUS_TILE_MAX_HALF
        assert tpd.defocus_tile_smem(route[1], max_half) <= SMEM_PER_CTA
        assert tpd._check_route(route, max_half) == route[1]
    assert tpd._check_route(("table", None), max_half) == 0
    if forced_tile is None:
        assert all(tpd.defocus_tile_smem(t, max_half) > SMEM_PER_CTA for t in tpd.DEFOCUS_TILES)
        with pytest.raises(ValueError, match="no tile holds"):
            tpd.defocus_route(max_half, "tile")
        with pytest.raises(ValueError, match="does not serve"):
            tpd._check_route(("tile", 64), max_half)
    else:
        forced = tpd.defocus_route(max_half, "tile")
        assert forced == ("tile", forced_tile)
        assert tpd.defocus_tile_smem(forced_tile, max_half) <= SMEM_PER_CTA
        assert tpd.defocus_tile_smem(forced_tile, max_half) == 4 * (forced_tile + 2 * max_half + 1) ** 2


def test_defocus_route_refusals():
    assert tpd.DEFOCUS_TILES == (64, 96)
    # Two 64-tiles share an SM exactly while their tables take half of it.
    assert 2 * tpd.defocus_tile_smem(64, 52) <= SMEM_PER_CTA < 2 * tpd.defocus_tile_smem(64, 53)
    assert tpd.defocus_tile_smem(96, 72) <= SMEM_PER_CTA < tpd.defocus_tile_smem(96, 73)
    with pytest.raises(ValueError, match="force"):
        tpd.defocus_route(27, "tiles")
    for bad in (("tile", 48), ("tile", None), ("table", 64), ("sat", None)):
        with pytest.raises(ValueError, match="does not serve"):
            tpd._check_route(bad, 27)


@pytest.mark.parametrize("tile", [16, 64, 96])
@pytest.mark.parametrize("aperture", [0.05, 0.3])
@pytest.mark.parametrize("quality", QUALITIES, ids=["exact", "approx"])
def test_tile_twin_equals_reference(tile, aperture, quality):
    """The blur of every tile from its own region's table (the image's
    edge tiles and its interior ones, ragged at the right and lower edge,
    sharp tiles among them) equals ``defocus_xla``: exact."""
    shape = (150, 201)
    rgb, depth = _case(shape, 21)
    depth[:70, :70] = 0.0  # sharp tiles: the tile route copies them
    jcfg = JConfig(defocus_aperture=aperture, **quality)
    tcfg = DiffusionConfig(defocus_aperture=aperture, **quality)
    half = tpd.defocus_half_widths(torch.from_numpy(depth), *shape, tcfg)
    max_half = tcfg.defocus_kernel_size(*shape) // 2
    assert int(half.max()) == max(tpd.defocus_candidates(max_half, tcfg))
    assert int(half[:64, :64].max()) == 0
    got = tpd.box_blur_tiles_plain(torch.from_numpy(rgb).permute(2, 0, 1), half, 0, 0, 0, *shape,
                                   tile).numpy()
    want = np.asarray(jfx.defocus_xla(jnp.asarray(rgb), jnp.asarray(depth), jcfg))
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert np.array_equal(got[:64, :64], rgb[:64, :64])


@pytest.mark.parametrize("oy,ox", [(0, 0), (37, 53), (74, 0), (37, 106)],
                         ids=["corner", "interior-odd-origin", "lower-edge", "right-edge"])
@pytest.mark.parametrize("tile", [16, 64])
def test_tile_twin_on_blocks_equals_block_sat(oy, ox, tile):
    """The tile twin on an extended block with an origin (odd in the
    interior case) equals ``defocus_block_sat`` and that crop of the whole
    image's ``defocus_xla``: sums in the block's ring, the count clipped
    against the whole image. Exact."""
    h, w, hb, wb = 111, 159, 37, 53
    rgb, depth = _case((h, w), 22)
    cfg, jcfg = DiffusionConfig(defocus_aperture=0.1), JConfig(defocus_aperture=0.1)
    ew = tpd.block_ring(h, w, cfg)
    half = tpd.defocus_half_widths(torch.from_numpy(depth), h, w, cfg)
    assert int(half.max()) == ew - 1
    chw = torch.nn.functional.pad(torch.from_numpy(rgb).permute(2, 0, 1), (ew, ew, ew, ew))
    chw_e = chw[:, oy:oy + hb + 2 * ew, ox:ox + wb + 2 * ew].contiguous()
    half_b = half[oy:oy + hb, ox:ox + wb].contiguous()
    got = tpd.box_blur_tiles_plain(chw_e, half_b, ew, oy, ox, h, w, tile)
    assert torch.equal(got, tpd.defocus_block_sat(chw_e, half_b, oy, ox, h, w, cfg))
    whole = np.asarray(jfx.defocus_xla(jnp.asarray(rgb), jnp.asarray(depth), jcfg))
    assert np.array_equal(got.numpy(), whole[oy:oy + hb, ox:ox + wb])
