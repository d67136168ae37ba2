"""The port's CUDA kernels against their plain versions on the card, at
shapes the 1080p run does not reach: single rows, levels smaller than one
tile, ragged tiles, every ring width k, stacks of planes in one K1 or K4
launch, K2 on every cluster-held level shape from a base > 0 at every
number of sweeps per exchange and thread layout it runs there, K4 under
each of its CTA shapes and both checkerboard parities, chunks that start
past iteration 0, K3 on both of its routes at apertures up to past the
tile route's limit, K5 on levels of every shape its CTA covers, K6 at every level rule
and the 4K routes and SAT sums, pipelines and live sessions on a second
card, and K1, K2 and K4 on the ring-masked windows of the incremental
re-solve, and the early exit's probe kernel at the main paths' shapes,
after the exit, replayed from a graph and inside a captured windowed
update. Whole paths on the card too: frames at 1080p and 4K, sharded steps,
incremental and V-cycle frames, the facade, live sessions and the server,
each against the same path on the plain versions (``_plain_routes``) or
against the single-device solve, with the launches the routes give
(``FRAME_1080P``, ``FRAME_4K``). Every comparison is exact, but the
V-cycle's, a cascade's and a live session against the CPU's, where the card
and the CPU round differently (RMSE <= 1e-3), a sharded fast or V-cycle step
against one device's (RMSE <= 1e-3), a windowed re-solve against a full one
(RMSE <= 3e-2), and the probe's rms residual, whose squares the kernel sums
in float64 (``PROBE_RTOL``).

Needs a CUDA device and nvcc; skips without them. This file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import collections
import math
import pathlib
import re

import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu_torch import ops
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core.annotation import seed_depth
from realtimedepthdiffusion_tpu_torch.core.solver import abc_schedule, rb_omegas
from realtimedepthdiffusion_tpu_torch.core.weights import edge_weights
from realtimedepthdiffusion_tpu_torch.ops import (build, defocus, dispatch, fused_sweep, probe,
                                                  rb_sweep, sweep)

pytestmark = pytest.mark.cuda

# What flags.py resolves --profile fast to, and the Jacobi-Chebyshev early exit.
FAST = {"solver": "red_black", "early_exit": True, "tolerance": 1e-3, "residual_metric": "rms"}
JC_EXIT = {"early_exit": True, "tolerance": 1e-3}
# A default frame's launches by the routes: K2 on each level a cluster holds
# (1080p L4-L2, 4K L5-L3), ceil(iters / 8) K1 on each level below, K6 in
# place of K1 on 4K L0, and K3 once.
FRAME_1080P = {"jc_sweep_resident": 3, "jc_sweep_tiles": 24, "defocus_box": 1}
FRAME_4K = dict(FRAME_1080P, jc_sweep_fused=4)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU form")
    return torch.device("cuda", 0)


def _counts():
    """The launches since the counts were last set to zero, by kernel."""
    return {k: n for k, n in ops.launch_counts().items() if n}


def _rmse01(a, b):
    """Depth RMSE on [0, 1]."""
    a, b = (np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t, np.float64) for t in (a, b))
    return float(np.sqrt(np.mean(((a - b) / 255.0) ** 2)))


def _level(dev, h, w, iters, seed, level=1):
    r = np.random.default_rng(seed)
    gray = torch.from_numpy(r.integers(0, 256, (h, w), dtype=np.uint8)).to(dev)
    mask = torch.from_numpy(r.random((h, w)) < 0.05).to(dev)
    value = torch.from_numpy(r.integers(0, 255, (h, w), dtype=np.uint8)).to(dev)
    depth = torch.from_numpy((r.random((h, w)) * 255).astype(np.float32)).to(dev)
    depth = seed_depth(depth, mask, value)
    wts = edge_weights(gray, depth, level, 2)
    return depth, mask, wts, abc_schedule(iters, DiffusionConfig())


@pytest.mark.parametrize("h,w", [(1, 70), (5, 3), (33, 65), (70, 130), (135, 240)])
@pytest.mark.parametrize("k", [1, 3, 8, 32])
@pytest.mark.parametrize("iters", [1, 7, 20])
def test_tiles_kernel_equals_plain(dev, h, w, k, iters):
    depth, mask, wts, abc = _level(dev, h, w, iters, seed=h * w + k)
    before = sweep.jc_sweep_tiles.launches
    abc_dev = torch.from_numpy(abc).to(dev)
    got = sweep._solve_tiles(depth.clone(), wts.wr.contiguous(), wts.wd.contiguous(),
                             wts.inv_count, mask.to(torch.uint8), abc_dev, k)
    want = sweep.solve_level_plain(depth, mask, wts, abc)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert sweep.jc_sweep_tiles.launches - before == -(-iters // k)


# The level shapes K2 runs: 1080p L4/L3/L2 (also 4K L5/L4/L3) and the
# windowed re-solve's 192 and 256 windows.
K2_SHAPES = [(67, 120), (135, 240), (270, 480), (192, 192), (256, 256)]


def _k2_plans(h, w, cluster):
    """Every (sweeps per exchange, rows per thread) K2 runs an (h, w) level
    with on ``cluster`` CTAs."""
    rows = -(-h // cluster)
    return [(s, r) for s in range(1, sweep.RESIDENT_MAX_S + 1)
            for r in sweep.resident_layouts(rows, w, s)]


@pytest.mark.parametrize("h,w", [(1, 1), (5, 7), (67, 120), (30, 300)] + K2_SHAPES[1:])
@pytest.mark.parametrize("iters", [1, 10, 37])
@pytest.mark.parametrize("level", [0, 2])
def test_resident_kernel_equals_plain(dev, h, w, iters, level):
    """K2 at the rule's sweeps per exchange (``resident_plan``: up to 8
    here, fewer where ``iters`` is below it, the last block short where it
    does not divide ``iters``)."""
    depth, mask, wts, abc = _level(dev, h, w, iters, seed=h + w + iters, level=level)
    assert sweep.resident_cluster(h, w, sweep.resident_max_cluster(dev))
    before = sweep.jc_sweep_resident.launches
    got = sweep.solve_level_cuda(depth, mask, wts, abc)
    want = sweep.solve_level_plain(depth, mask, wts, abc)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert sweep.jc_sweep_resident.launches == before + 1


@pytest.mark.parametrize("h,w", [(1, 1), (67, 120), (135, 240), (270, 480), (133, 251),
                                 (270, 512), (192, 192), (256, 256)])
@pytest.mark.parametrize("split", [(1,), (3, 4), (10, 27), (25, 25), (4,) * 12, (5,) * 12])
@pytest.mark.parametrize("cluster", [None, 16])
@pytest.mark.parametrize("plans", ["rule", "every"])
def test_cluster_resident_kernel_from_base_equals_plain(dev, h, w, split, cluster, plans):
    """K2 on its cluster (the route's, or 16 CTAs) in one launch per entry
    of ``split``, each from the last one's base carrying (u, prev), as an
    early exit runs it: at the rule's sweeps per exchange, or at every one
    K2 runs on the level (each layout, launches of fewer sweeps than s,
    blocks that do not divide a launch). The launches of exactly 4 or 5
    sweeps are the rule's s at 1080p L3 and L4 (one block, no exchange):
    their bands go back in place, into the rows the neighbouring CTAs load
    as ghost rows."""
    depth, mask, wts, abc = _level(dev, h, w, sum(split), seed=h + w + split[0])
    planes = (wts.wr.contiguous(), wts.wd.contiguous(), wts.inv_count.contiguous(),
              mask.to(torch.uint8))
    route = sweep.resident_cluster(h, w, sweep.resident_max_cluster(dev))
    assert route is not None
    c = cluster or route
    abc_dev = torch.from_numpy(abc).to(dev)
    state, run, _ = sweep.chunks_plain(depth, mask, wts, abc)
    want = run(state, 0, sum(split))
    for plan in [None] if plans == "rule" else _k2_plans(h, w, c):
        u, p = depth.clone(), torch.zeros_like(depth)
        before = sweep.jc_sweep_resident.launches
        for i, n in enumerate(split):
            sweep.jc_sweep_resident(u, p, *planes, abc_dev, sum(split[:i]), n, c, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(u, want[0]) and torch.equal(p, want[1]), plan
        assert sweep.jc_sweep_resident.launches == before + len(split)


@pytest.mark.parametrize("h,w,cluster", [
    (h, w, c) for h, w in K2_SHAPES + [(1, 1), (5, 7), (30, 300), (133, 251), (270, 512)]
    for c in (1, 2, 4, 8, 16) if -(-h // c) <= sweep.RESIDENT_ROWS])
def test_resident_layouts_match_the_launchers_check(dev, h, w, cluster):
    """The host's rule of which K2 plans hold a band (``resident_layouts``)
    and the C launcher's own check (``jc_resident_check``) accept the same
    (s, rows per thread), so neither can drift from the other."""
    rows = -(-h // cluster)
    lib = build.load_library()
    for s in range(0, sweep.RESIDENT_MAX_S + 2):
        host = sweep.resident_layouts(rows, w, s)
        for r in (1, 2, 3, 4, 6, 8, sweep.RESIDENT_ROWS):
            assert (lib.jc_resident_check(h, w, cluster, s, r) == 0) == (r in host), (s, r)


@pytest.mark.parametrize("nb", [1, 3, 16])
@pytest.mark.parametrize("h,w", [(37, 53), (76, 136)])
@pytest.mark.parametrize("k", [1, 8, 32])
def test_stacked_tiles_kernel_equals_blocks_plain(dev, nb, h, w, k):
    """K1 over an (nb, h, w) stack in one launch equals each plane's plain
    sweeps alone."""
    planes = [_halo_block(dev, h, w, seed=h + k + i) for i in range(nb)]
    stack = [torch.stack(t).contiguous() for t in zip(*planes)]
    abc = abc_schedule(k + 3, DiffusionConfig())[3:]
    before = sweep.jc_sweep_tiles.launches
    got = sweep.halo_block_sweeps(*stack, torch.from_numpy(abc).to(dev))
    torch.cuda.synchronize()
    assert sweep.jc_sweep_tiles.launches == before + 1
    for i, blk in enumerate(planes):
        want = sweep.halo_block_sweeps_plain(*blk, abc)
        assert torch.equal(got[0][i], want[0]) and torch.equal(got[1][i], want[1])


def test_cluster_query_and_refusals(dev):
    """The card runs some K2 cluster; the wrapper refuses a cluster the
    card does not run and a level its bands cannot hold."""
    c = sweep.resident_max_cluster(dev)
    assert c in sweep.CLUSTER_SIZES
    f = torch.zeros((540, 960), device=dev)
    m = torch.zeros((540, 960), dtype=torch.uint8, device=dev)
    abc = torch.zeros((4, 3), device=dev)
    with pytest.raises(ValueError, match="does not fit"):
        sweep.jc_sweep_resident(f, f, f, f, f, m, abc, 0, 4, c)
    with pytest.raises(ValueError, match="does not run"):
        sweep.jc_sweep_resident(f, f, f, f, f, m, abc, 0, 4, 32)
    g = torch.zeros((67, 120), device=dev)
    g8 = torch.zeros((67, 120), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="holds no band"):  # s past the band's 5 rows
        sweep.jc_sweep_resident(g, g, g, g, g, g8, abc, 0, 4, 16, plan=(6, 4))
    with pytest.raises(ValueError, match="holds no band"):  # no such layout
        sweep.jc_sweep_resident(g, g, g, g, g, g8, abc, 0, 4, 16, plan=(1, 8))
    with pytest.raises(ValueError, match="ring"):
        sweep.jc_sweep_tiles(f, f, f, f, f, f, f, m, abc, 0, 4, k=4, tile=(8, 1, 8))
    with pytest.raises(ValueError, match="nb, h, w"):
        sweep.jc_sweep_tiles(*[f[None, None]] * 7, m[None, None], abc, 0, 4)


def _aperture(h, w, max_half):
    """The ``defocus_aperture`` whose kernel size on (h, w) is 2 * max_half."""
    return (2 * max_half + 0.5) / float(np.hypot(h, w))


def _defocus_case(dev, h, w, seed):
    """Noise for colour; for depth, noise over blocks of 48 pixels, so that
    tiles differ in their largest half-width and some are sharp."""
    r = np.random.default_rng(seed)
    rgb = torch.from_numpy(r.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(dev)
    coarse = np.kron(r.random((h // 48 + 1, w // 48 + 1)) * 1.4 - 0.4, np.ones((48, 48)))
    depth = (coarse[:h, :w] * r.random((h, w)) * 300).astype(np.float32)
    return rgb, torch.from_numpy(depth).to(dev)


@pytest.mark.parametrize("h,w", [(7, 9), (96, 160), (257, 130), (540, 960)])
@pytest.mark.parametrize("aperture", [0.025, 0.3])
@pytest.mark.parametrize("quality", ["exact", "approx"])
def test_defocus_kernel_equals_plain(dev, h, w, aperture, quality):
    r = np.random.default_rng(h * w)
    rgb = torch.from_numpy(r.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(dev)
    depth = torch.from_numpy((r.random((h, w)) * 300 - 20).astype(np.float32)).to(dev)
    cfg = DiffusionConfig(defocus_aperture=aperture, pallas_defocus_quality=quality)
    got = defocus.defocus_box(rgb, depth, cfg)
    want = defocus.defocus_sat(rgb, depth, cfg)
    torch.cuda.synchronize()
    assert got.dtype == torch.uint8 and torch.equal(got, want)


@pytest.mark.parametrize("h,w", [(67, 120), (181, 243), (1080, 1920)])
@pytest.mark.parametrize("route", [("tile", 64), ("tile", 96), ("table", None)],
                         ids=["tile64", "tile96", "table"])
@pytest.mark.parametrize("quality", ["exact", "approx"])
@pytest.mark.parametrize("max_half", [3, 27, 55, 72])
def test_defocus_routes_equal_plain(dev, h, w, route, quality, max_half):
    """K3 on each route and tile side, on ragged tiles and on a level
    smaller than one tile, at apertures up to the largest a 96-tile holds;
    the route ``defocus_route`` picks gives the same."""
    cfg = DiffusionConfig(defocus_aperture=_aperture(h, w, max_half),
                          pallas_defocus_quality=quality)
    assert cfg.defocus_kernel_size(h, w) // 2 == max_half
    rgb, depth = _defocus_case(dev, h, w, h + max_half)
    before = defocus.defocus_box.launches
    got = defocus.defocus_box(rgb, depth, cfg, route=route)
    want = defocus.defocus_sat(rgb, depth, cfg)
    torch.cuda.synchronize()
    assert defocus.defocus_box.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(defocus.defocus_box(rgb, depth, cfg), want)


@pytest.mark.parametrize("max_half", [72, 73, 88, 89, 120])
def test_defocus_past_the_tile_limit_equals_plain(dev, max_half):
    """The last aperture the tile route serves, the first it leaves to the
    table, the last a forced 64-tile still holds, and apertures past that,
    which refuse the tile."""
    h, w = 300, 520
    cfg = DiffusionConfig(defocus_aperture=_aperture(h, w, max_half))
    assert cfg.defocus_kernel_size(h, w) // 2 == max_half
    rgb, depth = _defocus_case(dev, h, w, max_half)
    want = defocus.defocus_sat(rgb, depth, cfg)
    assert torch.equal(defocus.defocus_box(rgb, depth, cfg, route=("table", None)), want)
    assert torch.equal(defocus.defocus_box(rgb, depth, cfg), want)
    assert defocus.defocus_route(max_half) == (("tile", 96) if max_half == 72
                                               else ("table", None))
    if max_half <= 88:
        assert torch.equal(defocus.defocus_box(rgb, depth, cfg, route=("tile", 64)), want)
    else:
        with pytest.raises(ValueError, match="does not serve"):
            defocus.defocus_box(rgb, depth, cfg, route=("tile", 64))


def _rb_planes(wts, mask):
    return (wts.wr.contiguous(), wts.wd.contiguous(), wts.inv_count.contiguous(),
            mask.to(torch.uint8))


# Every CTA shape of K4 (rb_sweep.cu): the patches 4x2, 8x1 and 8x2, and a
# small tile of many CTAs per level. Parity 1 puts every tile's origin on a
# black cell, as a block of a sharded image with an odd origin has it.
RB_TILES = [(32, 16, 4, 2), (64, 8, 8, 1), (64, 8, 8, 2), (48, 10, 8, 2), (12, 6, 4, 2)]


@pytest.mark.parametrize("h,w", [(1, 70), (5, 3), (33, 65), (70, 130), (135, 240)])
@pytest.mark.parametrize("k", [1, 3, 8, 15])
@pytest.mark.parametrize("iters", [1, 7, 20])
@pytest.mark.parametrize("parity", [0, 1])
def test_rb_tiles_kernel_equals_plain(dev, h, w, k, iters, parity):
    """K4 on its route's shape at k, and on every other shape that carries
    k, against the plain iterations with the same checkerboard."""
    depth, mask, wts, _ = _level(dev, h, w, iters, seed=h * w + k)
    om = rb_omegas(iters, DiffusionConfig())
    planes = _rb_planes(wts, mask)
    om_dev = torch.from_numpy(om).to(dev)
    want = rb_sweep.halo_block_rb_sweeps_plain(depth, *planes, parity, om)
    tiles = [None] + [t for t in RB_TILES if min(rb_sweep.rb_tile_extent(t)) > 4 * k]
    for tile in tiles:
        before = rb_sweep.rb_sweep_tiles.launches
        us = [depth.clone(), torch.empty_like(depth)]
        for blk, b in enumerate(range(0, iters, k)):
            rb_sweep.rb_sweep_tiles(us[blk % 2], us[1 - blk % 2], *planes, om_dev, b,
                                    min(k, iters - b), k, tile, parity)
        torch.cuda.synchronize()
        assert torch.equal(us[-(-iters // k) % 2], want), tile
        assert rb_sweep.rb_sweep_tiles.launches - before == -(-iters // k)
    if parity == 0:
        assert torch.equal(rb_sweep._tiles_chunk(depth.clone(), *planes, om_dev, 0, iters, k),
                           rb_sweep.solve_level_rb_plain(depth, mask, wts, om))


@pytest.mark.parametrize("nb", [1, 3, 16])
@pytest.mark.parametrize("h,w", [(37, 53), (76, 136)])
@pytest.mark.parametrize("k", [1, 8])
def test_stacked_rb_tiles_kernel_equals_blocks_plain(dev, nb, h, w, k):
    """K4 over an (nb, h, w) stack with mixed parities in one launch equals
    the plain stack and each block's plain iterations alone."""
    blocks = [_halo_block(dev, h, w, seed=h + k + i) for i in range(nb)]
    stack = [torch.stack(t).contiguous() for t in zip(*blocks)]
    del stack[1]  # prev: red-black carries none
    parity = [(i * 5 // 3) & 1 for i in range(nb)]
    om = rb_omegas(k + 3, DiffusionConfig())[3:]
    before = rb_sweep.rb_sweep_tiles.launches
    got = rb_sweep.halo_block_rb_sweeps(*stack, parity, torch.from_numpy(om).to(dev))
    torch.cuda.synchronize()
    assert rb_sweep.rb_sweep_tiles.launches == before + 1
    assert got.data_ptr() != stack[0].data_ptr()
    assert torch.equal(got, rb_sweep.halo_block_rb_sweeps_plain(*stack, parity, om))
    for i, (u, _, bh, bv, inv, m) in enumerate(blocks):
        assert torch.equal(got[i], rb_sweep.halo_block_rb_sweeps_plain(u, bh, bv, inv, m,
                                                                        parity[i], om))


def test_rb_tiles_stack_beyond_one_launch(dev):
    """70 planes are two launches (64 parities fit one word), each right."""
    blocks = [_halo_block(dev, 9, 11, seed=i) for i in range(70)]
    stack = [torch.stack(t).contiguous() for t in zip(*blocks)]
    del stack[1]
    parity = [i % 3 == 0 for i in range(70)]
    om = rb_omegas(4, DiffusionConfig())
    before = rb_sweep.rb_sweep_tiles.launches
    got = rb_sweep.halo_block_rb_sweeps(*stack, parity, torch.from_numpy(om).to(dev))
    torch.cuda.synchronize()
    assert rb_sweep.rb_sweep_tiles.launches == before + 2
    assert torch.equal(got, rb_sweep.halo_block_rb_sweeps_plain(*stack, parity, om))


@pytest.mark.parametrize("h,w", [(1, 1), (5, 7), (67, 120)])
@pytest.mark.parametrize("split", [(1, 0), (3, 4), (10, 27)])
def test_rb_resident_kernel_equals_plain(dev, h, w, split):
    """K5 in two launches, the second from base > 0, as an early exit runs it."""
    first, rest = split
    iters = first + rest
    depth, mask, wts, _ = _level(dev, h, w, iters, seed=h + w + iters, level=0)
    assert rb_sweep.rb_resident_fits(h, w)
    om = rb_omegas(iters, DiffusionConfig())
    before = rb_sweep.rb_sweep_resident.launches
    u, run, _ = rb_sweep.chunks_cuda(depth, mask, wts, om)
    u = run(u, 0, first)
    if rest:
        u = run(u, first, rest)
    want = rb_sweep.solve_level_rb_plain(depth, mask, wts, om)
    torch.cuda.synchronize()
    assert torch.equal(u, want)
    assert rb_sweep.rb_sweep_resident.launches == before + 1 + (rest > 0)


@pytest.mark.parametrize("h,w", [(67, 120), (68, 120), (3, 120), (67, 1), (2, 2000),
                                 (4096, 2)])
@pytest.mark.parametrize("split", [(1, 0), (25, 0), (1000, 0), (7, 18)])
def test_rb_resident_shapes_equal_plain(dev, h, w, split):
    """K5 on the levels a 1080p and a 4K cascade give it, on levels lower
    or narrower than one patch and on a single row or column of patches,
    for 1, 25 and 1000 iterations and in a split run."""
    first, rest = split
    iters = first + rest
    depth, mask, wts, _ = _level(dev, h, w, 1, seed=h + w + iters, level=0)
    om = rb_omegas(iters, DiffusionConfig())
    om_dev = torch.from_numpy(om).to(dev)
    u = depth.clone()
    rb_sweep.rb_sweep_resident(u, *_rb_planes(wts, mask), om_dev, 0, first)
    if rest:
        rb_sweep.rb_sweep_resident(u, *_rb_planes(wts, mask), om_dev, first, rest)
    # A thousand plain iterations take seconds: K4 is held to them
    # elsewhere and stands in for them here.
    want = (rb_sweep.solve_level_rb_plain(depth, mask, wts, om) if iters < 1000 else
            rb_sweep._tiles_chunk(depth.clone(), *_rb_planes(wts, mask), om_dev, 0, iters, 8))
    torch.cuda.synchronize()
    assert torch.equal(u, want)
    assert torch.equal(u[mask], depth[mask])


@pytest.mark.parametrize("h,w", [(40, 56), (135, 240)])
@pytest.mark.parametrize("solver", ["red_black", "jacobi", "jacobi_chebyshev"])
def test_early_exit_on_card_equals_plain(dev, h, w, solver):
    """A level under the early exit: the same probes and the same bits on
    the kernels as on the plain versions, both on the card."""
    from realtimedepthdiffusion_tpu_torch.core import solver as tsolver

    depth, mask, wts, _ = _level(dev, h, w, 1, seed=h + 3)
    gray = torch.from_numpy(np.random.default_rng(h).integers(0, 256, (h, w),
                                                              dtype=np.uint8)).to(dev)
    cfg = DiffusionConfig(solver=solver, early_exit=True, tolerance=2e-3,
                          residual_check_every=5)
    log = []
    got = tsolver.solve_level(depth, mask, gray, 1, 2, 60, cfg, log)
    w2 = edge_weights(gray, depth, 1, 2, cfg)
    table = tsolver._SCHEDULES[solver](60, cfg)
    state, run, u_of = (rb_sweep if solver == "red_black" else sweep).chunks_plain(
        depth, mask, w2, table)
    want = u_of(tsolver._chunked_early_exit(state, run, u_of, mask, w2, 60, cfg, log))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    tsolver.read_exit_log(log)  # the card's counts, read once after the solves
    assert log[0]["probes"] == log[1]["probes"] and log[0]["iters"] == log[1]["iters"]


def test_wrappers_reject_bad_arguments(dev):
    f = torch.zeros((8, 9), device=dev)
    m = torch.zeros((8, 9), dtype=torch.uint8, device=dev)
    abc = torch.zeros((4, 3), device=dev)
    with pytest.raises(ValueError, match="float32"):
        sweep.jc_sweep_tiles(f.double(), f, f, f, f, f, f, m, abc, 0, 4)
    with pytest.raises(ValueError, match="shape"):
        sweep.jc_sweep_resident(f, f[:, :8].contiguous(), f, f, f, m, abc, 0, 4, 1)
    with pytest.raises(ValueError, match="do not fit"):
        sweep.jc_sweep_tiles(f, f, f, f, f, f, f, m, abc, 2, 4)
    with pytest.raises(ValueError, match="rgb"):
        defocus.defocus_box(m, f)
    with pytest.raises(ValueError, match="does not serve"):
        defocus.defocus_box(torch.zeros((8, 9, 3), dtype=torch.uint8, device=dev), f,
                            route=("tile", 48))
    om = torch.zeros((4, 2), device=dev)
    with pytest.raises(ValueError, match="do not fit"):
        rb_sweep.rb_sweep_tiles(f, f, f, f, f, m, om, 3, 2)
    with pytest.raises(ValueError, match="om"):
        rb_sweep.rb_sweep_resident(f, f, f, f, m, abc, 0, 1)
    with pytest.raises(ValueError, match="k must be"):
        rb_sweep.rb_sweep_tiles(f, f, f, f, f, m, om, 0, 2, k=20)
    with pytest.raises(ValueError, match="ring"):
        rb_sweep.rb_sweep_tiles(f, f, f, f, f, m, om, 0, 2, k=8, tile=(64, 8, 4, 1))
    with pytest.raises(ValueError, match="parity"):
        rb_sweep.rb_sweep_tiles(f, f, f, f, f, m, om, 0, 2, parity=[0, 1])
    with pytest.raises(ValueError, match="does not fit one CTA"):
        rb_sweep.rb_sweep_resident(torch.zeros((200, 300), device=dev), *[
            torch.zeros((200, 300), device=dev)] * 3, torch.zeros((200, 300),
            dtype=torch.uint8, device=dev), om, 0, 1)
    ops.reset_launch_counts()
    assert ops.launch_counts() == {"jc_sweep_tiles": 0, "jc_sweep_resident": 0,
                                   "defocus_box": 0, "rb_sweep_tiles": 0,
                                   "rb_sweep_resident": 0, "jc_sweep_fused": 0,
                                   "defocus_block": 0, "residual_probe": 0}


def _fused_case(dev, h, w, seed):
    """A level with non-integral depth, so the u8 truncation of d8 matters."""
    r = np.random.default_rng(seed)
    gray = torch.from_numpy(r.integers(0, 256, (h, w), dtype=np.uint8)).to(dev)
    mask = torch.from_numpy(r.random((h, w)) < 0.05).to(dev)
    value = torch.from_numpy(r.integers(0, 255, (h, w), dtype=np.uint8)).to(dev)
    field = np.kron(r.random((h // 4 + 1, w // 4 + 1)) * 255, np.ones((4, 4)))[:h, :w]
    depth = torch.from_numpy((field + r.random((h, w)) * 0.9).astype(np.float32)).to(dev)
    return seed_depth(depth, mask, value), mask, gray


@pytest.mark.parametrize("h,w", [(37, 53), (100, 203), (257, 515), (33, 65), (70, 130), (90, 20)])
@pytest.mark.parametrize("k", [1, 8, 16, 20])
@pytest.mark.parametrize("level,max_level", [(0, 3), (1, 3), (3, 3)])
def test_fused_kernel_equals_plain(dev, h, w, k, level, max_level):
    depth, mask, gray = _fused_case(dev, h, w, seed=h + w + k + level)
    abc = abc_schedule(17, DiffusionConfig())
    before = fused_sweep.jc_sweep_fused.launches
    got = fused_sweep.solve_level_fused_cuda(depth, mask, gray, abc, level, max_level, k=k)
    want = fused_sweep.solve_level_fused_plain(depth, mask, gray, abc, level, max_level)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert fused_sweep.jc_sweep_fused.launches - before == -(-17 // k)
    # The derived weights are edge_weights': K6 equals K1 on the same level.
    wts = edge_weights(gray, depth, level, max_level)
    k1 = sweep._solve_tiles(depth.clone(), wts.wr.contiguous(), wts.wd.contiguous(),
                            wts.inv_count, mask.to(torch.uint8), torch.from_numpy(abc).to(dev), k)
    torch.cuda.synchronize()
    assert torch.equal(got, k1)


@pytest.mark.parametrize("split", [(5, 12), (12, 13), (7, 1)])
def test_fused_chunks_from_base_equal_plain(dev, split):
    """K6 in two chunks, the second from base > 0, as the early exit runs it."""
    first, rest = split
    depth, mask, gray = _fused_case(dev, 70, 130, seed=first)
    abc = abc_schedule(first + rest, DiffusionConfig())
    state, run, u_of = fused_sweep.fused_chunks_cuda(depth, mask, gray, abc, 1, 3)
    pstate, prun, _ = fused_sweep.fused_chunks_plain(depth, mask, gray, abc, 1, 3)
    state, pstate = run(state, 0, first), prun(pstate, 0, first)
    state, pstate = run(state, first, rest), prun(pstate, first, rest)
    torch.cuda.synchronize()
    assert torch.equal(state[0], pstate[0]) and torch.equal(state[1], pstate[1])


def test_4k_route_launches_fused_kernel(dev):
    """A 2160x3840 level outgrows the card's L2 and runs on K6."""
    from realtimedepthdiffusion_tpu_torch.core import solver as tsolver

    depth, mask, gray = _fused_case(dev, 2160, 3840, seed=4)
    assert dispatch.fused_level(depth, "jacobi_chebyshev")
    assert not dispatch.fused_level(depth, "red_black")
    ops.reset_launch_counts()
    got = tsolver.solve_level(depth, mask, gray, 0, 5, 3, DiffusionConfig())
    torch.cuda.synchronize()
    assert ops.launch_counts()["jc_sweep_fused"] == 1
    assert ops.launch_counts()["jc_sweep_tiles"] == 0
    want = fused_sweep.solve_level_fused_plain(depth, mask, gray, abc_schedule(3), 0, 5)
    assert torch.equal(got, want)


@pytest.mark.parametrize("fill", [None, 255])
def test_defocus_dci_4k_equals_plain(dev, fill):
    """At 2160x4096 the SAT's largest entry passes 2^31 - 1."""
    r = np.random.default_rng(7)
    h, w = 2160, 4096
    rgb = r.integers(0, 256, (h, w, 3), dtype=np.uint8) if fill is None else \
        np.full((h, w, 3), fill, np.uint8)
    rgb = torch.from_numpy(rgb).to(dev)
    depth = torch.from_numpy((r.random((h, w)) * 300 - 20).astype(np.float32)).to(dev)
    got = defocus.defocus_box(rgb, depth)
    want = defocus.defocus_sat(rgb, depth)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if fill is not None:
        assert bool((got == fill).all())


def test_fused_wrapper_rejects_bad_arguments(dev):
    f = torch.zeros((8, 9), device=dev)
    m = torch.zeros((8, 9), dtype=torch.uint8, device=dev)
    abc = torch.zeros((4, 3), device=dev)
    etab = torch.zeros(256, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        fused_sweep.jc_sweep_fused(f.cpu(), f, f, f, m, m, m, abc, etab, 0, 4, 0, True)
    with pytest.raises(ValueError, match="CUDA"):
        fused_sweep.jc_sweep_fused(f, f, f, f, m.cpu(), m, m, abc, etab, 0, 4, 0, True)
    with pytest.raises(ValueError, match="uint8"):
        fused_sweep.jc_sweep_fused(f, f, f, f, f, m, m, abc, etab, 0, 4, 0, True)
    with pytest.raises(ValueError, match="float32"):
        fused_sweep.jc_sweep_fused(f, f, f, f, m, m, m, abc, etab.double(), 0, 4, 0, True)
    with pytest.raises(ValueError, match="d8: expected shape"):
        fused_sweep.jc_sweep_fused(f, f, f, f, m, m, m[:, :8].contiguous(), abc, etab, 0, 4,
                                   0, True)
    with pytest.raises(ValueError, match="do not fit"):
        fused_sweep.jc_sweep_fused(f, f, f, f, m, m, m, abc, etab, 2, 4, 0, True)
    with pytest.raises(ValueError, match="ring"):
        fused_sweep.jc_sweep_fused(f, f, f, f, m, m, m, abc, etab, 0, 1, 0, True, k=40)


# -- the sharded step's block routes (K1, K4 with parity, K3 with an origin) --


def _halo_block(dev, h, w, seed):
    depth, mask, wts, _ = _level(dev, h, w, 1, seed=seed)
    prev = torch.from_numpy(np.random.default_rng(seed).random((h, w)).astype(np.float32) * 255)
    return depth, prev.to(dev), wts.wr.contiguous(), wts.wd.contiguous(), wts.inv_count, mask


@pytest.mark.parametrize("h,w", [(37, 53), (100, 203)])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_halo_block_sweeps_kernel_equals_plain(dev, h, w, k):
    """One K1 launch over the whole block, zeros past it, as the plain version."""
    u, p, bh, bv, inv, m = _halo_block(dev, h, w, seed=h + k)
    abc = abc_schedule(k + 5, DiffusionConfig())[5:]
    before = sweep.jc_sweep_tiles.launches
    got = sweep.halo_block_sweeps(u, p, bh, bv, inv, m, torch.from_numpy(abc).to(dev))
    want = sweep.halo_block_sweeps_plain(u, p, bh, bv, inv, m, abc)
    torch.cuda.synchronize()
    assert sweep.jc_sweep_tiles.launches == before + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("h,w", [(37, 53), (100, 203)])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("parity", [0, 1])
def test_halo_block_rb_kernel_equals_plain(dev, h, w, k, parity):
    u, _, bh, bv, inv, m = _halo_block(dev, h, w, seed=h + k + parity)
    om = rb_omegas(k + 5, DiffusionConfig())[5:]
    before = rb_sweep.rb_sweep_tiles.launches
    got = rb_sweep.halo_block_rb_sweeps(u, bh, bv, inv, m, parity, torch.from_numpy(om).to(dev))
    want = rb_sweep.halo_block_rb_sweeps_plain(u, bh, bv, inv, m, parity, om)
    torch.cuda.synchronize()
    assert rb_sweep.rb_sweep_tiles.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("hb,wb", [(37, 53), (100, 203)])
@pytest.mark.parametrize("aperture", [0.025, 0.1])
@pytest.mark.parametrize("at", [(0, 0), (1, 1), (2, 0)])
def test_defocus_block_kernel_equals_plain(dev, hb, wb, aperture, at):
    """K3 on a block at an odd origin inside a 3hb x 2wb image, or on its
    border, with any ring content, against the plain version."""
    r = np.random.default_rng(hb + int(aperture * 1000) + at[0])
    full_h, full_w = 3 * hb, 2 * wb
    oy, ox = at[0] * hb, at[1] * wb
    cfg = DiffusionConfig(defocus_aperture=aperture)
    ew = defocus.block_ring(full_h, full_w, cfg)
    chw_e = torch.from_numpy(r.integers(0, 256, (3, hb + 2 * ew, wb + 2 * ew), dtype=np.uint8))
    half = torch.from_numpy(r.integers(0, ew, (hb, wb), dtype=np.uint8))
    before = defocus.defocus_block.launches
    got = defocus.defocus_block(chw_e.to(dev), half.to(dev), oy, ox, full_h, full_w, cfg)
    want = defocus.defocus_block_sat(chw_e, half, oy, ox, full_h, full_w, cfg)
    torch.cuda.synchronize()
    assert defocus.defocus_block.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("route", [("tile", 64), ("tile", 96), ("table", None)],
                         ids=["tile64", "tile96", "table"])
@pytest.mark.parametrize("aperture", [0.05, 0.22])
@pytest.mark.parametrize("at", [(0, 0), (1, 0), (1, 1), (2, 1)],
                         ids=["corner", "edge", "interior", "far-corner"])
def test_defocus_block_routes_equal_plain(dev, route, aperture, at):
    """K3 on a 135x203 block (ragged tiles) of a 405x406 image on each
    route: a corner, an edge and an interior block, rings of 15 and 64."""
    hb, wb = 135, 203
    full_h, full_w = 3 * hb, 2 * wb
    oy, ox = at[0] * hb, at[1] * wb
    r = np.random.default_rng(int(aperture * 100) + at[0] + 3 * at[1])
    cfg = DiffusionConfig(defocus_aperture=aperture)
    ew = defocus.block_ring(full_h, full_w, cfg)
    chw_e = torch.from_numpy(r.integers(0, 256, (3, hb + 2 * ew, wb + 2 * ew), dtype=np.uint8))
    coarse = np.kron(r.random((hb // 32 + 1, wb // 32 + 1)) * 1.3 - 0.3, np.ones((32, 32)))
    half = np.clip(coarse[:hb, :wb] * r.random((hb, wb)) * ew, 0, ew - 1).astype(np.uint8)
    half = torch.from_numpy(half)
    got = defocus.defocus_block(chw_e.to(dev), half.to(dev), oy, ox, full_h, full_w, cfg, route)
    want = defocus.defocus_block_sat(chw_e, half, oy, ox, full_h, full_w, cfg)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("h,w", [(37, 53), (100, 203)])
def test_defocus_whole_image_unchanged(dev, h, w):
    """Single-image K3 equals its plain version and the block route run on
    the whole image as one block behind a zero ring."""
    r = np.random.default_rng(h)
    rgb = torch.from_numpy(r.integers(0, 256, (h, w, 3), dtype=np.uint8)).to(dev)
    depth = torch.from_numpy((r.random((h, w)) * 300 - 20).astype(np.float32)).to(dev)
    cfg = DiffusionConfig(defocus_aperture=0.1)
    got = defocus.defocus_box(rgb, depth, cfg)
    ew = defocus.block_ring(h, w, cfg)
    chw_e = torch.nn.functional.pad(rgb.permute(2, 0, 1), (ew, ew, ew, ew)).contiguous()
    block = defocus.defocus_block(chw_e, defocus.defocus_half_widths(depth, h, w, cfg), 0, 0, h, w,
                                  cfg)
    torch.cuda.synchronize()
    assert torch.equal(got, defocus.defocus_sat(rgb, depth, cfg)) and torch.equal(block, got)


def test_sharded_step_on_card_equals_plain_and_single_device(dev):
    """A 64x96 step on 8 slots (of one card, or spread over several): the
    kernels' run equals the plain blocks' run, which launches no kernel,
    and the single-device pipeline per image."""
    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.parallel import mesh, sharded

    cfg = DiffusionConfig(max_iterations=40)
    m = mesh.make_mesh(8, device="cuda")
    fn, make_args = sharded.batched_step(m, 64, 96, cfg, fx.EFFECT_DEFOCUS)
    args = make_args(2)
    ops.reset_launch_counts()
    depth, _, out = fn(*args)
    counts = ops.launch_counts()
    # One K1 launch per exchange (5) and card, over all its slots' blocks.
    cards = len(set(m.devices.values()))
    assert counts["jc_sweep_tiles"] == 5 * cards and counts["defocus_block"] == 8
    plain_fn, _ = sharded.batched_step(m, 64, 96, cfg, fx.EFFECT_DEFOCUS, plain=True)
    ops.reset_launch_counts()
    p_depth, _, p_out = plain_fn(*args)
    torch.cuda.synchronize()
    assert not any(ops.launch_counts().values())
    assert torch.equal(depth, p_depth) and torch.equal(out, p_out)
    rgb, mask, value, state = args
    pipe = DepthPipeline(64, 96, cfg, device="cuda")
    for i in range(2):
        rgb_d, gpyr = pipe.prepare_image(rgb[i])
        d, _, o = pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, mask[i], value[i],
                                        tuple(s[i] for s in state))
        assert torch.equal(depth[i], d) and torch.equal(out[i], o)


@pytest.mark.parametrize("solver_name", ["jacobi_chebyshev", "red_black"])
def test_sharded_step_across_cards_equals_one_card(dev, solver_name):
    """Slots round-robin over every visible card, the halo strips crossing
    as device-to-device copies: the step equals the same mesh on one card.
    Skips with fewer than two cards."""
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.parallel import mesh, sharded

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    cfg = DiffusionConfig(max_iterations=100, solver=solver_name,
                          early_exit=solver_name == "red_black", tolerance=1e-3,
                          residual_check_every=8)
    many = mesh.make_mesh(8, device="cuda")
    assert len(set(many.devices.values())) == min(8, torch.cuda.device_count())
    runs = []
    for m in (many, mesh.make_mesh(8, device="cuda:0")):
        fn, make_args = sharded.batched_step(m, 270, 480, cfg, fx.EFFECT_DEFOCUS)
        log = []
        depth, state, out = fn(*make_args(2), log)
        torch.cuda.synchronize()
        runs.append((depth, state, out, log))
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][2], runs[1][2])
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))
    assert [e["iters"] for e in runs[0][3]] == [e["iters"] for e in runs[1][3]]


@pytest.mark.parametrize("name,rows,cols,cfg_kw", [
    ("default", 1080, 1920, {}),
    # What flags.py resolves --profile fast to.
    ("fast", 1080, 1920, {"solver": "red_black", "early_exit": True, "tolerance": 1e-3,
                          "residual_metric": "rms"}),
    ("4K", 2160, 3840, {}),
])
def test_pipeline_on_second_card_equals_first(dev, name, rows, cols, cfg_kw):
    """A frame of ``DepthPipeline(..., device="cuda:1")`` (K1, K2, K3 and K6,
    or K4, K5 and K3) equals the same frame on ``cuda:0``: every kernel
    launches on its tensors' card, not on the current one. Skips with
    fewer than two cards."""
    import warnings

    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.core import effects as fx

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    r = np.random.default_rng(rows)
    rgb = r.integers(0, 256, (rows, cols, 3), dtype=np.uint8)
    mask = np.zeros((rows, cols), bool)
    value = np.zeros((rows, cols), np.uint8)
    mask[rows // 4:rows // 4 + 40, cols // 4:cols // 4 + 60] = True
    value[rows // 4:rows // 4 + 40, cols // 4:cols // 4 + 60] = 254
    mask[3 * rows // 4:3 * rows // 4 + 40, 3 * cols // 4:3 * cols // 4 + 60] = True
    cfg = DiffusionConfig(**cfg_kw)
    frames = []
    for device in ("cuda:0", "cuda:1"):
        pipe = DepthPipeline(rows, cols, cfg, device=device)
        rgb_d, gpyr = pipe.prepare_image(rgb)
        ops.reset_launch_counts()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # 4K: 'auto' defocus -> approx
            depth, _, out = pipe.solve_and_effect(
                fx.EFFECT_DEFOCUS, gpyr, rgb_d, torch.from_numpy(mask).to(device),
                torch.from_numpy(value).to(device), pipe.initial_state())
        torch.cuda.synchronize(device)
        assert depth.device == torch.device(device)
        frames.append((depth.cpu(), out.cpu(), ops.launch_counts()))
    assert frames[0][2] == frames[1][2] and sum(frames[0][2].values()) > 0
    assert torch.equal(frames[0][0], frames[1][0]) and torch.equal(frames[0][1], frames[1][1])
    # A wrapper refuses arguments that lie on two cards.
    f0, f1 = torch.zeros((8, 9), device="cuda:0"), torch.zeros((8, 9), device="cuda:1")
    m0 = torch.zeros((8, 9), dtype=torch.uint8, device="cuda:0")
    with pytest.raises(ValueError, match="cuda:1.*cuda:0"):
        sweep.jc_sweep_tiles(f0, f0, f0, f0, f1, f0, f0, m0, torch.zeros((4, 3), device="cuda:0"),
                             0, 4)
    with pytest.raises(ValueError, match="cuda:1.*cuda:0"):
        defocus.defocus_box(torch.zeros((8, 9, 3), dtype=torch.uint8, device="cuda:0"), f1)


def _scene(dev, h, w, seed):
    """A level's gray, annotation and a smooth depth with seeded scribbles."""
    r = np.random.default_rng(seed)
    gray = torch.from_numpy(r.integers(0, 256, (h, w), dtype=np.uint8)).to(dev)
    mask = torch.from_numpy(r.random((h, w)) < 0.03).to(dev)
    value = torch.from_numpy(r.integers(0, 255, (h, w), dtype=np.uint8)).to(dev)
    field = np.kron(r.random((h // 16 + 1, w // 16 + 1)) * 255.0, np.ones((16, 16)))[:h, :w]
    depth = seed_depth(torch.from_numpy(field.astype(np.float32)).to(dev), mask, value)
    return gray, mask, depth


@pytest.mark.parametrize("win,kernel", [(384, "jc_sweep_tiles"), (256, "jc_sweep_resident"),
                                        (192, "jc_sweep_resident")])
@pytest.mark.parametrize("origin", [(0, 0), (97, 211), (-40, 300), (500, -7), (316, 516),
                                    (900, 1200)])
@pytest.mark.parametrize("level", [0, 1])
def test_window_kernels_equal_plain(dev, win, kernel, origin, level):
    """K1 and K2 on the windows of the incremental re-solve: a crop (a view)
    of a 700x900 level at a clamped origin, the frozen ring in the mask, the
    weights of the crop. 384 takes K1, 256 and 192 fit a cluster of K2."""
    from realtimedepthdiffusion_tpu_torch.core import incremental

    h, w = 700, 900
    gray, mask, depth = _scene(dev, h, w, seed=win + level)
    oy, ox = incremental.clamp_origin(*origin, win, win, h, w)
    assert 0 <= oy <= h - win and 0 <= ox <= w - win
    rows, cols = slice(oy, oy + win), slice(ox, ox + win)
    u_w = depth[rows, cols]
    assert not u_w.is_contiguous()
    m_w = mask[rows, cols] | incremental._ring(win, dev)
    wts = edge_weights(gray[rows, cols], u_w, level, 2)
    abc = abc_schedule(21, DiffusionConfig())
    ops.reset_launch_counts()
    got = sweep.solve_level_cuda(u_w, m_w, wts, abc)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {kernel: 3 if kernel == "jc_sweep_tiles" else 1}
    want = sweep.solve_level_plain(u_w, m_w, wts, abc)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got[m_w], u_w[m_w])  # ring and scribbles frozen
    assert not torch.equal(got, u_w.contiguous())


def _plain_solve_level(depth, mask, gray, level, max_level, iters, cfg, exit_log=None):
    """``core/solver.py:solve_level`` on the plain versions, on any device."""
    wts = edge_weights(gray, depth, level, max_level, cfg)
    if cfg.solver == "red_black":
        return rb_sweep.solve_level_rb_plain(depth, mask, wts, rb_omegas(iters, cfg))
    return sweep.solve_level_plain(depth, mask, wts, abc_schedule(iters, cfg))


@pytest.mark.parametrize("solver,kernels", [
    ("jacobi_chebyshev", {"jc_sweep_resident": 3, "jc_sweep_tiles": 5}),
    # No level or window here fits K5's one CTA (87x112 needs 1232 threads).
    ("red_black", {"rb_sweep_tiles": 32 + 16 + 3 + 5}),
])
@pytest.mark.parametrize("center", [(300, 400), (3, 3), (699, 899), (-20, 450)])
def test_incremental_frame_equals_plain(dev, monkeypatch, solver, kernels, center):
    """An incremental frame of a 700x900 image (4 levels; a 384-pixel window
    at level 0, 192 at level 1) on the kernels equals the same frame on the
    plain versions, level for level, at clamped and unclamped windows: the
    kernels' call runs eagerly and captures the program, the plain one runs
    the pipeline's eager function with ``solve_level`` patched."""
    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.core import incremental

    h, w = 700, 900
    cfg = DiffusionConfig(solver=solver, max_iterations=250, incremental_iterations=40)
    pipe = DepthPipeline(h, w, cfg, device=dev)
    r = np.random.default_rng(5)
    rgb = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
    _, gpyr = pipe.prepare_image(rgb)
    assert [tuple(g.shape) for g in gpyr] == [(700, 900), (350, 450), (175, 225), (87, 112)]
    mask = torch.from_numpy(r.random((h, w)) < 0.002).to(dev)
    value = torch.from_numpy(r.integers(0, 255, (h, w), dtype=np.uint8)).to(dev)
    _, state = pipe.solve(gpyr, mask, value, pipe.initial_state())
    cy, cx = min(max(center[0], 0), h - 6), min(max(center[1], 0), w - 6)
    mask, value = mask.clone(), value.clone()
    mask[cy:cy + 6, cx:cx + 6], value[cy:cy + 6, cx:cx + 6] = True, 77
    kept = tuple(s.clone() for s in state)
    ops.reset_launch_counts()
    depth, new_state = pipe.solve_incremental(gpyr, mask, value, state, center)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == kernels
    monkeypatch.setattr(incremental, "solve_level", _plain_solve_level)
    ops.reset_launch_counts()
    # The pipeline's eager function: its call above captured the windowed
    # re-solve's graph, which a second call would replay.
    p_depth, p_state = pipe._inc_eager(gpyr, mask, value, state, center)
    torch.cuda.synchronize()
    assert not any(ops.launch_counts().values())
    assert all(torch.equal(a, b) for a, b in zip(new_state, p_state))
    assert new_state[0] is depth and torch.equal(depth, p_depth)
    assert torch.equal(depth[mask], value[mask].to(torch.float32))
    assert all(torch.equal(a, b) for a, b in zip(state, kept))


def test_device_center_is_refused_on_the_card(dev):
    """A centre on a device other than the CPU and the pipeline's card is
    refused; one on the card is the solve's own input, to the bits of the
    same centre given as host integers."""
    from realtimedepthdiffusion_tpu_torch import DepthPipeline

    pipe = DepthPipeline(64, 64, DiffusionConfig(max_iterations=8), device=dev)
    z = torch.zeros((64, 64), device=dev)
    args = ((z.to(torch.uint8),), z.bool(), z.to(torch.uint8), (z,))
    with pytest.raises(ValueError, match="host integers"):
        pipe.solve_incremental(*args, torch.empty(2, dtype=torch.int32, device="meta"))
    got, _ = pipe.solve_incremental(*args, torch.tensor([3, 3], dtype=torch.int32, device=dev))
    want, _ = pipe.solve_incremental(*args, (3, 3))
    assert torch.equal(got, want)


@pytest.mark.parametrize("h,w", [(96, 128), (270, 480), (181, 243)])
def test_vcycle_on_the_card_matches_cpu(dev, h, w):
    """The V-cycle (a warm cascade on the kernels, then the polish in torch
    ops) on the card within RMSE 1e-3 of the CPU's; scribbles exact, depth
    in [0, 255]."""
    from realtimedepthdiffusion_tpu_torch import DepthPipeline

    r = np.random.default_rng(h)
    coarse = r.integers(0, 256, (h // 12 + 1, w // 12 + 1, 3))
    rgb = np.clip(np.kron(coarse, np.ones((12, 12, 1), np.int64))[:h, :w]
                  + r.integers(-8, 9, (h, w, 3)), 0, 255).astype(np.uint8)
    mask = np.zeros((h, w), bool)
    value = np.zeros((h, w), np.uint8)
    for i, d in enumerate((0, 64, 128, 192, 254)):
        y, x = (i + 1) * h // 6, (i + 1) * w // 6
        mask[y - 3:y + 3, x - 4:x + 4], value[y - 3:y + 3, x - 4:x + 4] = True, d
    cfg = DiffusionConfig(multigrid="vcycle")
    depths = []
    for device in (dev, "cpu"):
        pipe = DepthPipeline(h, w, cfg, device=device)
        _, gpyr = pipe.prepare_image(rgb)
        ops.reset_launch_counts()
        d, _ = pipe.solve(gpyr, torch.from_numpy(mask).to(device),
                          torch.from_numpy(value).to(device), pipe.initial_state())
        launched = sum(ops.launch_counts().values())
        assert (launched > 0) == (device != "cpu")
        depths.append(d.cpu().numpy())
    assert _rmse01(*depths) <= 1e-3
    assert np.array_equal(depths[0][mask], value[mask].astype(np.float32))
    assert depths[0].min() >= 0.0 and depths[0].max() <= 255.0


def _live_updates(device, rows, cols, cfg):
    """A live session on ``device``: a first solve with the defocus, a drag
    inside one rect, two distant rects, an annotation load. Returns each
    update's (u8 map, depth, effect) on the host and its launches."""
    from realtimedepthdiffusion_tpu_torch.live.session import DepthSession

    r = np.random.default_rng(rows + cols)
    coarse = r.integers(0, 256, (rows // 16 + 1, cols // 16 + 1, 3))
    rgb = np.clip(np.kron(coarse, np.ones((16, 16, 1), np.int64))[:rows, :cols]
                  + r.integers(-4, 5, (rows, cols, 3)), 0, 255).astype(np.uint8)
    s = DepthSession(rgb, cfg, device=device)
    s.mask_np[rows // 3:rows // 3 + 12, cols // 3:cols // 3 + 20] = 1
    s.value_np[rows // 3:rows // 3 + 12, cols // 3:cols // 3 + 20] = 192
    s.mark_all_dirty()
    s.set_effect_key("b")
    # The windowed re-solve's program, captured by the gate's kick before
    # the updates: the update that found the gate closed would re-solve in
    # full and then run the kick, one eager windowed re-solve and its
    # effect on stand-in tensors, so its count would not be its own.
    s.pipe.incremental_ready(s.effect)
    strokes = [[], [(cols // 2 + i, rows // 2) for i in range(0, 12, 2)],
               [(cols // 5, rows // 4), (4 * cols // 5, 3 * rows // 4)], None]
    out = []
    for paints in strokes:
        if paints is None:
            s.mark_all_dirty()  # the planes as an annotation load leaves them
        else:
            s.set_color_key(len(out) + 1)
            for x, y in paints:
                s.paint(x, y)
        ops.reset_launch_counts()
        u8 = s.solve()
        out.append((u8, s.depth0.cpu(), s.artistic.cpu(),
                    {k: v for k, v in ops.launch_counts().items() if v}))
    return out


def test_session_on_second_card_equals_first(dev):
    """A live session on ``cuda:1`` equals the same session on ``cuda:0``,
    update for update. Skips with fewer than two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    cfg = DiffusionConfig(incremental_iterations=120, incremental_window=128)
    runs = [_live_updates(d, 270, 480, cfg) for d in ("cuda:0", "cuda:1")]
    for (u0, d0, a0, c0), (u1, d1, a1, c1) in zip(*runs):
        assert np.array_equal(u0, u1) and torch.equal(d0, d1) and torch.equal(a0, a1)
        assert c0 == c1 and c0.get("defocus_box") == 1


def test_session_on_the_card_matches_cpu(dev):
    """A live session on the card within RMSE 1e-3 of the same session on
    the CPU, update for update; a windowed update launches the window's
    kernels (two rects: twice a single rect's). Jacobi-Chebyshev only: level
    0's weights switch on truncated depth, so exp's last bits on another
    device can flip a weight, and red-black SOR at omega near 2 amplifies
    the flip inside a window past the bar (4.4e-3 here).
    ``test_session_updates_on_the_card_equal_plain`` holds red-black
    sessions to the plain versions on the card."""
    cfg = DiffusionConfig(incremental_iterations=120, incremental_window=128)
    card, cpu = (_live_updates(d, 270, 480, cfg) for d in (dev, "cpu"))
    for i, ((u, d, a, counts), (_, d_cpu, _, cpu_counts)) in enumerate(zip(card, cpu)):
        assert u.dtype == np.uint8 and u.shape == (270, 480) and a.dtype == torch.uint8
        assert _rmse01(d, d_cpu) <= 1e-3
        assert not cpu_counts and counts.get("defocus_box") == 1
    one, two = card[1][3], card[2][3]
    assert {k: 2 * v for k, v in one.items() if k != "defocus_box"} == {
        k: v for k, v in two.items() if k != "defocus_box"}


def test_solve_pairs_async_equals_sequential_and_pipeline(dev, tmp_path):
    """``serve.solve_pairs`` on the card: the asynchronous run (pinned
    uploads, each pair read back into pinned buffers behind a CUDA event,
    two pairs in flight) writes the same PNGs as the strictly sequential run,
    and both hold ``DepthPipeline.solve_and_effect`` on the same inputs bit
    for bit: the u8 and u16 maps and the defocus."""
    from realtimedepthdiffusion_tpu_torch import io, serve
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.pipeline import DepthPipeline

    cfg = DiffusionConfig()
    r = np.random.default_rng(11)
    for sub in ("images", "annotations"):
        (tmp_path / sub).mkdir()
    for i, (h, w) in enumerate([(96, 128)] * 3 + [(72, 96)] * 2):
        io.imwrite(str(tmp_path / "images" / f"p{i}.png"),
                   r.integers(0, 256, (h, w, 3), dtype=np.uint8))
        mask = np.zeros((h, w), bool)
        value = np.zeros((h, w), np.uint8)
        for j, depth in enumerate((0, 128, 254)):
            y, x = (j + 1) * h // 4, (j + 1) * w // 4
            mask[y - 4:y + 4, x - 6:x + 6] = True
            value[y - 4:y + 4, x - 6:x + 6] = depth
        io.save_annotation(str(tmp_path / "annotations" / f"p{i}.png"), mask, value)
    pairs = serve.discover_pairs(str(tmp_path / "images"), str(tmp_path / "annotations"))
    runs = {"async": {"io_workers": 4, "prefetch": 2},
            "sequential": {"io_workers": 1, "prefetch": 0}}
    for name, kw in runs.items():
        written = serve.solve_pairs(pairs, str(tmp_path / name), cfg, fx.EFFECT_DEFOCUS,
                                    depth16=True, device=dev, **kw)
        assert all(written), name
    for img, ann in pairs:
        stem = serve._stem(img)
        rgb = io.imread_rgb(img)
        mask, value = io.load_annotation(ann, cfg)
        pipe = DepthPipeline(*rgb.shape[:2], cfg, device=dev)
        rgb_d, gpyr = pipe.prepare_image(rgb)
        depth, _, art = pipe.solve_and_effect(
            fx.EFFECT_DEFOCUS, gpyr, rgb_d, torch.from_numpy(mask).to(dev),
            torch.from_numpy(value).to(dev), pipe.initial_state())
        want = {"depth": pipe.depth_u8(depth).cpu().numpy(),
                "depth16": pipe.depth_u16(depth).cpu().numpy(), "effect": art.cpu().numpy()}
        for kind, arr in want.items():
            got = {name: open(tmp_path / name / f"{stem}_{kind}.png", "rb").read()
                   for name in runs}
            assert got["async"] == got["sequential"], (stem, kind)
            assert np.array_equal(io.png_decode(got["async"]), arr), (stem, kind)


def _photo(rows, cols, seed):
    """Smooth 16-pixel blocks with a little noise, and three scribbles."""
    r = np.random.default_rng(seed)
    coarse = r.integers(0, 256, (rows // 16 + 1, cols // 16 + 1, 3))
    rgb = np.clip(np.kron(coarse, np.ones((16, 16, 1), np.int64))[:rows, :cols]
                  + r.integers(-4, 5, (rows, cols, 3)), 0, 255).astype(np.uint8)
    mask = np.zeros((rows, cols), bool)
    value = np.zeros((rows, cols), np.uint8)
    for i, d in enumerate((0, 128, 254)):
        y, x = (i + 1) * rows // 4, (i + 1) * cols // 4
        mask[y:y + 40, x:x + 60], value[y:y + 40, x:x + 60] = True, d
    return rgb, mask, value


@pytest.mark.parametrize("name,rows,cols,cfg_kw", [
    ("1080p default", 1080, 1920, {}),
    ("4K approx", 2160, 3840, {"pallas_defocus_quality": "approx"}),
    ("4K exact", 2160, 3840, {"pallas_defocus_quality": "exact"}),
    ("V-cycle", 1080, 1920, {"multigrid": "vcycle"}),
    ("red-black fixed count", 1080, 1920, {"solver": "red_black"}),
])
def test_replayed_frame_equals_eager(dev, name, rows, cols, cfg_kw):
    """fast_start frames of ``solve_and_effect(EFFECT_DEFOCUS)``: the first
    two run eagerly and the second captures the CUDA graph (the V-cycle, which
    has no staged form, captures at its first); later frames replay it. Each
    frame equals the eager function on the same inputs bit for bit, launches
    what the eager frame launches (a replay adds its capture's tally), and
    no tensor an earlier frame returned changes under a later replay."""
    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.core import effects as fx

    pipe = DepthPipeline(rows, cols, DiffusionConfig(fast_start=True, **cfg_kw), device=dev)
    rgb, mask, value = _photo(rows, cols, rows + len(cfg_kw))
    rgb_d, gpyr = pipe.prepare_image(rgb)
    state = pipe.initial_state()
    held = None
    key = ("solve_fx", fx.EFFECT_DEFOCUS)
    for i in range(5):
        if i == 2:
            mask[rows // 2:rows // 2 + 30, 40:90], value[rows // 2:rows // 2 + 30, 40:90] = True, 96
        m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
        ops.reset_launch_counts()
        got = pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v, state)
        counts = {k: n for k, n in ops.launch_counts().items() if n}
        ops.reset_launch_counts()
        want = pipe._solve_fx_eager(fx.EFFECT_DEFOCUS, tuple(gpyr), rgb_d, m, v, state)
        assert counts == {k: n for k, n in ops.launch_counts().items() if n} and counts
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]), (name, i)
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1])), (name, i)
        assert (key in pipe._aot) == (i >= 1 or name == "V-cycle"), (name, i)
        if key in pipe._aot:
            assert pipe._aot[key].tally == counts
        if i == 2:
            held = (got, tuple(t.clone() for t in (got[0], *got[1], got[2])))
        state = got[1]
    frame, copies = held
    assert all(torch.equal(a, b) for a, b in zip((frame[0], *frame[1], frame[2]), copies))
    assert frame[0] is frame[1][0]  # one tensor, as the eager solve returns it


def test_replay_mismatch_runs_eagerly_and_fast_profile_captures_nothing(dev, monkeypatch):
    """A uint8 mask does not match the captured bool mask: the solve runs
    eagerly (no replay) with the same numbers. ``--profile fast`` (the
    residual early exit), which once stored no program, now captures at
    its second frame like any config: the replays fill the exit log from
    their own counts, and launch what the eager frames launch."""
    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.utils import program

    rows, cols = 540, 960
    rgb, mask, value = _photo(rows, cols, 3)
    pipe = DepthPipeline(rows, cols, DiffusionConfig(fast_start=False), device=dev)
    _, gpyr = pipe.prepare_image(rgb)
    m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
    d_b, _ = pipe.solve(gpyr, m, v, pipe.initial_state())
    assert ("solve",) in pipe._aot  # fast_start off: captured at the first call's end
    replays = []
    real = program.Program.__call__
    monkeypatch.setattr(program.Program, "__call__",
                        lambda self, *a: (replays.append(1), real(self, *a))[1])
    ops.reset_launch_counts()
    d_u8, _ = pipe.solve(gpyr, m.to(torch.uint8), v, pipe.initial_state())
    assert not replays and sum(ops.launch_counts().values()) > 0
    d_r, _ = pipe.solve(gpyr, m, v, pipe.initial_state())
    assert replays
    torch.cuda.synchronize()
    assert torch.equal(d_u8, d_b) and torch.equal(d_r, d_b)

    fast = DepthPipeline(rows, cols, DiffusionConfig(
        solver="red_black", early_exit=True, tolerance=1e-3, residual_metric="rms",
        fast_start=True), device=dev)
    rgb_d, gpyr = fast.prepare_image(rgb)
    state = fast.initial_state()
    counts = []
    for i in range(3):
        log = []
        ops.reset_launch_counts()
        _, state, _ = fast.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v, state, log)
        assert log and ops.launch_counts()["defocus_box"] == 1
        assert all(len(e["probes"]) >= 1 and "_device" not in e for e in log)
        assert (("solve_fx", fx.EFFECT_DEFOCUS) in fast._aot) == (i >= 1)
        counts.append(ops.launch_counts())
    assert counts[0] == counts[1] == counts[2]
    assert fast.wait_fused() and fast.capture(None, gpyr, m, v, state) >= 0.0


def _flag(dev, value):
    """The early exit's flag: None (no flag), or a 0-d int32 on the card."""
    return None if value is None else torch.full((), value, dtype=torch.int32, device=dev)


def _jc_plain(u, p, wts, mask, abc):
    for a, b, c in abc.tolist():
        u, p = sweep.sweep_plain(u, p, wts.wl, wts.wr, wts.wu, wts.wd, wts.inv_count, mask,
                                 a, b, c)
    return u, p


def _rb_plain(u, wts, mask, om):
    red = rb_sweep.red_black_parity(*u.shape, device=u.device)
    for om_r, om_b in om.tolist():
        u = rb_sweep.rb_iter_plain(u, wts.wl, wts.wr, wts.wu, wts.wd, wts.inv_count, mask, red,
                                   om_r, om_b)
    return u


@pytest.mark.parametrize("kernel", ["K1", "K2", "K4", "K5", "K6"])
@pytest.mark.parametrize("flag", [None, 0, 1])
def test_stop_flag(dev, kernel, flag):
    """Each sweep kernel under the early exit's flag: set, a launch leaves
    its output equal to its input (K1, K4 and K6 copy their input across,
    as the ping-pong of a captured chunk needs; K2 and K5 return); clear or
    null, it equals its plain version bit for bit. Every launch counts."""
    from realtimedepthdiffusion_tpu_torch.core.weights import depth_threshold, level_d8

    h, w = (67, 120) if kernel in ("K2", "K5") else (135, 240)
    depth, mask, wts, abc = _level(dev, h, w, 8, seed=h + len(kernel))
    cfg = DiffusionConfig()
    m8 = mask.to(torch.uint8)
    planes = (wts.wr.contiguous(), wts.wd.contiguous(), wts.inv_count.contiguous(), m8)
    prev = torch.from_numpy(np.random.default_rng(h).random((h, w), np.float32) * 255).to(dev)
    stop = _flag(dev, flag)
    nan = lambda: torch.full_like(depth, float("nan"))  # noqa: E731
    fn = {"K1": sweep.jc_sweep_tiles, "K2": sweep.jc_sweep_resident,
          "K4": rb_sweep.rb_sweep_tiles, "K5": rb_sweep.rb_sweep_resident,
          "K6": fused_sweep.jc_sweep_fused}[kernel]
    before = fn.launches
    if kernel in ("K1", "K2", "K6"):
        abc_dev = sweep.device_table(abc, dev)
        u_in, p_in = depth.clone(), prev.clone()
        if kernel == "K1":
            u_out, p_out = nan(), nan()
            fn(u_in, p_in, u_out, p_out, *planes, abc_dev, 0, 8, 8, stop=stop)
            want = _jc_plain(depth, prev, wts, mask, abc)
        elif kernel == "K2":
            u_out, p_out = u_in, p_in
            c = sweep.resident_max_cluster(dev)
            assert sweep.resident_plan(h, w, c, 8)[0] > 1  # ghost rows, a short last block
            fn(u_in, p_in, *planes, abc_dev, 0, 8, c, stop)
            want = _jc_plain(depth, prev, wts, mask, abc)
        else:
            gray = torch.from_numpy(np.random.default_rng(w).integers(
                0, 256, (h, w), dtype=np.uint8)).to(dev)
            u_out, p_out = nan(), nan()
            thr = depth_threshold(1, 2, cfg)
            fn(u_in, p_in, u_out, p_out, gray, m8, level_d8(depth), abc_dev,
               fused_sweep.weight_exp_table(cfg, dev), 0, 8, thr or 0, thr is not None, 8, stop)
            fwts = fused_sweep.derive_weights_plain(gray, level_d8(depth), 1, 2, cfg)
            want = _jc_plain(depth, prev, fwts, mask, abc)
        got = (u_out, p_out)
        held = (depth, prev)
    else:
        om = rb_omegas(8, cfg)
        om_dev = sweep.device_table(om, dev)
        u_in = depth.clone()
        if kernel == "K4":
            u_out = nan()
            fn(u_in, u_out, *planes, om_dev, 0, 8, 8, stop=stop)
        else:
            u_out = u_in
            fn(u_in, *planes, om_dev, 0, 8, stop)
        got, held, want = (u_out,), (depth,), (_rb_plain(depth, wts, mask, om),)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    expect = held if flag == 1 else want
    assert all(torch.equal(a, b) for a, b in zip(got, expect)), (kernel, flag)
    if flag == 1:
        assert not torch.equal(want[0], held[0])  # a clear flag would have moved it


@pytest.mark.filterwarnings("ignore:defocus quality 'auto'")  # 4K: 'auto' resolves to approx
@pytest.mark.parametrize("name,rows,cols,cfg_kw", [
    ("fast profile", 1080, 1920, FAST),
    ("jacobi_chebyshev early exit", 1080, 1920, JC_EXIT),
    ("jacobi_chebyshev early exit 4K", 2160, 3840, JC_EXIT),
])
def test_replayed_early_exit_frame_equals_eager(dev, name, rows, cols, cfg_kw):
    """fast_start frames of ``solve_and_effect(EFFECT_DEFOCUS)`` under the
    residual early exit at 1080p and at 4K (K6 on L0): the graph captured
    at the second frame replays the later ones, whose levels exit on the
    card. Each frame equals the eager function on the same inputs bit for
    bit, with the same iterations and probes per level, and launches what
    it launches (every chunk; those after a level's exit run as no-ops)."""
    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.core.solver import read_exit_log

    pipe = DepthPipeline(rows, cols, DiffusionConfig(fast_start=True, **cfg_kw), device=dev)
    rgb, mask, value = _photo(rows, cols, 21)
    rgb_d, gpyr = pipe.prepare_image(rgb)
    state = pipe.initial_state()
    exited = False
    for i in range(5):
        if i == 3:
            mask[500:530, 40:90], value[500:530, 40:90] = True, 96
        m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
        log, want_log = [], []
        ops.reset_launch_counts()
        got = pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v, state, log)
        counts = ops.launch_counts()
        ops.reset_launch_counts()
        want = pipe._solve_fx_eager(fx.EFFECT_DEFOCUS, tuple(gpyr), rgb_d, m, v, tuple(state),
                                    want_log)
        read_exit_log(want_log)
        assert counts == ops.launch_counts()
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]), (name, i)
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1])), (name, i)
        assert log == want_log and len(log) == len(gpyr), (name, i)
        assert (("solve_fx", fx.EFFECT_DEFOCUS) in pipe._aot) == (i >= 1)
        exited |= any(e["iters"] < pipe.cfg.level_iterations(len(gpyr), len(gpyr) - 1 - j)
                      for j, e in enumerate(log))
        state = got[1]
    assert exited  # some level left before its cap


@pytest.mark.parametrize("solver", ["jacobi_chebyshev", "red_black"])
def test_replayed_incremental_frame_equals_eager_at_every_centre(dev, solver):
    """The windowed re-solve's program, captured by ``incremental_ready``'s
    kick from stand-in tensors (centre (0, 0)), replayed at a centre inside,
    at both near corners, past the far corner and at an edge: each frame
    equals the eager function at its centre bit for bit and launches what
    it launches."""
    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.core import effects as fx

    rows, cols = 1080, 1920
    cfg = DiffusionConfig(fast_start=True, solver=solver, incremental_iterations=120)
    pipe = DepthPipeline(rows, cols, cfg, device=dev)
    pipe.background_compile = True
    rgb, mask, value = _photo(rows, cols, 22)
    rgb_d, gpyr = pipe.prepare_image(rgb)
    m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
    _, state = pipe.solve(gpyr, m, v, pipe.initial_state())
    assert not pipe.incremental_ready(fx.EFFECT_HAZE)  # the kick captures
    assert pipe.incremental_ready(fx.EFFECT_HAZE)
    prog = pipe._aot[("inc_fx", fx.EFFECT_HAZE)]
    for center in [(540, 960), (3, 3), (1075, 7), (5000, 5000), (300, 1919)]:
        mask[max(center[0] - 20, 0):center[0] + 20, max(center[1] - 20, 0):center[1] + 20] = True
        m = torch.from_numpy(mask).to(dev)
        ops.reset_launch_counts()
        got = pipe.solve_incremental_and_effect(fx.EFFECT_HAZE, gpyr, rgb_d, m, v, state, center)
        counts = ops.launch_counts()
        ops.reset_launch_counts()
        want = pipe._inc_fx_eager(fx.EFFECT_HAZE, tuple(gpyr), rgb_d, m, v, tuple(state), center)
        assert counts == ops.launch_counts() and counts == {
            k: prog.tally.get(k, 0) for k in counts}
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]), center
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1])), center
        state = got[1]


@pytest.mark.parametrize("route", ["K1", "K4"])
@pytest.mark.parametrize("flag", [None, 0, 1])
def test_halo_block_stack_stop_flag(dev, route, flag):
    """K1 and K4 over a stack of 4 extended blocks, as the sharded step
    launches them, under the early exit's flag: set, the launch leaves its
    input (a copy across); clear or null, it equals the plain version."""
    blocks = [_halo_block(dev, 37, 53, seed=40 + i) for i in range(4)]
    u, p, bh, bv, inv, m = (torch.stack(t).contiguous() for t in zip(*blocks))
    stop = _flag(dev, flag)
    if route == "K1":
        abc = abc_schedule(13, DiffusionConfig())[5:]
        got = sweep.halo_block_sweeps(u, p, bh, bv, inv, m, sweep.device_table(abc, dev), stop)
        want = sweep.halo_block_sweeps_plain(u, p, bh, bv, inv, m, abc)
        held = (u, p)
    else:
        om = rb_omegas(13, DiffusionConfig())[5:]
        par = [0, 1, 1, 0]
        got = (rb_sweep.halo_block_rb_sweeps(u, bh, bv, inv, m, par, sweep.device_table(om, dev),
                                             stop),)
        want = (rb_sweep.halo_block_rb_sweeps_plain(u, bh, bv, inv, m, par, om),)
        held = (u,)
    torch.cuda.synchronize()
    expect = held if flag == 1 else want
    assert all(torch.equal(a, b) for a, b in zip(got, expect)), (route, flag)
    assert not torch.equal(want[0], held[0])


def _step_counts():
    from realtimedepthdiffusion_tpu_torch.parallel import sharded

    return _counts(), dict(+sharded.block_calls)


def _reset_counts():
    from realtimedepthdiffusion_tpu_torch.parallel import sharded

    ops.reset_launch_counts()
    sharded.block_calls.clear()


@pytest.mark.parametrize("name,cfg_kw,effect", [
    ("jacobi_chebyshev defocus", {}, "defocus"),
    ("red-black early exit", {"solver": "red_black", "early_exit": True, "tolerance": 1e-3,
                              "residual_metric": "rms"}, "defocus"),
    ("V-cycle", {"multigrid": "vcycle"}, "haze"),
])
def test_replayed_sharded_step_equals_eager(dev, name, cfg_kw, effect):
    """``batched_step`` on 8 slots of one card at 270x480: the first call
    runs eagerly and captures the step; later calls replay it. Each equals
    the eager step on the same inputs bit for bit (depth, state, effect,
    exit log) and counts what it launches (kernels and ``block_calls``).
    A second signature (a batch of 4) runs eagerly, then captures its own."""
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.core.solver import read_exit_log
    from realtimedepthdiffusion_tpu_torch.parallel import mesh, sharded

    eff = {"defocus": fx.EFFECT_DEFOCUS, "haze": fx.EFFECT_HAZE}[effect]
    m = mesh.make_mesh(8, device=dev)
    fn, make_args = sharded.batched_step(m, 270, 480, DiffusionConfig(**cfg_kw), eff)
    for batch, calls in ((2, 3), (4, 2)):
        rgb, mask, value, state = make_args(batch)
        for i in range(calls):
            if i == 2:
                mask = mask.clone()
                mask[:, 100:120, 200:240], value[:, 100:120, 200:240] = True, 96
            log, want_log = [], []
            _reset_counts()
            got = fn(rgb, mask, value, state, log)
            counts = _step_counts()
            _reset_counts()
            want = fn.eager(rgb, mask, value, state, want_log)
            read_exit_log(want_log)
            torch.cuda.synchronize()
            assert counts == _step_counts() and counts[0], (name, batch, i)
            assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]), (name, batch, i)
            assert all(torch.equal(a, b) for a, b in zip(got[1], want[1])), (name, batch, i)
            assert log == want_log and bool(log) == ("early_exit" in cfg_kw), (name, batch, i)
            assert len(fn.programs) == 1 + (batch == 4), (name, batch, i)
            state = got[1]
    assert all(p.graph is not None for p in fn.programs.values())


def test_multichip_serve_replays_from_its_second_batch(dev, tmp_path, monkeypatch):
    """``serve.solve_pairs_multichip`` with a batch of 2 on 8 slots of one
    card over six 96x128 pairs: the bucket's step captures at its first
    batch and replays the second and third; every PNG equals the
    single-device frame's."""
    from realtimedepthdiffusion_tpu_torch import io, serve
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.parallel import mesh
    from realtimedepthdiffusion_tpu_torch.pipeline import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.utils import program

    cfg = DiffusionConfig()
    for sub in ("images", "annotations"):
        (tmp_path / sub).mkdir()
    for i in range(6):
        rgb, mask, value = _photo(96, 128, 30 + i)
        io.imwrite(str(tmp_path / "images" / f"p{i}.png"), rgb)
        io.save_annotation(str(tmp_path / "annotations" / f"p{i}.png"), mask, value)
    pairs = serve.discover_pairs(str(tmp_path / "images"), str(tmp_path / "annotations"))
    replays = []
    real = program.Program.__call__
    monkeypatch.setattr(program.Program, "__call__",
                        lambda self, *a: (replays.append(self.graph is not None),
                                          real(self, *a))[1])
    written = serve.solve_pairs_multichip(pairs, str(tmp_path / "out"), cfg, fx.EFFECT_DEFOCUS,
                                          batch=2, mesh=mesh.make_mesh(8, device=dev),
                                          depth16=True, device=dev)
    assert all(written) and replays == [True, True]
    pipe = DepthPipeline(96, 128, cfg, device=dev)
    for img, ann in pairs:
        stem = serve._stem(img)
        rgb_d, gpyr = pipe.prepare_image(io.imread_rgb(img))
        mask, value = io.load_annotation(ann, cfg)
        depth, _, art = pipe._solve_fx_eager(
            fx.EFFECT_DEFOCUS, tuple(gpyr), rgb_d, torch.from_numpy(mask).to(dev),
            torch.from_numpy(value).to(dev), pipe.initial_state())
        want = {"depth": pipe.depth_u8(depth).cpu().numpy(),
                "depth16": pipe.depth_u16(depth).cpu().numpy(), "effect": art.cpu().numpy()}
        for kind, arr in want.items():
            got = io.png_decode(open(tmp_path / "out" / f"{stem}_{kind}.png", "rb").read())
            assert np.array_equal(got, arr), (stem, kind)


# -- the early exit's probe (csrc/probe.cu) -------------------------------------------

# The kernel sums the squares in float64, torch in float32, in a tree whose
# every partial sum rounds to 2^-24: over the 2 MP of 1080p L0 torch's sum
# lies within about log2(n) * 2^-24 ~ 1.3e-6 of the exact one, and the
# square root halves that. So the rms residual agrees to 1e-5 relative; the
# max takes no sum and agrees exactly.
PROBE_RTOL = 1e-5
FAST_1080P = pathlib.Path(__file__).resolve().parents[1] / "benchmark/configs/fast_1080p.json"


def _probe_flags(dev, stop):
    return (torch.full((), stop, dtype=torch.int32, device=dev),
            torch.tensor([7, 2], dtype=torch.int32, device=dev),
            torch.full((3,), -1.0, device=dev))


def _probe_by(route, u, mask, wts, metric, tol, flags, c=1, n=25):
    """One probe of the level by ``route`` ("plain" or "kernel") on the
    card, into ``flags`` (stop, done, probes)."""
    make = probe.level_probe_plain if route == "plain" else probe.level_probe_cuda
    fn, name = make(mask, wts, metric, tol)
    assert name == route
    fn(u, c, n, *flags)
    torch.cuda.synchronize()
    return flags


def _same_probe(got, want, metric):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(got[2][[0, 2]], want[2][[0, 2]])
    if metric == "max":
        torch.testing.assert_close(got[2], want[2], rtol=0, atol=0, equal_nan=True)
    else:
        torch.testing.assert_close(got[2], want[2], rtol=PROBE_RTOL, atol=0, equal_nan=True)


@pytest.mark.parametrize("h,w", [(1080, 1920), (540, 960), (270, 480), (135, 240), (67, 120),
                                 (384, 384), (192, 192), (1, 1), (5, 3), (33, 65)])
@pytest.mark.parametrize("metric", ["rms", "max"])
@pytest.mark.parametrize("side", ["above", "below"])
def test_probe_kernel_equals_plain(dev, h, w, metric, side):
    """The probe kernel against its plain version at the main paths'
    shapes (1080p L0 to L4, the windowed re-solve's 384 and 192 windows)
    and at odd ones, with the threshold above the residual (the flag is
    set) and below it (clear): the same flag and counts, the residual
    within ``PROBE_RTOL`` (rms) or exact (max), the other slots left."""
    depth, mask, wts, _ = _level(dev, h, w, 1, seed=h * 7 + w)
    res = float(probe.residual_plain(depth, mask, wts, metric))
    tol = res * (1.5 if side == "above" else 0.5) + 1e-6
    want = _probe_by("plain", depth, mask, wts, metric, tol, _probe_flags(dev, 0))
    before = probe.residual_probe.launches
    got = _probe_by("kernel", depth, mask, wts, metric, tol, _probe_flags(dev, 0))
    assert probe.residual_probe.launches == before + 1
    _same_probe(got, want, metric)
    assert int(got[0]) == (side == "above") and got[1].tolist() == [32, 3]


@pytest.mark.parametrize("case", ["nan", "masked"])
@pytest.mark.parametrize("metric", ["rms", "max"])
def test_probe_kernel_nan_and_fully_masked(dev, case, metric):
    """A NaN in the free pixels stops on both versions, with a NaN
    residual; a fully scribbled level reads 0 (the count clamped to 1)."""
    depth, mask, wts, _ = _level(dev, 135, 240, 1, seed=5)
    if case == "nan":
        mask[60, 70], depth[60, 70] = False, float("nan")
    else:
        mask[:] = True
    want = _probe_by("plain", depth, mask, wts, metric, 1.0, _probe_flags(dev, 0))
    got = _probe_by("kernel", depth, mask, wts, metric, 1.0, _probe_flags(dev, 0))
    _same_probe(got, want, metric)
    assert int(got[0]) == 1 and got[1].tolist() == [32, 3]
    assert math.isnan(float(got[2][1])) if case == "nan" else float(got[2][1]) == 0.0


@pytest.mark.parametrize("metric", ["rms", "max"])
def test_probe_kernel_after_the_exit_writes_nothing(dev, metric):
    """With ``stop`` set a launch writes nothing, not even its residual's
    slot, and leaves the ticket at 0; it still counts as a launch."""
    depth, mask, wts, _ = _level(dev, 384, 384, 1, seed=9)
    planes = (wts.wl, wts.wr, wts.wu, wts.wd, wts.inv_count)
    partials, ticket = probe.probe_scratch(384, 384, dev)
    partials.fill_(-3.0)
    stop, done, probes = _probe_flags(dev, 1)
    before = probe.residual_probe.launches
    probe.residual_probe(depth, *planes, mask.to(torch.uint8), 25, 1, 0.0, metric, stop, done,
                         probes, partials, ticket)
    torch.cuda.synchronize()
    assert probe.residual_probe.launches == before + 1
    assert int(stop) == 1 and done.tolist() == [7, 2] and probes.tolist() == [-1.0] * 3
    assert ticket.tolist() == [0] and bool((partials == -3.0).all())


@pytest.mark.parametrize("metric", ["rms", "max"])
def test_probe_kernel_replayed_from_a_graph(dev, metric):
    """The probe captured once in a CUDA graph and replayed three times on
    different states: each replay equals the plain version on its state,
    the last block puts the ticket back to 0 every time."""
    depth, mask, wts, _ = _level(dev, 540, 960, 1, seed=11)
    planes = (wts.wl, wts.wr, wts.wu, wts.wd, wts.inv_count)
    m8 = mask.to(torch.uint8)
    scratch = probe.probe_scratch(540, 960, dev)
    u = depth.clone()
    stop, done, probes = _probe_flags(dev, 0)

    def launch():
        probe.residual_probe(u, *planes, m8, 25, 1, 1e-3, metric, stop, done, probes, *scratch)

    launch()  # the library is loaded and the launch checked outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        launch()
    r = np.random.default_rng(3)
    for i in range(3):
        u.copy_(torch.from_numpy((r.random((540, 960)) * 255).astype(np.float32)))
        for t, v in zip((stop, done, probes), _probe_flags(dev, 0)):
            t.copy_(v)
        graph.replay()
        torch.cuda.synchronize()
        want = _probe_by("plain", u, mask, wts, metric, 1e-3, _probe_flags(dev, 0))
        _same_probe((stop, done, probes), want, metric)
        assert scratch[1].tolist() == [0], i


def _fast_window_pipe(dev, rgb, mask, value, plain_probe, monkeypatch):
    """A ``fast_1080p`` pipeline (the benchmark's configuration) whose
    windowed re-solve is captured by ``incremental_ready``'s kick, with the
    probe's plain version where ``plain_probe``; its gray pyramid and the
    state of a full solve."""
    import json

    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.core import effects as fx

    cfg = DiffusionConfig(**json.loads(FAST_1080P.read_text())["diffusion"])
    with monkeypatch.context() as mp:
        if plain_probe:
            mp.setattr(dispatch, "_PROBE", (probe.level_probe_plain,) * 2)
        pipe = DepthPipeline(1080, 1920, cfg, device=dev)
        pipe.background_compile = True
        rgb_d, gpyr = pipe.prepare_image(rgb)
        m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
        _, state = pipe.solve(gpyr, m, v, pipe.initial_state())
        assert not pipe.incremental_ready(fx.EFFECT_DEFOCUS)  # the kick captures
    assert pipe.incremental_ready(fx.EFFECT_DEFOCUS)
    return pipe, rgb_d, gpyr, state


def test_windowed_update_probes_equal_the_plain_glue(dev, monkeypatch):
    """A ``fast_1080p`` windowed update replayed from its graph, whose
    probes are the kernel, against the same update run eagerly with the
    plain probe on the card: the same iterations per level (the same exit
    decisions), probes within ``PROBE_RTOL``, the same bits."""
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.core.solver import read_exit_log

    rgb, mask, value = _photo(1080, 1920, 23)
    pipe, rgb_d, gpyr, state = _fast_window_pipe(dev, rgb, mask, value, False, monkeypatch)
    exited = False
    for center in [(540, 960), (300, 500), (900, 1700)]:
        mask[center[0] - 10:center[0] + 10, center[1] - 10:center[1] + 10] = True
        value[center[0] - 10:center[0] + 10, center[1] - 10:center[1] + 10] = 90
        m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
        log, want_log = [], []
        got = pipe.solve_incremental_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v, state,
                                                center, log)
        with monkeypatch.context() as mp:
            mp.setattr(dispatch, "_PROBE", (probe.level_probe_plain,) * 2)
            want = pipe._inc_fx_eager(fx.EFFECT_DEFOCUS, tuple(gpyr), rgb_d, m, v, tuple(state),
                                      center, want_log)
        read_exit_log(want_log)
        torch.cuda.synchronize()
        assert [e["probe"] for e in log] == ["kernel"] * len(log) and log
        assert [e["probe"] for e in want_log] == ["plain"] * len(log)
        assert [e["iters"] for e in log] == [e["iters"] for e in want_log], center
        for e, f in zip(log, want_log):
            np.testing.assert_allclose(e["probes"], f["probes"], rtol=PROBE_RTOL)
        assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2]), center
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1])), center
        exited |= any(e["iters"] < e["cap"] for e in log)
        state = got[1]
    assert exited


def _kernels_on_device(fn):
    """Kernels (no copies or fills) the profiler sees on the card in ``fn``,
    counted by their bare names (no namespace, template or arguments)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    seen = collections.Counter()
    for e in prof.events():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.name.lower().startswith(("memcpy", "memset"))):
            bare = re.split(r"[<(]", e.name.replace("(anonymous namespace)::", ""))[0]
            seen[bare.split("::")[-1].removeprefix("void ").strip()] += 1
    return seen


def test_windowed_update_graph_sheds_the_probes_glue(dev, monkeypatch):
    """The captured ``fast_1080p`` windowed update runs about 34 kernels a
    chunk fewer with the probe kernel than with the plain probe captured
    in its place: one launch a chunk against the torch sequence's ~35."""
    from realtimedepthdiffusion_tpu_torch.core import effects as fx

    rgb, mask, value = _photo(1080, 1920, 24)
    mask[530:550, 950:970], value[530:550, 950:970] = True, 90
    counts, logs = {}, {}
    for plain in (True, False):
        pipe, rgb_d, gpyr, state = _fast_window_pipe(dev, rgb, mask, value, plain, monkeypatch)
        m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
        logs[plain] = []
        pipe.solve_incremental_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v, state,
                                          (540, 960), logs[plain])
        counts[plain] = sum(_kernels_on_device(lambda: pipe.solve_incremental_and_effect(
            fx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v, state, (540, 960))).values())
    chunks = sum(-(-e["cap"] // 25) for e in logs[False])
    assert [e["iters"] for e in logs[True]] == [e["iters"] for e in logs[False]]
    drop = (counts[True] - counts[False]) / chunks
    print(f"windowed update: {counts[True]} kernels with the plain probe, {counts[False]} with "
          f"the kernel, {chunks} chunks: {drop:.2f} fewer a chunk")
    assert 25 <= drop <= 40, (counts, chunks)


# -- whole paths on the card: frames, steps, sessions and the server ---------------------


def _plain_routes(mp):
    """Route every level solve, early-exit probe and defocus of the port on
    the card to its plain version, as the CPU routes them: the same glue on
    the card, and no kernel launched."""
    from realtimedepthdiffusion_tpu_torch.core import effects

    for name in ("_FIXED", "_CHUNKS"):
        mp.setattr(dispatch, name, {k: (p, p) for k, (p, _) in getattr(dispatch, name).items()})
    for name in ("_FUSED", "_FUSED_CHUNKS", "_PROBE"):
        plain = getattr(dispatch, name)[0]
        mp.setattr(dispatch, name, (plain, plain))
    mp.setattr(effects, "defocus_box", defocus.defocus_sat)


def _rb_exit_launches(log, every):
    """The launches of the red-black early exit's levels in ``log``: every
    chunk of each level's cap is issued (the exit is decided on the card),
    one K5 a chunk where the level fits one CTA, else one K4 per 8
    iterations, and one probe a chunk where the probe is the kernel."""
    want = collections.Counter()
    for e in log:
        chunks = [min(every, e["cap"] - b) for b in range(0, e["cap"], every)]
        want["residual_probe"] += len(chunks) * (e["probe"] == "kernel")
        if rb_sweep.rb_resident_fits(*e["shape"]):
            want["rb_sweep_resident"] += len(chunks)
        else:
            want["rb_sweep_tiles"] += sum(-(-n // rb_sweep.RB_TILE_ITERS) for n in chunks)
    return +want


def _settled_scene(pipe, dev, seed):
    """A photograph-like image under a dense annotation (the benchmark's
    generators), solved until a full solve moves the depth by less than
    RMSE 1e-3: only there is a windowed re-solve comparable to a full one
    (on blocky noise the full solve keeps moving for dozens of solves).
    Returns the image on the card, its pyramid, the planes and the state."""
    from benchmark import gen

    r = np.random.default_rng(seed)
    rgb_d, gpyr = pipe.prepare_image(gen.photo_like(r, pipe.rows, pipe.cols))
    mask, value = gen.dense_scribbles(r, pipe.rows, pipe.cols)
    m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
    state = pipe.initial_state()
    for _ in range(13):
        depth, new = pipe.solve(gpyr, m, v, state)
        moved, state = _rmse01(depth, state[0]), new
        if moved < 1e-3:
            return rgb_d, gpyr, mask, value, state
    raise AssertionError(f"the full solve still moves the depth by RMSE {moved}")


@pytest.mark.parametrize("name,rows,cols,cfg_kw,launches", [
    ("1080p default", 1080, 1920, {}, FRAME_1080P),
    ("1080p jacobi", 1080, 1920, {"solver": "jacobi"}, FRAME_1080P),
    ("1080p fast", 1080, 1920, FAST, None),
    ("1080p jacobi_chebyshev early exit", 1080, 1920, JC_EXIT, None),
    ("4K default", 2160, 3840, {}, FRAME_4K),
    ("4K jacobi_chebyshev early exit", 2160, 3840, JC_EXIT, None),
])
def test_frame_on_the_card_equals_plain(dev, monkeypatch, name, rows, cols, cfg_kw, launches):
    """An eager frame of ``solve_and_effect(EFFECT_DEFOCUS)`` on the kernels
    equals the same frame with every level solve, probe and defocus on its
    plain version on the card, bit for bit (depth, state, effect and the
    early exit's iterations per level), and launches what the routes give:
    ``FRAME_1080P`` and ``FRAME_4K``; under red-black's early exit every
    chunk of each level's cap (``_rb_exit_launches``) and K3; under
    Jacobi-Chebyshev's the Jacobi kernels of the shape, the probe and K3.
    Depth finite, scribbles pinned, red-black's in [0, 255]; at 4K the
    ``auto`` defocus resolves to approx, with its warning."""
    import warnings

    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.core.solver import read_exit_log

    cfg = DiffusionConfig(fast_start=True, **cfg_kw)
    pipe = DepthPipeline(rows, cols, cfg, device=dev)
    rgb, mask, value = _photo(rows, cols, 40)
    rgb_d, gpyr = pipe.prepare_image(rgb)
    m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
    state = pipe.initial_state()
    log, want_log = [], []
    ops.reset_launch_counts()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        depth, new_state, out = pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v,
                                                      state, log)
    counts = _counts()
    with monkeypatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        _plain_routes(mp)
        ops.reset_launch_counts()
        want = pipe._solve_fx_eager(fx.EFFECT_DEFOCUS, tuple(gpyr), rgb_d, m, v, state, want_log)
        read_exit_log(want_log)
        torch.cuda.synchronize()
        assert not any(ops.launch_counts().values())
    assert torch.equal(depth, want[0]) and torch.equal(out, want[2]), name
    assert all(torch.equal(a, b) for a, b in zip(new_state, want[1])), name
    assert [e["iters"] for e in log] == [e["iters"] for e in want_log], name
    assert bool(torch.isfinite(depth).all()) and torch.equal(depth[m], v[m].to(torch.float32))
    assert out.shape == (rows, cols, 3) and out.dtype == torch.uint8
    if launches is not None:
        assert counts == launches
    elif cfg.solver == "red_black":
        assert [tuple(e["shape"]) for e in log] == [tuple(g.shape) for g in gpyr[::-1]]
        assert counts == dict(_rb_exit_launches(log, cfg.residual_check_every), defocus_box=1)
        assert 0.0 <= float(depth.min()) and float(depth.max()) <= 255.0
    else:
        assert set(counts) == set(FRAME_4K if rows == 2160 else FRAME_1080P) | {"residual_probe"}
    approx = [w for w in caught if issubclass(w.category, RuntimeWarning)
              and "approx" in str(w.message)]
    assert bool(approx) == (rows == 2160), [str(w.message) for w in caught]


@pytest.mark.parametrize("h,w,cfg_kw", [(181, 243, {}), (181, 243, FAST), (96, 128, {})],
                         ids=["default", "fast", "default-96x128"])
def test_cascade_on_the_card_matches_cpu_and_the_oracle(dev, h, w, cfg_kw):
    """A cascade solve on the card within RMSE 1e-3 of the same solve on the
    CPU, which the CPU tests hold against the JAX package (``exp`` rounds
    the last bits differently on the two devices), scribbles exact; a
    fixed-count solve within RMSE 1e-3 of the NumPy oracle too."""
    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.oracle import numpy_ref

    rgb, mask, value = _photo(h, w, h + w)
    cfg = DiffusionConfig(**cfg_kw)
    depths = []
    for device in (dev, "cpu"):
        pipe = DepthPipeline(h, w, cfg, device=device)
        _, gpyr = pipe.prepare_image(rgb)
        d, _ = pipe.solve(gpyr, torch.from_numpy(mask).to(device),
                          torch.from_numpy(value).to(device), pipe.initial_state())
        depths.append(d.cpu().numpy())
    assert _rmse01(*depths) <= 1e-3
    assert np.array_equal(depths[0][mask], value[mask].astype(np.float32))
    if not cfg.early_exit:
        want, _ = numpy_ref.solve_pyramid(numpy_ref.rgb_to_gray(rgb), mask, value, None, cfg)
        assert _rmse01(depths[0], want) <= 1e-3


@pytest.mark.parametrize("name,slots,rows,cols,batch,cfg_kw", [
    ("1080p step of 4", 8, 1080, 1920, 4, {}),
    ("1080p fast step of 1", 4, 1080, 1920, 1, FAST),
    ("270x480 V-cycle step of 2", 8, 270, 480, 2, {"multigrid": "vcycle"}),
])
def test_sharded_step_launches_the_routes_and_equals_one_device(dev, name, slots, rows, cols,
                                                                batch, cfg_kw):
    """One eager ``batched_step`` on a slot mesh of the card against each
    image's single-device solve. The 1080p step of 4 on (2, 2, 2) shards
    every level, launches one K1 per exchange and card (244 on one card)
    and one K3 block per slot and image, and equals the single-device depth
    and defocus bit for bit. The fast step of one image on (1, 2, 2)
    launches one K4 per exchange of every chunk of each level's cap, and
    the V-cycle step (a sharded warm cascade, the polish per image) K1 and
    K3 blocks; both lie within RMSE 1e-3 of the single-device solve (the
    sharded probes sum in another order; the polish runs per image)."""
    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.core.solver import read_exit_log
    from realtimedepthdiffusion_tpu_torch.parallel import mesh, sharded

    cfg = DiffusionConfig(**cfg_kw)
    m = mesh.make_mesh(slots, device=dev)
    cards, halo = len(set(m.devices.values())), sharded.DEFAULT_HALO
    fn, make_args = sharded.batched_step(m, rows, cols, cfg, fx.EFFECT_DEFOCUS)
    scenes = [_photo(rows, cols, 70 + i) for i in range(batch)]
    rgb, mask, value = (torch.from_numpy(np.stack(a)).to(dev) for a in zip(*scenes))
    state = make_args(batch)[3]
    log = []
    _reset_counts()
    depth, _, out = fn.eager(rgb, mask, value, state, log)
    read_exit_log(log)
    torch.cuda.synchronize()
    counts = _counts()
    blocks = batch * m.shape["dy"] * m.shape["dx"]
    n_levels = cfg.num_levels(rows, cols)
    if cfg.early_exit:
        every = cfg.residual_check_every
        assert counts == {"rb_sweep_tiles": cards * sum(
            -(-min(every, e["cap"] - b) // halo) for e in log for b in range(0, e["cap"], every)),
            "defocus_block": blocks}
    elif cfg.multigrid == "vcycle":
        assert counts.get("jc_sweep_tiles") and counts.get("defocus_block") == blocks
    else:
        assert all(sharded.level_is_sharded(m, *cfg.level_size(rows, cols, lv), cfg.solver)
                   for lv in range(n_levels))
        want_k1 = cards * sum(-(-cfg.level_iterations(n_levels, lv) // halo)
                              for lv in range(n_levels))
        assert cards > 1 or want_k1 == 244
        assert counts == {"jc_sweep_tiles": want_k1, "defocus_block": blocks}
    pipe = DepthPipeline(rows, cols, cfg, device=dev)
    for n in range(batch):
        _, gpyr = pipe.prepare_image(rgb[n])
        d1, _ = pipe.solve(gpyr, mask[n], value[n], tuple(s[n] for s in state))
        assert torch.equal(depth[n][mask[n]], value[n][mask[n]].to(torch.float32)), n
        if cfg_kw:
            assert _rmse01(depth[n], d1) <= 1e-3, n
        else:
            o1 = defocus.defocus_box(rgb[n], torch.clamp(d1, 0.0, 255.0), cfg)
            torch.cuda.synchronize()
            assert torch.equal(depth[n], d1) and torch.equal(out[n], o1), n


@pytest.mark.parametrize("iters,launches", [
    (120, {"jc_sweep_resident": 4, "jc_sweep_tiles": 15, "defocus_box": 1}),
    (0, {"jc_sweep_resident": 4, "jc_sweep_tiles": 125, "defocus_box": 1}),
], ids=["incremental_iterations=120", "default"])
def test_incremental_1080p_frame_equals_plain_and_a_full_resolve(dev, monkeypatch, iters,
                                                                   launches):
    """The windowed re-solve of a 1080p frame after an edit, on a settled
    scene (``_settled_scene``): it launches K2 on L4-L2 and on the 192
    window of L1 and ceil(n / 8) K1 on the 384 window of L0 (120 sweeps, or
    the default budget's 1000), and K3; pins its scribbles; moves level 0
    outside its window and on its frozen ring by the pyrUp'd correction of
    level 1 alone; equals the same frame on the plain versions bit for bit;
    and lies within RMSE 3e-2 of a full re-solve from the same state."""
    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.core import incremental
    from realtimedepthdiffusion_tpu_torch.core.pyramid import pyr_up

    h, w = 1080, 1920
    cfg = DiffusionConfig(incremental_iterations=iters, fast_start=True)
    pipe = DepthPipeline(h, w, cfg, device=dev)
    rgb_d, gpyr, mask, value, state = _settled_scene(pipe, dev, 8)
    cy, cx = 600, 1100
    mask[590:610, 1090:1110], value[590:610, 1090:1110] = True, 64
    m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
    ops.reset_launch_counts()
    depth, new_state, out = pipe.solve_incremental_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, m,
                                                              v, state, (cy, cx))
    assert _counts() == launches
    assert new_state[0] is depth and len(new_state) == len(gpyr)
    assert bool(torch.isfinite(depth).all()) and torch.equal(depth[m], v[m].to(torch.float32))
    assert out.shape == (h, w, 3) and out.dtype == torch.uint8
    win = cfg.incremental_window
    oy, ox = incremental.clamp_origin(cy - win // 2, cx - win // 2, win, win, h, w)
    injected = seed_depth(state[0] + pyr_up(new_state[1] - state[1], (h, w)), m, v)
    outside = torch.ones((h, w), dtype=torch.bool, device=dev)
    outside[oy + 1:oy + win - 1, ox + 1:ox + win - 1] = False
    assert torch.equal(depth[outside], injected[outside])
    assert not torch.equal(depth[~outside], injected[~outside])
    with monkeypatch.context() as mp:
        _plain_routes(mp)
        ops.reset_launch_counts()
        want = pipe._inc_fx_eager(fx.EFFECT_DEFOCUS, tuple(gpyr), rgb_d, m, v, tuple(state),
                                  (cy, cx))
        torch.cuda.synchronize()
        assert not any(ops.launch_counts().values())
    assert torch.equal(depth, want[0]) and torch.equal(out, want[2])
    assert all(torch.equal(a, b) for a, b in zip(new_state, want[1]))
    full, _ = pipe.solve(gpyr, m, v, state)
    assert _rmse01(depth, full) <= 3e-2


def test_vcycle_1080p_frame_polishes_its_warm_cascade(dev):
    """A 1080p V-cycle frame: its warm cascade launches what a default
    frame launches (``FRAME_1080P``) and its polish, plain torch ops on
    every device, no kernel of the port; the frame's depth is the polish of
    the warm cascade's depth bit for bit, in [0, 255] with its scribbles
    pinned, and its fine residual is no larger than 1.05 x the cascade's
    under the cascade's weights, which are the polish's own."""
    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.core.multigrid import (solve_cascade, vcycle_polish,
                                                                 vcycle_warm_config)
    from realtimedepthdiffusion_tpu_torch.core.solver import residual_norm

    cfg = DiffusionConfig(multigrid="vcycle")
    pipe = DepthPipeline(1080, 1920, cfg, device=dev)
    rgb, mask, value = _photo(1080, 1920, 45)
    rgb_d, gpyr = pipe.prepare_image(rgb)
    m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
    state = pipe.initial_state()
    ops.reset_launch_counts()
    depth, new_state, out = pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v, state)
    assert _counts() == FRAME_1080P
    assert new_state[0] is depth and out.shape == (1080, 1920, 3) and out.dtype == torch.uint8
    assert 0.0 <= float(depth.min()) and float(depth.max()) <= 255.0
    assert torch.equal(depth[m], v[m].to(torch.float32))
    cascade, _ = solve_cascade(gpyr, m, v, state, vcycle_warm_config(cfg))
    ops.reset_launch_counts()
    polished = vcycle_polish(gpyr, m, v, cascade, cfg)
    torch.cuda.synchronize()
    assert not any(ops.launch_counts().values())
    assert torch.equal(polished, depth)
    wts = edge_weights(gpyr[0], cascade, 0, len(gpyr) - 1, cfg)
    assert float(residual_norm(depth, m, wts)) <= 1.05 * float(residual_norm(cascade, m, wts))


def test_facade_keeps_its_state_on_the_card(dev):
    """``models.ChebyshevCascade(device="cuda")``: numpy in and out, the
    state on the card; ``solve_and_render`` launches K2, K1 and K3, and
    ``solve_incremental`` K2 on its windows and pins its scribbles."""
    from realtimedepthdiffusion_tpu_torch import models

    h, w = 540, 960
    rgb, mask, value = _photo(h, w, 11)
    model = models.ChebyshevCascade(device="cuda", incremental_window=192)
    ops.reset_launch_counts()
    depth, art, state = model.solve_and_render(rgb, mask, value, "b")
    assert set(_counts()) == {"jc_sweep_resident", "jc_sweep_tiles", "defocus_box"}
    assert depth.dtype == np.float32 and depth.shape == (h, w) and np.isfinite(depth).all()
    assert art.dtype == np.uint8 and art.shape == (h, w, 3)
    mask[300:310, 500:510], value[300:310, 500:510] = True, 96
    ops.reset_launch_counts()
    depth2, state2 = model.solve_incremental(rgb, mask, value, state, (305, 505))
    assert _counts().get("jc_sweep_resident") and all(t.is_cuda for t in state2)
    assert np.array_equal(depth2[mask], value[mask].astype(np.float32))


def test_native_runtime_builds_on_the_card_machine(dev):
    """The session's host runtime is the native library, built by g++ where
    the card is (its Python fallback gives the same bits, more slowly), and
    the card's brush (``core.annotation.paint``) paints what the native
    brush paints, at the edges and past them too."""
    from realtimedepthdiffusion_tpu_torch.core.annotation import paint
    from realtimedepthdiffusion_tpu_torch.native import runtime

    nrt = runtime.NativeRuntime()
    assert nrt.available
    arena = runtime.Arena(4096)
    assert arena.native
    arena.close()
    h, w = 270, 480
    radius = DiffusionConfig().brush_radius(h, w)
    strokes = [(200, 140, 64, radius), (0, 0, 192, radius), (w - 1, h - 1, 254, radius),
               (-5, 100, 0, radius), (300, h + 4, 128, radius), (5000, 5000, 64, radius),
               (70, 70, 128, 0), (70, 70, 128, -3), (240, 135, 1, 400)]
    mask, value = np.zeros((h, w), np.uint8), np.zeros((h, w), np.uint8)
    mask[40:70, 60:100], value[40:70, 60:100] = 1, 200
    tm, tv = torch.from_numpy(mask != 0).to(dev), torch.from_numpy(value).to(dev)
    for x, y, col, rad in strokes:
        nrt.paint(mask, value, x, y, col, rad)
        tm, tv = paint(tm, tv, x, y, col, rad)
    assert np.array_equal(tm.cpu().numpy(), mask != 0) and np.array_equal(tv.cpu().numpy(), value)


@pytest.mark.parametrize("profile", ["default", "fast"])
def test_session_updates_on_the_card_equal_plain(dev, monkeypatch, tmp_path, profile):
    """A live session (270x480, ``incremental_iterations=120``, a 128
    window), update by update: the first solve; the update that finds the
    windowed path's gate closed, which re-solves in full and then runs the
    gate's kick (one windowed re-solve with its effect on stand-in tensors,
    then the capture), so it launches K3 twice; one rect, two rects and an
    annotation load. Each update's state, effect and u8 map equal the same
    update on the plain versions on the card bit for bit, it uploads what
    its path needs, every other update launches K3 once, and under
    ``--profile fast`` no Jacobi kernel runs. A checkpoint with two rects
    pending, resumed into a new session, gives the original's next solve
    bit for bit with the same launches."""
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.live.session import DepthSession

    h, w = 270, 480
    cfg = DiffusionConfig(incremental_iterations=120, incremental_window=128, fast_start=True,
                          **(FAST if profile == "fast" else {}))
    rgb, mask, value = _photo(h, w, 50)

    def session():
        s = DepthSession(rgb, cfg, device=dev)
        s.pipe.background_compile = True
        return s

    s = session()
    s.mask_np[:], s.value_np[:] = mask, value
    s.mark_all_dirty()
    s.set_effect_key("b")
    updates = [("first", []), ("kick", [(w // 2 + i, h // 2) for i in range(0, 12, 2)]),
               ("one rect", [(w // 3 + i, 2 * h // 3) for i in range(0, 12, 2)]),
               ("two rects", [(w // 5, h // 4), (4 * w // 5, 3 * h // 4)]),
               ("annotation load", None)]
    for i, (name, paints) in enumerate(updates):
        before, n_before = s.depth_state, s.solve_count
        if paints is None:
            s.mark_all_dirty()
        else:
            s.set_color_key(1 + i % 4)
            for x, y in paints:
                s.paint(x, y)
        rects = list(s.dirty_rects)
        local = name in ("one rect", "two rects")
        ops.reset_launch_counts()
        u8 = s.solve()
        counts = _counts()
        m_d = torch.tensor(s.mask_np != 0, device=dev)
        v_d = torch.tensor(s.value_np, device=dev)
        with monkeypatch.context() as mp:
            _plain_routes(mp)
            ops.reset_launch_counts()
            st = before
            if local:
                for r in rects:
                    p_depth, st = s.pipe._inc_eager(s.gray_pyr, m_d, v_d, st,
                                                    ((r[0] + r[2]) // 2, (r[1] + r[3]) // 2))
            else:
                pipe = s._inc_pipe if n_before > 0 else s.pipe
                p_depth, st = pipe._solve_eager(s.gray_pyr, m_d, v_d, before)
            p_out = s.pipe.effect(fx.EFFECT_DEFOCUS, s.rgb, s.gray_pyr[0],
                                  torch.clamp(p_depth, 0.0, 255.0))
            torch.cuda.synchronize()
            assert not any(ops.launch_counts().values()), name
        assert all(torch.equal(a, b) for a, b in zip(s.depth_state, st)), name
        assert torch.equal(s.artistic, p_out), name
        assert np.array_equal(u8, s.pipe.depth_u8(p_depth).cpu().numpy()), name
        assert s.last_upload_bytes == (2 * 128 * 128 * len(rects) if local else 2 * h * w), name
        assert counts.get("defocus_box") == 1 + (name == "kick"), (name, counts)
        if profile == "fast":
            assert not {"jc_sweep_tiles", "jc_sweep_resident"} & set(counts), (name, counts)
            assert {"rb_sweep_tiles", "rb_sweep_resident"} & set(counts), (name, counts)
        assert s.pipe.incremental_ready(fx.EFFECT_DEFOCUS, kick=False) == (i >= 1), name
    s.set_color_key(2)
    s.paint(w // 4, h // 4)
    s.paint(3 * w // 4, 3 * h // 4)
    ck = str(tmp_path / "session.npz")
    s.save_checkpoint(ck)
    resumed = session()
    resumed.load_checkpoint(ck)
    resumed.pipe.incremental_ready(fx.EFFECT_DEFOCUS)  # its windowed program, as s has one
    assert resumed.dirty_rects == s.dirty_rects and len(s.dirty_rects) == 2
    runs = []
    for sess in (s, resumed):
        ops.reset_launch_counts()
        runs.append((sess.solve(), _counts()))
    torch.cuda.synchronize()
    assert runs[0][1] == runs[1][1] and np.array_equal(runs[0][0], runs[1][0])
    assert torch.equal(resumed.artistic, s.artistic)
    assert all(torch.equal(a, b) for a, b in zip(resumed.depth_state, s.depth_state))


def test_serve_on_the_card_launches_the_routes(dev, tmp_path, monkeypatch):
    """``serve.solve_pairs`` on the card over three 96x128 pairs: the default
    run launches an eager frame's kernels per pair; under ``--profile fast``
    each pair launches every chunk of its levels' caps, as its exit log
    names them, and K3, and the solve's graph is the server's one program
    (captured at the second pair, replayed at the third)."""
    from realtimedepthdiffusion_tpu_torch import io, pipeline, serve
    from realtimedepthdiffusion_tpu_torch.core import effects as fx

    for sub in ("images", "annotations"):
        (tmp_path / sub).mkdir()
    for i in range(3):
        rgb, mask, value = _photo(96, 128, 60 + i)
        io.imwrite(str(tmp_path / "images" / f"p{i}.png"), rgb)
        io.save_annotation(str(tmp_path / "annotations" / f"p{i}.png"), mask, value)
    pairs = serve.discover_pairs(str(tmp_path / "images"), str(tmp_path / "annotations"))
    cfg = DiffusionConfig()
    pipe = pipeline.DepthPipeline(96, 128, cfg, device=dev)
    rgb_d, gpyr = pipe.prepare_image(rgb)
    m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
    ops.reset_launch_counts()
    pipe._solve_fx_eager(fx.EFFECT_DEFOCUS, tuple(gpyr), rgb_d, m, v, pipe.initial_state())
    frame = _counts()
    ops.reset_launch_counts()
    assert all(serve.solve_pairs(pairs, str(tmp_path / "default"), cfg, fx.EFFECT_DEFOCUS,
                                 device=dev))
    assert _counts() == {k: 3 * n for k, n in frame.items()}
    logs = []

    class Logged(pipeline.DepthPipeline):
        def solve_and_effect(self, *a, **kw):
            logs.append([])
            return super().solve_and_effect(*a, exit_log=logs[-1], **kw)

    monkeypatch.setattr(pipeline, "DepthPipeline", Logged)
    fast, pipes = DiffusionConfig(**FAST), {}
    ops.reset_launch_counts()
    assert all(serve.solve_pairs(pairs, str(tmp_path / "fast"), fast, fx.EFFECT_DEFOCUS,
                                 device=dev, pipelines=pipes))
    want = collections.Counter(defocus_box=len(logs))
    for log in logs:
        want.update(_rb_exit_launches(log, fast.residual_check_every))
    assert len(logs) == 3 and _counts() == dict(want)
    assert [list(p._aot) for p in pipes.values()] == [[("solve_fx", fx.EFFECT_DEFOCUS)]]


def test_replay_takes_a_new_image_of_the_shape(dev, monkeypatch):
    """A 1080p frame replayed from the graph captured on one image, given a
    second image of the shape (its colour and gray pyramid copied into the
    graph's inputs), equals the eager frame on that image bit for bit and
    launches what it launches."""
    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.utils import program

    pipe = DepthPipeline(1080, 1920, DiffusionConfig(fast_start=True), device=dev)
    pipe.background_compile = True
    rgb, mask, value = _photo(1080, 1920, 25)
    m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
    rgb_d, gpyr = pipe.prepare_image(rgb)
    state = pipe.initial_state()
    for _ in range(2):  # eager, then eager and the capture
        state = pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v, state)[1]
    replays = []
    real = program.Program.__call__
    monkeypatch.setattr(program.Program, "__call__",
                        lambda self, *a: (replays.append(1), real(self, *a))[1])
    rgb_d, gpyr = pipe.prepare_image(_photo(1080, 1920, 26)[0])
    ops.reset_launch_counts()
    got = pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v, state)
    counts = _counts()
    ops.reset_launch_counts()
    want = pipe._solve_fx_eager(fx.EFFECT_DEFOCUS, tuple(gpyr), rgb_d, m, v, tuple(state))
    torch.cuda.synchronize()
    assert replays == [1] and counts == _counts() == FRAME_1080P
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))


@pytest.mark.parametrize("cfg_kw", [{}, {"solver": "red_black"}],
                         ids=["default", "red-black fixed count"])
def test_replayed_graph_runs_its_tally(dev, cfg_kw):
    """One replay of a captured 1080p frame, under the profiler, runs kernel
    by kernel what its program's tally counts: each wrapper's call is one
    node of the graph."""
    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.core import effects as fx

    node = {"jc_sweep_tiles": "jc_sweep_tiles_kernel",
            "jc_sweep_resident": "jc_sweep_resident_kernel",
            "rb_sweep_tiles": "rb_sweep_tiles_kernel",
            "rb_sweep_resident": "rb_sweep_resident_kernel",
            "defocus_box": "defocus_tile_kernel"}
    pipe = DepthPipeline(1080, 1920, DiffusionConfig(fast_start=True, **cfg_kw), device=dev)
    pipe.background_compile = True
    rgb, mask, value = _photo(1080, 1920, 27)
    m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
    rgb_d, gpyr = pipe.prepare_image(rgb)
    state = pipe.initial_state()
    for _ in range(2):
        state = pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v, state)[1]
    tally = pipe._aot[("solve_fx", fx.EFFECT_DEFOCUS)].tally
    seen = _kernels_on_device(
        lambda: pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v, state))
    assert tally and {k: seen[node[k]] for k in tally} == tally


def test_card_loop_equals_host_loop_on_the_card(dev, monkeypatch):
    """A replayed ``--profile fast`` 1080p frame, which issues every chunk
    (those after a level's exit return on the card's flag), equals the same
    frame with the loop read on the host, which never issues them, bit for
    bit; the host loop launches fewer kernels."""
    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.core import solver as tsolver

    pipe = DepthPipeline(1080, 1920, DiffusionConfig(fast_start=True, **FAST), device=dev)
    pipe.background_compile = True
    rgb, mask, value = _photo(1080, 1920, 28)
    m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
    rgb_d, gpyr = pipe.prepare_image(rgb)
    state = pipe.initial_state()
    for _ in range(2):
        state = pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v, state)[1]
    key = ("solve_fx", fx.EFFECT_DEFOCUS)
    assert key in pipe._aot
    got = pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v, state)
    monkeypatch.setattr(tsolver, "_host_loop", lambda device: True)
    ops.reset_launch_counts()
    want = pipe._solve_fx_eager(fx.EFFECT_DEFOCUS, tuple(gpyr), rgb_d, m, v, tuple(state))
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert sum(ops.launch_counts().values()) < sum(pipe._aot[key].tally.values())
