"""The port's red-black solver, its residual early exit and plain Jacobi
(what kernels K4 and K5 are held to on the card) against the JAX package on
the CPU: its XLA solvers, and its Pallas red-black kernels in interpret
mode as the JAX suite runs them.

Tolerances are the JAX suite's own bars between its red-black kernels and
XLA (tests/test_pallas.py): 5e-3 gray levels through 5 iterations, 2e-2
beyond, where the SOR omegas (about 1.97 after the warm-up) amplify
one-ulp differences in the 4-term sum. The early-exit cases assert that
every residual probe sits more than 5 % away from the threshold, so a
different summation order cannot move the exit to another chunk.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.core import solver as jsolver
from realtimedepthdiffusion_tpu.core import weights as jweights
from realtimedepthdiffusion_tpu.ops import pallas_sweep as jps
from realtimedepthdiffusion_tpu_torch import ops
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import solver
from realtimedepthdiffusion_tpu_torch.core.weights import edge_weights
from realtimedepthdiffusion_tpu_torch.ops import rb_sweep, sweep

RB = {"solver": "red_black"}


def _case(seed, h=49, w=67):
    r = np.random.default_rng(seed)
    gray = r.integers(0, 256, (h, w), dtype=np.uint8)
    mask = r.random((h, w)) < 0.06
    value = r.integers(0, 255, (h, w), dtype=np.uint8)
    depth = np.where(mask, value, 255.0).astype(np.float32)
    return gray, mask, depth


def _port(gray, mask, depth, level, max_level, iters, exit_log=None, **kw):
    got = solver.solve_level(torch.from_numpy(depth), torch.from_numpy(mask),
                             torch.from_numpy(gray), level, max_level, iters,
                             DiffusionConfig(**kw), exit_log)
    assert got.dtype == torch.float32
    return got.numpy()


def _jax_args(gray, mask, depth, level, max_level, iters):
    return (jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), level, max_level, iters)


def _assert_margin(entries):
    """Every probe of the logged early exits is > 5 % away from its threshold."""
    assert entries
    for e in entries:
        for p in e["probes"]:
            assert abs(p - e["tol"]) > 0.05 * e["tol"], (p, e["tol"])


@pytest.mark.parametrize("iters", [1, 5, 13, 62])
@pytest.mark.parametrize("cheb", [True, False])
def test_rb_omegas_bit_identical(iters, cheb):
    got = solver.rb_omegas(iters, DiffusionConfig(rb_chebyshev=cheb))
    want = jsolver.rb_omegas(iters, JConfig(rb_chebyshev=cheb))
    assert got.dtype == np.float32 and got.shape == (iters, 2)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# The default route is the strip megakernel (#8), pallas_rb_resident the
# resident kernel (#6), pallas_rb_megakernel=False the chunked strips (#7).
@pytest.mark.parametrize("iters", [1, 5, 13])
@pytest.mark.parametrize("route", [{}, {"pallas_rb_resident": True},
                                   {"pallas_rb_megakernel": False}],
                         ids=["mega", "resident", "chunked"])
def test_plain_rb_matches_pallas(iters, route):
    gray, mask, depth = _case(iters, 40, 56)
    want = np.asarray(jps.solve_level_red_black_pallas(
        *_jax_args(gray, mask, depth, 1, 1, iters), JConfig(**RB, **route), interpret=True))
    got = _port(gray, mask, depth, 1, 1, iters, **RB, **route)
    np.testing.assert_allclose(got, want, atol=5e-3 if iters <= 5 else 2e-2, rtol=0)
    assert np.array_equal(got[mask], depth[mask])


def test_plain_rb_matches_xla_red_black_iter():
    """Two iterations, against the XLA red_black_iter on the same weights."""
    gray, mask, depth = _case(2, 23, 31)
    cfg = DiffusionConfig(**RB)
    jcfg = JConfig(**RB)
    jw = jweights.edge_weights(jnp.asarray(gray), None, 1, 1, jcfg)
    want = np.asarray(jsolver.solve_red_black(jnp.asarray(depth), jnp.asarray(mask), jw, 2,
                                              jcfg))
    wts = edge_weights(torch.from_numpy(gray), torch.from_numpy(depth), 1, 1, cfg)
    got = rb_sweep.solve_level_rb_plain(torch.from_numpy(depth), torch.from_numpy(mask),
                                        wts, solver.rb_omegas(2, cfg)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
    assert got.min() >= 0.0 and got.max() <= 255.0


def test_rb_plain_half_sweep_by_hand():
    """One red-black iteration by hand in float32 numpy, op by op, equals
    rb_iter_plain exactly: red from the state, black from the half-update."""
    gray, mask, depth = _case(3, 13, 17)
    depth = (np.random.default_rng(5).random(depth.shape) * 255).astype(np.float32)
    wts = edge_weights(torch.from_numpy(gray), torch.from_numpy(depth), 0, 1)
    om_r, om_b = (float(v) for v in solver.rb_omegas(9, DiffusionConfig())[8])
    red = rb_sweep.red_black_parity(13, 17)
    got = rb_sweep.rb_iter_plain(torch.from_numpy(depth), wts.wl, wts.wr, wts.wu, wts.wd,
                                 wts.inv_count, torch.from_numpy(mask), red, om_r, om_b)
    wl, wr, wu, wd, inv = (t.numpy() for t in wts)
    f = np.float32
    yy, xx = np.mgrid[:13, :17]
    u = depth.copy()
    for colour, om in ((0, om_r), (1, om_b)):
        p = np.pad(u, 1)
        s = wl * p[1:-1, :-2]
        s = s + wr * p[1:-1, 2:]
        s = s + wu * p[:-2, 1:-1]
        s = s + wd * p[2:, 1:-1]
        r = np.clip(s * inv, f(0), f(255))
        new = np.clip(u + f(om) * (r - u), f(0), f(255))
        u = np.where(((yy + xx) % 2 == colour) & ~mask, new, u)
    assert np.array_equal(got.numpy(), u)
    assert bool(red[0, 0]) and not bool(red[0, 1]) and bool(red[1, 1])


@pytest.mark.parametrize("tolerance,fires", [(1e-4, False), (2e-2, True)])
def test_rb_early_exit_matches_pallas(tolerance, fires):
    """test_pallas.py's case (40x56, chunk 6, 20 iterations): the port's
    chunk loop (the XLA shape, a truncated last chunk) against the Pallas
    early exit (full chunks, then an unprobed tail) and the XLA one."""
    gray, mask, depth = _case(11, 40, 56)
    kw = dict(RB, early_exit=True, residual_check_every=6, tolerance=tolerance)
    log = []
    got = _port(gray, mask, depth, 1, 1, 20, log, **kw)
    _assert_margin(log)
    assert (log[0]["iters"] < 20) == fires
    args = _jax_args(gray, mask, depth, 1, 1, 20)
    want_pallas = np.asarray(jps.solve_level_red_black_pallas(*args, JConfig(**kw),
                                                              interpret=True))
    want_xla = np.asarray(jsolver.solve_level(*args, JConfig(**kw)))
    np.testing.assert_allclose(got, want_pallas, atol=2e-2, rtol=0)
    np.testing.assert_allclose(got, want_xla, atol=2e-2, rtol=0)
    assert np.array_equal(got[mask], depth[mask])


@pytest.mark.parametrize("sv", ["jacobi_chebyshev", "jacobi", "red_black"])
def test_unreachable_tolerance_is_bitwise_fixed_count(sv):
    """tolerance=0: the chunked loop (40 = 5x7 + 5) lands on exactly the
    fixed-count iterate, for every solver."""
    gray, mask, depth = _case(12, 32, 40)
    fixed = _port(gray, mask, depth, 1, 1, 40, solver=sv)
    log = []
    chunked = _port(gray, mask, depth, 1, 1, 40, log, solver=sv, early_exit=True,
                    tolerance=0.0, residual_check_every=7)
    assert np.array_equal(fixed, chunked)
    assert log[0]["iters"] == 40 and len(log[0]["probes"]) == 6


@pytest.mark.parametrize("level", [0, 1])
def test_residuals_match_jax(level):
    gray, mask, depth = _case(13, 31, 45)
    depth = np.where(mask, depth, np.random.default_rng(1).random(depth.shape) * 255)
    depth = depth.astype(np.float32)
    jw = jweights.edge_weights(jnp.asarray(gray), jnp.asarray(depth), level, 1, JConfig())
    wts = edge_weights(torch.from_numpy(gray), torch.from_numpy(depth), level, 1)
    u, m = torch.from_numpy(depth), torch.from_numpy(mask)
    for tfn, jfn in ((solver.residual_norm, jsolver.residual_norm),
                     (solver.residual_rms, jsolver.residual_rms)):
        got = tfn(u, m, wts)
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(jfn(jnp.asarray(depth),
                                                         jnp.asarray(mask), jw)), rtol=1e-5)


def test_residual_metric_fn():
    assert solver.residual_metric_fn(DiffusionConfig()) is solver.residual_rms
    assert (solver.residual_metric_fn(DiffusionConfig(residual_metric="max"))
            is solver.residual_norm)
    with pytest.raises(ValueError, match="residual_metric"):
        solver.residual_metric_fn(types.SimpleNamespace(residual_metric="l7"))
    with pytest.raises(ValueError, match="residual_metric"):
        DiffusionConfig(residual_metric="l7")


@pytest.mark.parametrize("iters", [1, 11, 25])
@pytest.mark.parametrize("level", [0, 1])
def test_jacobi_matches_jax(iters, level):
    gray, mask, depth = _case(20 + iters, 40, 56)
    want = np.asarray(jsolver.solve_level(*_jax_args(gray, mask, depth, level, 1, iters),
                                          JConfig(solver="jacobi")))
    got = _port(gray, mask, depth, level, 1, iters, solver="jacobi")
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
    assert np.array_equal(got[mask], depth[mask])


def test_jacobi_table_is_plain_jacobi():
    """The (1, 0, 0) rows through the sweep path equal where(mask, u,
    relax(u)) exactly, for any prev."""
    gray, mask, depth = _case(21, 13, 17)
    wts = edge_weights(torch.from_numpy(gray), torch.from_numpy(depth), 1, 1)
    u, m = torch.from_numpy(depth), torch.from_numpy(mask)
    table = solver.jacobi_schedule(3)
    assert table.dtype == np.float32 and table.tolist() == [[1.0, 0.0, 0.0]] * 3
    want = u
    for _ in range(3):
        want = torch.where(m, want, solver.jacobi_sweep(want, wts))
    got = ops.sweep.solve_level_plain(u, m, wts, table)
    assert torch.equal(got, want)


@pytest.mark.parametrize("tolerance,fires", [(1e-5, False), (2e-3, True)])
def test_jc_early_exit_matches_pallas(tolerance, fires):
    """The Jacobi-Chebyshev early exit against the Pallas strip runner
    (solve_level_strips_early_exit), which carries (u, prev) across chunks:
    25 iterations, 4 chunks of 6 and one of 1, inside the 25-sweep range of
    the 5e-3 bar."""
    gray, mask, depth = _case(30, 40, 56)
    kw = dict(early_exit=True, residual_check_every=6, tolerance=tolerance)
    log = []
    got = _port(gray, mask, depth, 1, 1, 25, log, **kw)
    _assert_margin(log)
    assert (log[0]["iters"] < 25) == fires
    want = np.asarray(jps.solve_level_strips_early_exit(
        *_jax_args(gray, mask, depth, 1, 1, 25), JConfig(**kw), interpret=True))
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
    assert np.array_equal(got[mask], depth[mask])


@pytest.mark.parametrize("flag", [{"pallas_rb_resident": True},
                                  {"pallas_rb_megakernel": False},
                                  {"pallas_rb_compact": True},
                                  {"pallas_in_kernel_halo": True}],
                         ids=lambda d: next(iter(d)))
def test_rb_variant_flags_change_nothing(flag):
    """The TPU's red-black variant flags choose kernels of one iterate: the
    port accepts them and gives the same bits."""
    gray, mask, depth = _case(40, 24, 30)
    base = _port(gray, mask, depth, 0, 1, 9, **RB)
    assert np.array_equal(_port(gray, mask, depth, 0, 1, 9, **RB, **flag), base)


def test_rb_cpu_solve_launches_no_kernel_and_wrappers_refuse_cpu():
    ops.reset_launch_counts()
    gray, mask, depth = _case(41, 16, 20)
    _port(gray, mask, depth, 0, 1, 3, **RB, early_exit=True, residual_check_every=2)
    assert set(ops.launch_counts().values()) == {0}
    f = torch.zeros((8, 9))
    m = torch.zeros((8, 9), dtype=torch.uint8)
    om = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="CUDA"):
        rb_sweep.rb_sweep_tiles(f, f, f, f, f, m, om, 0, 4)
    with pytest.raises(ValueError, match="CUDA"):
        rb_sweep.rb_sweep_resident(f, f, f, f, m, om, 0, 4)
    with pytest.raises(ValueError, match="CUDA"):
        rb_sweep.solve_level_rb_cuda(f, m.bool(), edge_weights(m, f, 0, 1),
                                     solver.rb_omegas(4))
    assert set(ops.launch_counts().values()) == {0}


def test_rb_resident_fit_rule():
    """K5 holds L4 of a 1080p cascade (67x120: 60 x 17 threads of 4 x 2
    pixels) and not L3."""
    assert rb_sweep.rb_resident_fits(67, 120)
    assert rb_sweep.rb_resident_config(67, 120) == (60, 17, 4, 2)
    assert not rb_sweep.rb_resident_fits(135, 240)


# (h, w) and K5's CTA: 1080p L4, 4K L5, a level four columns too wide,
# 1080p L3, one pixel, the tallest and the widest level of one patch column
# or row, and one row more than that.
@pytest.mark.parametrize("shape,want", [
    ((67, 120), (60, 17, 4, 2)), ((68, 120), (60, 17, 4, 2)), ((68, 128), None),
    ((135, 240), None), ((1, 1), (1, 1, 4, 2)), ((4096, 2), (1, 1024, 4, 2)),
    ((4, 2048), (1024, 1, 4, 2)), ((5, 2048), None),
])
def test_rb_resident_config(shape, want):
    """K5's CTA: one patch of 4 x 2 pixels a thread covers the level with
    none to spare, within 1024 threads, and the one shared buffer of u fits
    one CTA's shared memory."""
    h, w = shape
    got = rb_sweep.rb_resident_config(h, w)
    assert got == want and rb_sweep.rb_resident_fits(h, w) == (want is not None)
    if got is not None:
        bx, by, rows, cols = got
        assert (rows, cols) == rb_sweep.RB_RESIDENT_PATCH
        assert bx * by <= rb_sweep.RB_RESIDENT_MAX_THREADS
        assert bx * cols >= w > (bx - 1) * cols and by * rows >= h > (by - 1) * rows
        assert rb_sweep.rb_smem_bytes(got) <= sweep.SMEM_PER_CTA


@pytest.mark.parametrize("tile", [rb_sweep.RB_TILE_SHALLOW, rb_sweep.RB_TILE_DEEP,
                                  (64, 8, 8, 1), (64, 8, 8, 2), (32, 16, 8, 2), (64, 8, 4, 2)])
def test_rb_tile_shapes_and_refusals(tile):
    """Every CTA shape K4 is offered, at every k it carries: a positive
    interior, tile origins on red cells (even y + x, so that a pixel's
    colour is that of its tile coordinates), a patch the kernel has and a
    buffer that fits one CTA's shared memory. Beyond that k the shape is
    refused."""
    bx, by, rows, cols = tile
    eh, ew = rb_sweep.rb_tile_extent(tile)
    assert (eh, ew) == (by * rows, bx * cols) and eh % 2 == 0 and ew % 2 == 0
    assert rows % 2 == 0 and (rows, cols) in rb_sweep.RB_TILE_PATCHES
    assert bx * by <= rb_sweep.RB_TILE_MAX_THREADS
    assert rb_sweep.rb_smem_bytes(tile) == 4 * (eh + 2) * cols * (bx + 2) <= sweep.SMEM_PER_CTA
    k_max = (min(eh, ew) - 1) // 4
    for k in range(1, k_max + 1):
        assert rb_sweep._check_rb_tile(tile, k) == tile
        ih, iw = eh - 4 * k, ew - 4 * k
        assert ih > 0 and iw > 0
        for ty, tx in ((0, 0), (1, 0), (0, 1), (3, 5)):
            assert (ty * ih - 2 * k + tx * iw - 2 * k) % 2 == 0
    with pytest.raises(ValueError, match="ring"):
        rb_sweep._check_rb_tile(tile, k_max + 1)


def test_rb_tile_config_routes_and_refusals():
    """``rb_tile_config`` serves every k up to ``MAX_RB_TILE_ITERS`` with a
    shape that carries it, the route's k with the shallow one; no shape
    carries more, an odd tile width or a patch the kernel lacks."""
    for k in range(1, rb_sweep.MAX_RB_TILE_ITERS + 1):
        assert rb_sweep._check_rb_tile(rb_sweep.rb_tile_config(k), k)
    assert rb_sweep.rb_tile_config(rb_sweep.RB_TILE_ITERS) == rb_sweep.RB_TILE_SHALLOW
    assert rb_sweep.rb_tile_config(rb_sweep.MAX_RB_TILE_ITERS) == rb_sweep.RB_TILE_DEEP
    with pytest.raises(ValueError, match="k must be"):
        rb_sweep.rb_tile_config(rb_sweep.MAX_RB_TILE_ITERS + 1)
    for bad in ((33, 8, 8, 1), (64, 8, 6, 1), (64, 16, 4, 2)):
        with pytest.raises(ValueError, match="ring"):
            rb_sweep._check_rb_tile(bad, 1)
    assert rb_sweep._parities(1, 3) == [1, 1, 1] and rb_sweep._parities([0, 3, True], 3) == [0, 1, 1]
    with pytest.raises(ValueError, match="parity"):
        rb_sweep._parities([0, 1], 3)


def test_wrappers_refuse_tensors_on_two_devices():
    """One helper, used by every kernel wrapper, names both devices."""
    a, b = torch.zeros(2), torch.zeros(2, device="meta")
    sweep._same_device("k", u=a, bh=a)
    with pytest.raises(ValueError, match="k: bh is on meta but u on cpu"):
        sweep._same_device("k", u=a, bh=b)


def test_unknown_solver_raises():
    gray, mask, depth = _case(42, 8, 9)
    cfg = dataclasses.replace(DiffusionConfig(), solver="gauss")
    with pytest.raises(ValueError, match="red_black"):
        solver.solve_level(torch.from_numpy(depth), torch.from_numpy(mask),
                           torch.from_numpy(gray), 0, 1, 3, cfg)


def test_rb_level_tables_are_made_once():
    """The red-black omegas of a level are made once per (iters, cfg) and
    kept once per device (``ops/sweep.py:device_table``); the plain level
    solve reads that copy and the array alike, bit for bit."""
    cfg = DiffusionConfig(**RB)
    om = solver.level_schedule(9, cfg)
    assert om is solver.level_schedule(9, cfg) and not om.flags.writeable
    assert np.array_equal(om, solver.rb_omegas(9, cfg)) and om.shape == (9, 2)
    dev = sweep.device_table(om, torch.device("cpu"))
    assert dev is sweep.device_table(om.copy(), "cpu") and np.array_equal(dev.numpy(), om)
    gray, mask, depth = _case(4, 23, 31)
    d, m = torch.from_numpy(depth), torch.from_numpy(mask)
    wts = edge_weights(torch.from_numpy(gray), d, 0, 1, cfg)
    want = rb_sweep.solve_level_rb_plain(d, m, wts, om)
    assert torch.equal(rb_sweep.solve_level_rb_plain(d, m, wts, dev), want)
    assert torch.equal(solver.solve_level(d, m, torch.from_numpy(gray), 0, 1, 9, cfg), want)
