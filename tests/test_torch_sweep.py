"""The port's plain level solve (what kernels K1 and K2 are held to on the
card) against the JAX package's Pallas sweep kernels, run in interpret
mode on the CPU as the JAX suite runs them.

Tolerance: atol 5e-3 gray levels, the JAX suite's own bar between its
kernels and its XLA path (tests/test_pallas.py): both sides use the (a,b,c)
form of the Chebyshev update, but XLA and torch may round a product or a
contracted FMA differently over 25 dependent sweeps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.ops import pallas_sweep as jps
from realtimedepthdiffusion_tpu_torch import ops
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import solver
from realtimedepthdiffusion_tpu_torch.core.weights import edge_weights
from realtimedepthdiffusion_tpu_torch.ops import dispatch, sweep


def _case(seed, h=49, w=67):
    r = np.random.default_rng(seed)
    gray = r.integers(0, 256, (h, w), dtype=np.uint8)
    mask = r.random((h, w)) < 0.06
    value = r.integers(0, 255, (h, w), dtype=np.uint8)
    depth = np.where(mask, value, r.random((h, w)) * 255.0).astype(np.float32)
    return gray, mask, depth


# level 1 of 1 takes the coarsest-level weights, level 0 of 1 the depth
# threshold 0; the strip kernel runs k=16 at this height, so 11 and 25
# sweeps end on a ragged block (11 of 16, 9 of 16).
@pytest.mark.parametrize("iters", [1, 11, 25])
@pytest.mark.parametrize("kernel,level", [("resident", 1), ("strips", 0)])
def test_plain_level_solve_matches_pallas(iters, kernel, level):
    gray, mask, depth = _case(iters)
    args = (jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), level, 1, iters, JConfig())
    if kernel == "resident":
        want = np.asarray(jps.solve_level_resident(*args, interpret=True))
    else:
        want = np.asarray(jps.solve_level_strips(*args, block_h=16, interpret=True))
    got = solver.solve_level(torch.from_numpy(depth), torch.from_numpy(mask),
                             torch.from_numpy(gray), level, 1, iters, DiffusionConfig())
    assert got.dtype == torch.float32
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
    assert np.array_equal(got[mask], depth[mask])


def test_early_exit_on_cluster_level_matches_pallas():
    """The Jacobi-Chebyshev early exit on a level that K2's cluster holds:
    each chunk after the first starts from a base > 0 and carries (u, prev),
    as K2 now does on the card. Against JAX's chunked early exit in
    interpret mode; every probe sits more than 5 % from the threshold, so
    both exit after the same chunk (18 of 24 sweeps, chunks of 6)."""
    gray, mask, depth = _case(21)
    assert sweep.strip_route(*depth.shape, dispatch.H100_L2_BYTES,
                             sweep.H100_MAX_CLUSTER) == "K2"
    kw = dict(early_exit=True, tolerance=0.05, residual_check_every=6)
    want = np.asarray(jps.solve_level_strips_early_exit(
        jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), 1, 2, 24, JConfig(**kw),
        interpret=True))
    log = []
    got = solver.solve_level(torch.from_numpy(depth), torch.from_numpy(mask),
                             torch.from_numpy(gray), 1, 2, 24, DiffusionConfig(**kw), log)
    assert log[0]["iters"] == 18
    assert all(abs(p - log[0]["tol"]) > 0.05 * log[0]["tol"] for p in log[0]["probes"])
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)
    assert np.array_equal(got[mask], depth[mask])


def test_plain_sweep_is_the_abc_form():
    """One sweep by hand in float32 numpy, op by op, equals sweep_plain exactly."""
    gray, mask, depth = _case(3, 13, 17)
    wts = edge_weights(torch.from_numpy(gray), torch.from_numpy(depth), 0, 1)
    a, b, c = (float(v) for v in solver.abc_schedule(12, DiffusionConfig())[11])
    prev = (np.random.default_rng(4).random(depth.shape) * 255).astype(np.float32)
    got, old = sweep.sweep_plain(
        torch.from_numpy(depth), torch.from_numpy(prev), wts.wl, wts.wr, wts.wu,
        wts.wd, wts.inv_count, torch.from_numpy(mask), a, b, c)
    u = np.pad(depth, 1)
    wl, wr, wu, wd, inv = (t.numpy() for t in wts)
    f = np.float32
    s = wl * u[1:-1, :-2]
    s = s + wr * u[1:-1, 2:]
    s = s + wu * u[:-2, 1:-1]
    s = s + wd * u[2:, 1:-1]
    r = np.clip(s * inv, f(0), f(255))
    out = f(a) * r
    out = out + f(b) * depth
    out = out + f(c) * prev
    want = np.where(mask, depth, out)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(old.numpy(), depth)


@pytest.mark.parametrize("cfg_kw", [
    {"solver": "red_black"},
    {"solver": "jacobi"},
    {"early_exit": True, "residual_check_every": 2},
    {"multigrid": "vcycle"},
])
def test_ported_configs_run(cfg_kw):
    """The solvers, the early exit and the V-cycle's config, which the port
    once refused, now solve a level."""
    gray, mask, depth = _case(5)
    got = solver.solve_level(torch.from_numpy(depth), torch.from_numpy(mask),
                             torch.from_numpy(gray), 0, 1, 3, DiffusionConfig(**cfg_kw))
    assert got.shape == depth.shape and bool(torch.isfinite(got).all())
    assert np.array_equal(got.numpy()[mask], depth[mask])


@pytest.mark.parametrize("cfg_kw,match", [
    ({"multigrid": "fmg"}, "unknown multigrid 'fmg'"),
])
def test_unported_configs_raise(cfg_kw, match):
    """Every multigrid scheme of the reference is ported; a name that is
    none of them is refused."""
    gray, mask, depth = _case(5)
    with pytest.raises(ValueError, match=match):
        solver.solve_level(torch.from_numpy(depth), torch.from_numpy(mask),
                           torch.from_numpy(gray), 0, 1, 3, DiffusionConfig(**cfg_kw))


def test_cpu_solve_launches_no_kernel():
    ops.reset_launch_counts()
    gray, mask, depth = _case(6)
    dispatch.run_sweeps(torch.from_numpy(depth), torch.from_numpy(mask),
                        edge_weights(torch.from_numpy(gray), torch.from_numpy(depth), 0, 1),
                        solver.abc_schedule(5, DiffusionConfig()))
    assert ops.launch_counts() == {"jc_sweep_tiles": 0, "jc_sweep_resident": 0,
                                   "defocus_box": 0, "rb_sweep_tiles": 0,
                                   "rb_sweep_resident": 0, "jc_sweep_fused": 0,
                                   "defocus_block": 0, "residual_probe": 0,
                                   "vc_smooth_tiles": 0, "vc_smooth_resident": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    h, w = 8, 9
    f = torch.zeros((h, w))
    m = torch.zeros((h, w), dtype=torch.uint8)
    abc = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="CUDA"):
        sweep.jc_sweep_tiles(f, f, f, f, f, f, f, m, abc, 0, 4)
    with pytest.raises(ValueError, match="CUDA"):
        sweep.jc_sweep_resident(f, f, f, f, f, m, abc, 0, 4, 1)
    with pytest.raises(ValueError, match="CUDA"):
        sweep.jc_sweep_tiles(*[f[None]] * 7, m[None], abc, 0, 4)
    with pytest.raises(ValueError, match="CUDA"):
        sweep.solve_level_cuda(f, m.bool(), edge_weights(m, f, 0, 1),
                               solver.abc_schedule(4, DiffusionConfig()))
    assert ops.launch_counts()["jc_sweep_tiles"] == 0


@pytest.mark.parametrize("h,w,max_cluster,cluster", [
    ((67, 120, 16, 16)),    # 1080p L4: 4 bands of 17 rows would hold it
    ((67, 120, 4, 4)),      # ... on a card that runs clusters of 4
    ((67, 120, 2, None)),
    ((135, 240, 16, 16)),   # 1080p L3 needs 8 CTAs
    ((135, 240, 8, 8)),
    ((135, 240, 4, None)),
    ((270, 480, 16, 16)),   # 1080p L2 (4K L3) needs 16, a non-portable size
    ((270, 480, 8, None)),
    ((270, 512, 16, 16)),   # DCI 4K L3: the widest band
    ((272, 513, 16, None)),
    ((540, 960, 16, None)),  # 1080p L1 outgrows every cluster
    ((1, 1, 16, 16)),
    ((1, 1, 1, 1)),
])
def test_resident_fit_rule(h, w, max_cluster, cluster):
    """K2's cluster: the largest the card runs, if its bands hold at most
    RESIDENT_ROWS rows of at most RESIDENT_MAX_W columns; else None."""
    assert sweep.resident_cluster(h, w, max_cluster) == cluster
    if cluster:
        assert -(-h // cluster) <= sweep.RESIDENT_ROWS and w <= sweep.RESIDENT_MAX_W
    assert sweep.resident_max_cluster(torch.device("cpu")) == sweep.H100_MAX_CLUSTER


@pytest.mark.parametrize("solver_name", ["jacobi_chebyshev", "jacobi"])
def test_level_tables_are_made_once(solver_name):
    """A level's (a, b, c) table is made once per (iters, cfg), read-only,
    and ``device_table`` keeps one copy of it per contents and device: the
    kernels' table on the card is the array the plain version reads. The
    plain level solve on that copy equals it on the array, bit for bit."""
    cfg = DiffusionConfig(solver=solver_name)
    table = solver.level_schedule(25, cfg)
    assert table is solver.level_schedule(25, cfg) and not table.flags.writeable
    assert np.array_equal(table, solver._SCHEDULES[solver_name](25, cfg))
    cpu = torch.device("cpu")
    dev = sweep.device_table(table, cpu)
    assert dev is sweep.device_table(table.copy(), cpu)
    assert dev.dtype == torch.float32 and np.array_equal(dev.numpy(), table)
    gray, mask, depth = _case(7)
    d, m = torch.from_numpy(depth), torch.from_numpy(mask)
    wts = edge_weights(torch.from_numpy(gray), d, 0, 1, cfg)
    assert torch.equal(sweep.solve_level_plain(d, m, wts, dev),
                       sweep.solve_level_plain(d, m, wts, table))
    # solve_level takes the cached table.
    assert torch.equal(solver.solve_level(d, m, torch.from_numpy(gray), 0, 1, 25, cfg),
                       sweep.solve_level_plain(d, m, wts, table))
