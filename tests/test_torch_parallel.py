"""The port's sharded multi-device step (``realtimedepthdiffusion_tpu_torch/parallel``)
on the CPU, on slot meshes whose slots all live on the CPU.

Against the port's own single-device path, which the other files hold to
JAX: a sharded level, cascade and batched step equal it bit for bit, since
the halo exchange hands each block the true neighbourhood and the block
functions repeat the single-device arithmetic. Against JAX only where the
sharded semantics themselves are at stake, since a JAX sharded call costs
seconds here: the halo exchange and the sharded defocus (exact), the block
functions against the Pallas halo-block kernels in interpret mode (the bar
``test_torch_sweep.py`` holds ``sweep_plain`` to, atol 5e-3, and exact for
the defocus), and
the early exit's iterations against JAX's, for one image and for a batch
whose exit waits for its slowest image (its residual is summed in
another order, so each probe is asserted to sit more than 5 % away from
the threshold, and the outputs agree within RMSE 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.ops import pallas_defocus as jpd
from realtimedepthdiffusion_tpu.ops import pallas_sweep as jps
from realtimedepthdiffusion_tpu.parallel import halo as jhalo
from realtimedepthdiffusion_tpu.parallel import mesh as jmesh
from realtimedepthdiffusion_tpu.parallel import sharded as jsharded
from realtimedepthdiffusion_tpu_torch import DepthPipeline, ops
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import effects as fx
from realtimedepthdiffusion_tpu_torch.core import solver
from realtimedepthdiffusion_tpu_torch.core.annotation import seed_depth
from realtimedepthdiffusion_tpu_torch.core.multigrid import build_gray_pyramid, solve_cascade
from realtimedepthdiffusion_tpu_torch.core.color import rgb_to_gray
from realtimedepthdiffusion_tpu_torch.core.weights import edge_weights
from realtimedepthdiffusion_tpu_torch.ops import defocus, rb_sweep, sweep
from realtimedepthdiffusion_tpu_torch.parallel import dryrun, halo, mesh, sharded
from tests.conftest import synthetic_pair


def _rmse(a, b):
    return float(np.sqrt(np.mean(((np.asarray(a) - np.asarray(b)) / 255.0) ** 2)))


def _level_case(seed, h, w, batch=None):
    """gray, mask, seeded depth of one level (a leading batch axis if asked)."""
    r = np.random.default_rng(seed)
    shape = (h, w) if batch is None else (batch, h, w)
    gray = torch.from_numpy(r.integers(0, 256, shape, dtype=np.uint8))
    mask = torch.from_numpy(r.random(shape) < 0.06)
    value = torch.from_numpy(r.integers(0, 255, shape, dtype=np.uint8))
    return gray, mask, seed_depth(torch.full(shape, 255.0), mask, value)


# -- the mesh ------------------------------------------------------------------


def test_factor3_equals_jax():
    for n in range(1, 17):
        assert mesh.factor3(n) == jmesh.factor3(n)
    with pytest.raises(ValueError):
        mesh.factor3(0)


def test_make_mesh_on_cpu_and_no_silent_cpu(monkeypatch):
    m = mesh.make_mesh(8, device="cpu")
    assert m.shape == {"batch": 2, "dy": 2, "dx": 2}
    assert len(m.slots) == 8 and all(d.type == "cpu" for d in m.devices.values())
    assert mesh.make_mesh(device="cpu").shape == {"batch": 1, "dy": 1, "dx": 1}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mesh.make_mesh(8, device="cuda")


@pytest.mark.parametrize("shape", [(2, 12, 20), (2, 3, 12, 20)])
def test_scatter_gather_round_trip(shape):
    m = mesh.make_mesh(8, device="cpu")
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    blocks = m.scatter(x)
    assert blocks[(1, 0, 1)].shape == (1,) + shape[1:-2] + (6, 10)
    assert torch.equal(blocks[(1, 0, 1)][0, ..., 0, 0], x[1, ..., 0, 10])
    assert torch.equal(m.gather(blocks), x)
    with pytest.raises(ValueError, match="does not split"):
        m.scatter(x[..., :11, :])


# -- the halo exchange -----------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4])
def test_halo_exchange_reassembles_global(k):
    """The extended blocks hold the global neighbourhood: the interior is the
    block, and a crop shifted by one equals a zero-filled roll."""
    m = mesh.make_mesh(8, device="cpu")
    x = torch.arange(2 * 32 * 64, dtype=torch.float32).reshape(2, 32, 64) + 1.0
    blocks = m.scatter(x)
    ext = halo.extend_with_halo(m, blocks, k)
    assert torch.equal(m.gather(halo.crop_halo(ext, k)), x)
    up = m.gather({s: e[..., k + 1:e.shape[-2] - k + 1, k:-k] for s, e in ext.items()})
    want = torch.zeros_like(x)
    want[:, :-1] = x[:, 1:]
    assert torch.equal(up, want)
    # The corners carry the diagonal neighbour's data.
    corner = ext[(0, 1, 1)][0, k - 1, k - 1]
    assert float(corner) == float(x[0, 16 - 1, 32 - 1])
    with pytest.raises(ValueError, match="does not fit"):
        halo.extend_with_halo(m, blocks, 17)


def test_halo_exchange_equals_jax():
    """One exchange of a (2, 32, 64) array on 8 slots, against JAX's
    ``extend_with_halo`` under ``shard_map`` on its 8-device mesh."""
    x = np.random.default_rng(3).random((2, 32, 64)).astype(np.float32)
    jm = jmesh.make_mesh(8)
    spec = P("batch", "dy", "dx")
    want = jax.shard_map(lambda b: jhalo.extend_with_halo(b, 4), mesh=jm, in_specs=spec,
                         out_specs=spec)(jnp.asarray(x))
    m = mesh.make_mesh(8, device="cpu")
    got = m.gather(halo.extend_with_halo(m, m.scatter(torch.from_numpy(x)), 4))
    assert np.array_equal(got.numpy(), np.asarray(want))


# -- the block functions against the Pallas halo-block kernels ---------------------


def _block(seed, h=24, w=40):
    gray, mask, depth = _level_case(seed, h, w)
    depth = torch.where(mask, depth, torch.from_numpy(
        np.random.default_rng(seed + 1).random((h, w)).astype(np.float32) * 255))
    wts = edge_weights(gray, depth, 1, 2)
    prev = torch.from_numpy(np.random.default_rng(seed + 2).random((h, w)).astype(np.float32)) * 255
    return depth, prev, wts.wr, wts.wd, wts.inv_count, mask


def test_halo_block_sweeps_plain_matches_pallas():
    u, p, bh, bv, inv, m = _block(5)
    abc = solver.abc_schedule(12, DiffusionConfig())[8:12]
    got_u, got_p = sweep.halo_block_sweeps_plain(u, p, bh, bv, inv, m, abc)
    want_u, want_p = jps.halo_block_sweeps(*(jnp.asarray(t.numpy()) for t in (u, p, bh, bv, inv, m)),
                                           abc, interpret=True)
    for got, want in ((got_u, want_u), (got_p, want_p)):
        np.testing.assert_allclose(got.numpy()[4:-4, 4:-4], np.asarray(want)[4:-4, 4:-4],
                                   atol=5e-3, rtol=0)
    assert torch.equal(sweep.halo_block_sweeps(u, p, bh, bv, inv, m, torch.from_numpy(abc))[0],
                       got_u)


@pytest.mark.parametrize("nb", [1, 3])
def test_stacked_halo_block_sweeps_equal_blocks_and_pallas(nb):
    """A stack of nb extended blocks in one call equals each block alone,
    and each block JAX's halo-block kernel in interpret mode."""
    blocks = [_block(5 + i) for i in range(nb)]
    stack = [torch.stack(t) for t in zip(*blocks)]
    abc = solver.abc_schedule(12, DiffusionConfig())[8:12]
    got_u, got_p = sweep.halo_block_sweeps_plain(*stack, abc)
    assert got_u.shape == (nb, 24, 40)
    for i, blk in enumerate(blocks):
        one_u, one_p = sweep.halo_block_sweeps_plain(*blk, abc)
        assert torch.equal(got_u[i], one_u) and torch.equal(got_p[i], one_p)
        want_u, want_p = jps.halo_block_sweeps(*(jnp.asarray(t.numpy()) for t in blk), abc,
                                               interpret=True)
        for got, want in ((got_u[i], want_u), (got_p[i], want_p)):
            np.testing.assert_allclose(got.numpy()[4:-4, 4:-4], np.asarray(want)[4:-4, 4:-4],
                                       atol=5e-3, rtol=0)
    assert torch.equal(sweep.halo_block_sweeps(*stack, torch.from_numpy(abc))[1], got_p)


def test_halo_block_rb_sweeps_plain_matches_pallas():
    """Parity 1: the block's origin has odd y + x, so its (0, 0) is black."""
    u, _, bh, bv, inv, m = _block(6)
    om = solver.rb_omegas(12, DiffusionConfig())[8:12]
    got = rb_sweep.halo_block_rb_sweeps_plain(u, bh, bv, inv, m, 1, om)
    red = rb_sweep.red_black_parity(24, 40, parity=1)
    assert not bool(red[0, 0]) and bool(red[0, 1])
    want = jps.halo_block_rb_sweeps(*(jnp.asarray(t.numpy()) for t in (u, bh, bv, inv, m, red)),
                                    om, interpret=True)
    np.testing.assert_allclose(got.numpy()[8:-8, 8:-8], np.asarray(want)[8:-8, 8:-8],
                               atol=5e-3, rtol=0)
    assert torch.equal(rb_sweep.halo_block_rb_sweeps(u, bh, bv, inv, m, 1, torch.from_numpy(om)),
                       got)


@pytest.mark.parametrize("nb", [1, 3])
def test_stacked_halo_block_rb_sweeps_equal_blocks_and_pallas(nb):
    """A stack of nb extended blocks with a parity each in one call equals
    each block alone (bit for bit), and each block JAX's red-black
    halo-block kernel in interpret mode fed that block's colour plane
    (atol 5e-3 inside the ring of 8, the bar of the single-block test)."""
    blocks = [_block(6 + i) for i in range(nb)]
    stack = [torch.stack(t) for t in zip(*blocks)]
    del stack[1]  # prev: red-black carries none
    parity = [1, 0, 1][:nb]
    om = solver.rb_omegas(12, DiffusionConfig())[8:12]
    got = rb_sweep.halo_block_rb_sweeps_plain(*stack, parity, om)
    assert got.shape == (nb, 24, 40)
    for i, (u, _, bh, bv, inv, m) in enumerate(blocks):
        one = rb_sweep.halo_block_rb_sweeps_plain(u, bh, bv, inv, m, parity[i], om)
        assert torch.equal(got[i], one)
        red = rb_sweep.red_black_parity(24, 40, parity=parity[i])
        want = jps.halo_block_rb_sweeps(
            *(jnp.asarray(t.numpy()) for t in (u, bh, bv, inv, m, red)), om, interpret=True)
        np.testing.assert_allclose(got[i].numpy()[8:-8, 8:-8], np.asarray(want)[8:-8, 8:-8],
                                   atol=5e-3, rtol=0)
    assert torch.equal(rb_sweep.halo_block_rb_sweeps(*stack, parity, torch.from_numpy(om)), got)
    with pytest.raises(ValueError, match="parity"):
        rb_sweep.halo_block_rb_sweeps_plain(*stack, parity + [0], om)


@pytest.mark.parametrize("oy,ox,hb,wb", [(40, 60, 40, 50), (0, 0, 30, 45), (80, 110, 40, 50)],
                         ids=["inner", "top-left", "bottom-right"])
def test_defocus_block_matches_pallas_and_whole_image(oy, ox, hb, wb):
    """A 120x160 image (k = 5, ring 3): each block equals JAX's block kernel
    fed the same half-widths, and the crop of the whole image's defocus."""
    r = np.random.default_rng(oy + ox)
    h, w = 120, 160
    cfg = DiffusionConfig()
    assert cfg.defocus_kernel_size(h, w) == 5
    ew = defocus.block_ring(h, w, cfg)
    rgb = torch.from_numpy(r.integers(0, 256, (h, w, 3), dtype=np.uint8))
    depth = torch.from_numpy((r.random((h, w)) * 255).astype(np.float32))
    half = defocus.defocus_half_widths(depth, h, w, cfg)[oy:oy + hb, ox:ox + wb].contiguous()
    chw = torch.nn.functional.pad(rgb.permute(2, 0, 1), (ew, ew, ew, ew))
    chw_e = chw[:, oy:oy + hb + 2 * ew, ox:ox + wb + 2 * ew].contiguous()
    got = defocus.defocus_block_sat(chw_e, half, oy, ox, h, w, cfg)
    assert got.shape == (hb, wb, 3) and got.dtype == torch.uint8
    want = jpd.defocus_block_pallas(jnp.asarray(chw_e.numpy()), jnp.asarray(half.numpy()), oy, ox,
                                    h, w, JConfig(), interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    whole = defocus.defocus_sat(rgb, depth, cfg)
    assert torch.equal(got, whole[oy:oy + hb, ox:ox + wb])
    assert torch.equal(defocus.defocus_block(chw_e, half, oy, ox, h, w, cfg), got)
    with pytest.raises(ValueError, match="ring"):
        defocus.defocus_block(chw_e[:, 1:], half, oy, ox, h, w, cfg)


# -- bit for bit against the port's single-device path --------------------------------


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("solver_name", ["jacobi_chebyshev", "red_black"])
def test_sharded_level_equals_single_device(solver_name, batch):
    """65x97 on 2x2 blocks of 33x49: block (1, 0) starts on an odd row."""
    gray, mask, depth = _level_case(11, 65, 97, batch)
    cfg = DiffusionConfig(solver=solver_name)
    m = mesh.make_mesh(8, device="cpu")
    got = sharded.solve_level_sharded(depth, mask, gray, 1, 1, 21, m, cfg, halo=4)
    images = zip(depth, mask, gray) if batch else [(depth, mask, gray)]
    want = [solver.solve_level(d, mk, g, 1, 1, 21, cfg) for d, mk, g in images]
    want = torch.stack(want) if batch else want[0]
    assert torch.equal(got, want)
    assert torch.equal(got[mask], depth[mask])


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("canvas", [True, False])
def test_sharded_jacobi_level_one_call_per_device_and_exchange(monkeypatch, batch, canvas):
    """The Jacobi-Chebyshev level runs every block of a device in one
    block-route call per exchange: ceil(21 / 4) = 6 calls on the one CPU
    device, each over a stack of all slots' blocks (4 slots of one image,
    or 8 of one); the level equals the single-device level bit for bit,
    whether the exchange goes through the whole-image canvas of one device
    or, as on several cards, strip by strip (``extend_into``)."""
    if not canvas:
        monkeypatch.setattr(sharded, "_one_device", lambda m: False)
    calls = []
    real = sharded._KERNELS.jc

    def spy(u_e, *args):
        calls.append(tuple(u_e.shape))
        return real(u_e, *args)

    monkeypatch.setattr(sharded, "_KERNELS", sharded._KERNELS._replace(jc=spy))
    gray, mask, depth = _level_case(11, 65, 97, batch)
    m = mesh.make_mesh(8, device="cpu")
    sharded.block_calls.clear()
    got = sharded.solve_level_sharded(depth, mask, gray, 1, 1, 21, m, DiffusionConfig(), halo=4)
    n_blocks = 4 if batch is None else 8
    assert calls == [(n_blocks, 33 + 8, 49 + 8)] * 6
    assert sharded.block_calls["jacobi_chebyshev"] == 6 * n_blocks
    images = zip(depth, mask, gray) if batch else [(depth, mask, gray)]
    want = [solver.solve_level(d, mk, g, 1, 1, 21, DiffusionConfig()) for d, mk, g in images]
    assert torch.equal(got, torch.stack(want) if batch else want[0])


@pytest.mark.parametrize("batch", [None, 2])
@pytest.mark.parametrize("canvas", [True, False])
def test_sharded_red_black_level_one_call_per_device_and_exchange(monkeypatch, batch, canvas):
    """The red-black level runs every block of a device in one block-route
    call per exchange: ceil(21 / 4) = 6 calls on the one CPU device, each
    over a stack of all slots' blocks behind a ring of 2k = 8, with the
    parity of each block's origin (block (1, 0) of 33x49 blocks starts on
    an odd row); a call never writes the stack it reads; the level equals
    the single-device level bit for bit, through the canvas or strip by
    strip."""
    if not canvas:
        monkeypatch.setattr(sharded, "_one_device", lambda m: False)
    calls = []
    real = sharded._KERNELS.rb

    def spy(u_e, bh, bv, inv, m_e, parity, om):
        out = real(u_e, bh, bv, inv, m_e, parity, om)
        calls.append((tuple(u_e.shape), list(parity), out.data_ptr() != u_e.data_ptr()))
        return out

    monkeypatch.setattr(sharded, "_KERNELS", sharded._KERNELS._replace(rb=spy))
    gray, mask, depth = _level_case(11, 65, 97, batch)
    cfg = DiffusionConfig(solver="red_black")
    m = mesh.make_mesh(8, device="cpu")
    sharded.block_calls.clear()
    got = sharded.solve_level_sharded(depth, mask, gray, 1, 1, 21, m, cfg, halo=4)
    n_img = 1 if batch is None else 2
    # Slots in stack order: (image, i, j) with the origin (33 i, 49 j).
    parity = [(33 * i + 49 * j) & 1 for _ in range(n_img) for i in (0, 1) for j in (0, 1)]
    assert calls == [((4 * n_img, 33 + 16, 49 + 16), parity, True)] * 6
    assert sharded.block_calls["red_black"] == 6 * 4 * n_img
    images = zip(depth, mask, gray) if batch else [(depth, mask, gray)]
    want = [solver.solve_level(d, mk, g, 1, 1, 21, cfg) for d, mk, g in images]
    assert torch.equal(got, torch.stack(want) if batch else want[0])


@pytest.mark.parametrize("h,w,solver_name", [(64, 96, "jacobi_chebyshev"),
                                             (100, 150, "jacobi_chebyshev"),
                                             (100, 150, "red_black")])
def test_sharded_cascade_equals_single_device(h, w, solver_name):
    cfg = DiffusionConfig(max_iterations=24, solver=solver_name)
    rgb, m0, v0 = synthetic_pair(h, w, 3)
    gp = build_gray_pyramid(rgb_to_gray(torch.from_numpy(rgb)), cfg)
    m0, v0 = torch.from_numpy(m0), torch.from_numpy(v0)
    st = [torch.full(g.shape, 255.0) for g in gp]
    m = mesh.make_mesh(8, device="cpu")
    assert all(sharded.level_is_sharded(m, *g.shape, solver_name, 4) for g in gp)
    got, got_state = sharded.solve_cascade_sharded(gp, m0, v0, st, m, cfg, halo=4)
    want, want_state = solve_cascade(gp, m0, v0, st, cfg)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in zip(got_state, want_state))


# -- the early exit --------------------------------------------------------------


def _exit_case():
    r = np.random.default_rng(7)
    gray = r.integers(0, 256, (64, 96), dtype=np.uint8)
    mask = np.zeros((64, 96), bool)
    mask[10:16, 20:30] = True
    mask[40:46, 60:70] = True
    depth = np.where(mask, 32.0, 255.0).astype(np.float32)
    depth[40:46, 60:70] = 200.0
    return gray, mask, depth


# Tolerances between two probes, each > 10 % away: red-black exits after 6
# chunks of 8 (48 of 64), Jacobi-Chebyshev after 3 (24 of 64).
@pytest.mark.parametrize("solver_name,metric,tol,done", [("red_black", "max", 1.5e-3, 48),
                                                         ("jacobi_chebyshev", "rms", 2.5e-5, 24)])
def test_early_exit_matches_jax(solver_name, metric, tol, done):
    gray, mask, depth = _exit_case()
    kw = dict(solver=solver_name, early_exit=True, tolerance=tol, residual_check_every=8,
              residual_metric=metric)
    log = []
    out, got_done, res = sharded.solve_level_sharded(
        torch.from_numpy(depth), torch.from_numpy(mask), torch.from_numpy(gray), 0, 2, 64,
        mesh.make_mesh(8, device="cpu"), DiffusionConfig(**kw), halo=4, return_info=True,
        exit_log=log)
    assert got_done == done and log[0]["iters"] == done and res == log[0]["probes"][-1]
    for p in log[0]["probes"]:
        assert abs(p - log[0]["tol"]) > 0.05 * log[0]["tol"], (p, log[0]["tol"])
    want, want_done, _ = jsharded.solve_level_sharded(
        jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), 0, 2, 64, jmesh.make_mesh(8),
        JConfig(backend="xla", **kw), halo=4, return_info=True)
    assert int(want_done) == done
    assert _rmse(out.numpy(), want) <= 1e-4


@pytest.mark.parametrize("solver_name", ["jacobi_chebyshev", "red_black"])
def test_early_exit_truncated_tail(solver_name):
    """20 = 3 x 6 + 2 under an unreachable tolerance: the tail runs, the
    whole budget is reported, and the output is the fixed-count one."""
    gray, mask, depth = (torch.from_numpy(a) for a in _exit_case())
    m = mesh.make_mesh(8, device="cpu")
    cfg = DiffusionConfig(solver=solver_name, early_exit=True, tolerance=1e-12,
                          residual_check_every=6)
    log = []
    out, done, res = sharded.solve_level_sharded(depth, mask, gray, 0, 2, 20, m, cfg, halo=4,
                                                 return_info=True, exit_log=log)
    assert done == 20 and len(log[0]["probes"]) == 3 and res == log[0]["probes"][-1]
    fixed = sharded.solve_level_sharded(depth, mask, gray, 0, 2, 20, m,
                                        dataclasses.replace(cfg, early_exit=False), halo=4)
    assert torch.equal(out, fixed)


def test_batched_rms_exit_waits_for_every_image():
    """A (2, 64, 96) red-black rms early exit on mesh (2, 2, 2): alone, image
    0 stops after one chunk of 16 and image 1 after four; the batch stops
    when every image is done (JAX's gate: per-image rms summed over the
    slots, then the max over the batch), at JAX's iteration."""
    def image(seed, spots):
        r = np.random.default_rng(seed)
        gray = r.integers(0, 256, (64, 96), dtype=np.uint8)
        mask = np.zeros((64, 96), bool)
        depth = np.full((64, 96), 255.0, np.float32)
        for y, x, v in spots:
            mask[y:y + 6, x:x + 10] = True
            depth[y:y + 6, x:x + 10] = v
        return gray, mask, depth

    images = [image(7, [(10, 20, 32.0), (40, 60, 200.0)]),
              image(8, [(5, 5, 0.0), (50, 80, 250.0), (30, 40, 128.0)])]
    kw = dict(solver="red_black", early_exit=True, tolerance=1.8e-3, residual_check_every=16,
              residual_metric="rms")
    cfg = DiffusionConfig(**kw)
    alone = []
    for g, mk, d in images:
        log = []
        solver.solve_level(torch.from_numpy(d), torch.from_numpy(mk), torch.from_numpy(g), 0, 2, 96,
                           cfg, log)
        alone.append(log[0]["iters"])
    assert alone == [16, 64]
    gray, mask, depth = (np.stack(a) for a in zip(*images))
    log = []
    out, done, res = sharded.solve_level_sharded(
        torch.from_numpy(depth), torch.from_numpy(mask), torch.from_numpy(gray), 0, 2, 96,
        mesh.make_mesh(8, device="cpu"), cfg, halo=4, return_info=True, exit_log=log)
    assert done == max(alone) and res == log[0]["probes"][-1]
    for p in log[0]["probes"]:
        assert abs(p - log[0]["tol"]) > 0.05 * log[0]["tol"], (p, log[0]["tol"])
    want, want_done, _ = jsharded.solve_level_sharded(
        jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), 0, 2, 96, jmesh.make_mesh(8),
        JConfig(backend="xla", **kw), halo=4, return_info=True)
    assert int(want_done) == done
    assert _rmse(out.numpy(), want) <= 1e-4


# -- the sharded defocus ----------------------------------------------------------


@pytest.mark.parametrize("aperture,thin", [(0.3, False), (0.6, True)])
def test_sharded_defocus_equals_jax(aperture, thin):
    """(2, 50, 70) on 8 slots: blocks of 25x35 against a ring of 13 (k = 25),
    and, at aperture 0.6, a ring of 26 that no block can hold, where the
    whole images are blurred instead."""
    r = np.random.default_rng(9)
    rgb = r.integers(0, 256, (2, 50, 70, 3), dtype=np.uint8)
    depth = (r.random((2, 50, 70)) * 255).astype(np.float32)
    cfg = DiffusionConfig(defocus_aperture=aperture)
    m = mesh.make_mesh(8, device="cpu")
    assert (defocus.block_ring(50, 70, cfg) > 25) == thin
    sharded.block_calls.clear()
    got = sharded.sharded_defocus(m, 50, 70, cfg)(torch.from_numpy(rgb), torch.from_numpy(depth))
    assert (sharded.block_calls["defocus"] == 0) == thin
    want = jsharded.sharded_defocus(jmesh.make_mesh(8), 50, 70, JConfig(defocus_aperture=aperture),
                                    mode="pallas_interpret")(jnp.asarray(rgb), jnp.asarray(depth))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), np.asarray(want))
    for i in range(2):
        assert torch.equal(got[i], defocus.defocus_sat(torch.from_numpy(rgb[i]),
                                                       torch.from_numpy(depth[i]), cfg))


# -- the batched step ---------------------------------------------------------------


def test_batched_step_equals_single_device():
    """64x96, a batch of 2 on 8 slots: depth, state and defocus equal the
    single-device pipeline's per image, and the scribbles stay pinned."""
    cfg = DiffusionConfig(max_iterations=40)
    m = mesh.make_mesh(8, device="cpu")
    fn, make_args = sharded.batched_step(m, 64, 96, cfg, fx.EFFECT_DEFOCUS)
    rgb, mask, value, state = make_args(2)
    ops.reset_launch_counts()
    sharded.block_calls.clear()
    depth, new_state, out = fn(rgb, mask, value, state)
    assert depth.shape == (2, 64, 96) and out.shape == (2, 64, 96, 3) and out.dtype == torch.uint8
    assert float(depth[0, 16, 24]) == 254.0  # the painted near scribble is pinned
    assert torch.equal(depth[mask], value[mask].to(torch.float32))
    assert sharded.block_calls["jacobi_chebyshev"] == 5 * 8 and sharded.block_calls["defocus"] == 8
    assert all(v == 0 for v in ops.launch_counts().values())
    pipe = DepthPipeline(64, 96, cfg, device="cpu")
    for i in range(2):
        rgb_d, gpyr = pipe.prepare_image(rgb[i])
        d, st, o = pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, mask[i], value[i],
                                         tuple(s[i] for s in state))
        assert torch.equal(depth[i], d) and torch.equal(out[i], o)
        assert all(torch.equal(a[i], b) for a, b in zip(new_state, st))
    with pytest.raises(ValueError, match="batch axis"):
        fn(rgb[:1], mask[:1], value[:1], tuple(s[:1] for s in state))


def test_plain_step_refuses_replicated_levels():
    """``plain=True`` promises that no kernel runs; a level too small to
    shard would run replicated on the kernels' routes, so it raises."""
    m = mesh.make_mesh(8, device="cpu")
    cfg = DiffusionConfig(max_iterations=8)
    assert not sharded.level_is_sharded(m, 12, 20, cfg.solver)
    fn, make_args = sharded.batched_step(m, 12, 20, cfg, fx.EFFECT_DEFOCUS, plain=True)
    with pytest.raises(ValueError, match="replicated"):
        fn(*make_args(2))


@pytest.mark.parametrize("n_slots", [4, 8])
def test_dryrun_multichip(n_slots):
    seen = dryrun.dryrun_multichip(n_slots, device="cpu")
    assert seen["iters_done red_black"] == [8, 24]
    assert seen["iters_done jacobi_chebyshev"] == [8, 24]
    assert seen["pass1"]["jacobi_chebyshev"] > 0 and seen["pass2"]["red_black"] > 0


def test_vcycle_and_jacobi_raise():
    m = mesh.make_mesh(4, device="cpu")
    # The V-cycle is ported: the step builds; only an unknown scheme and the
    # plain 'jacobi' solver are refused, the V-cycle's warm start included.
    sharded.batched_step(m, 64, 96, DiffusionConfig(multigrid="vcycle"))
    with pytest.raises(ValueError, match="unknown multigrid"):
        sharded.batched_step(m, 64, 96, DiffusionConfig(multigrid="fmg"))
    with pytest.raises(NotImplementedError, match="jacobi"):
        sharded.batched_step(m, 64, 96, DiffusionConfig(solver="jacobi"))
    with pytest.raises(NotImplementedError, match="jacobi"):
        sharded.batched_step(m, 64, 96, DiffusionConfig(solver="jacobi", multigrid="vcycle"))
    gray, mask, depth = _level_case(1, 16, 16)
    with pytest.raises(NotImplementedError, match="jacobi"):
        sharded.solve_level_sharded(depth, mask, gray, 0, 1, 4, m, DiffusionConfig(solver="jacobi"))
