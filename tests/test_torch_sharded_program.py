"""The sharded step as one program (``realtimedepthdiffusion_tpu_torch/parallel/sharded.py``)
on the CPU: the early exit decided on the device and ``batched_step``'s routing.

On a card every chunk of a sharded level is issued and a device flag,
set by the probe after each full chunk, turns the later chunks and the
truncated tail into no-ops, as JAX's ``lax.while_loop`` and ``lax.cond``
decide them on the device. On the CPU the loop reads the flag and stops
issuing chunks; patching ``solver._host_loop`` runs the card's loop here,
on the block functions' plain versions (``ops/sweep.py:unless_stopped``).
It must give JAX's iterations (every probe more than 5 % from the
threshold, as ``tests/test_torch_parallel.py`` picks them, so that another
summation order cannot move the exit), outputs within RMSE 1e-4 of JAX's,
and the host loop's bits and exit log. A step under it reads nothing back
to the host. The CUDA graphs themselves are tested on the card
(``tests/test_torch_cuda.py``).
"""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.parallel import mesh as jmesh
from realtimedepthdiffusion_tpu.parallel import sharded as jsharded
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import effects as fx
from realtimedepthdiffusion_tpu_torch.core import solver
from realtimedepthdiffusion_tpu_torch.ops import rb_sweep, sweep
from realtimedepthdiffusion_tpu_torch.parallel import mesh, sharded

ITERS, CHUNK = 40, 8

# (solver, metric) -> (tolerance, iterations at the exit) for the single
# image, each tolerance between two probes of the case.
SINGLE = {
    ("jacobi_chebyshev", "max"): (2e-4, 24),
    ("jacobi_chebyshev", "rms"): (2.5e-5, 24),
    ("red_black", "max"): (2.3e-3, 16),
    ("red_black", "rms"): (4.5e-4, 8),
}
# A batch of two images on mesh (2, 2, 2): alone, image 0 exits after the
# first chunk and image 1 after the third; the batch waits for image 1.
BATCH = {
    ("jacobi_chebyshev", "rms"): 1e-4,
    ("red_black", "max"): 1.2e-2,
}


def _rmse(a, b):
    return float(np.sqrt(np.mean(((np.asarray(a) - np.asarray(b)) / 255.0) ** 2)))


def _single():
    r = np.random.default_rng(7)
    gray = r.integers(0, 256, (64, 96), dtype=np.uint8)
    mask = np.zeros((64, 96), bool)
    mask[10:16, 20:30] = True
    mask[40:46, 60:70] = True
    depth = np.where(mask, 32.0, 255.0).astype(np.float32)
    depth[40:46, 60:70] = 200.0
    return gray, mask, depth


def _image(seed, spots):
    r = np.random.default_rng(seed)
    gray = r.integers(0, 256, (64, 96), dtype=np.uint8)
    mask = np.zeros((64, 96), bool)
    depth = np.full((64, 96), 255.0, np.float32)
    for y, x, v in spots:
        mask[y:y + 6, x:x + 10] = True
        depth[y:y + 6, x:x + 10] = v
    return gray, mask, depth


def _batch():
    images = [_image(7, [(10, 20, 32.0), (40, 60, 200.0)]),
              _image(8, [(5, 5, 0.0), (50, 80, 250.0), (30, 40, 128.0)])]
    return images, tuple(np.stack(a) for a in zip(*images))


def _kw(solver_name, metric, tol):
    return dict(solver=solver_name, early_exit=True, tolerance=tol, residual_check_every=CHUNK,
                residual_metric=metric)


@functools.lru_cache(maxsize=None)
def _jax(solver_name, metric, tol, batched):
    """JAX's sharded level (iterations done, output), once per case."""
    gray, mask, depth = _batch()[1] if batched else _single()
    out, done, _ = jsharded.solve_level_sharded(
        jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), 0, 2, ITERS,
        jmesh.make_mesh(8), JConfig(backend="xla", **_kw(solver_name, metric, tol)), halo=4,
        return_info=True)
    return int(done), np.asarray(out)


def _port(case, cfg, iters, monkeypatch, card_loop):
    """The port's sharded level on mesh (2, 2, 2): (out, iters_done, probe,
    exit log), the card's loop where ``card_loop``."""
    gray, mask, depth = (torch.from_numpy(a) for a in case)
    log = []
    with monkeypatch.context() as mp:
        if card_loop:
            mp.setattr(solver, "_host_loop", lambda device: False)
        out, done, res = sharded.solve_level_sharded(
            depth, mask, gray, 0, 2, iters, mesh.make_mesh(8, device="cpu"), cfg, halo=4,
            return_info=True, exit_log=log)
    return out, done, res, log


def _same_run(a, b):
    """Two runs of ``_port`` that must agree bit for bit, exit log included."""
    assert torch.equal(a[0], b[0])
    assert a[1:] == b[1:]


def _clear_of(log):
    for p in log[0]["probes"]:
        assert abs(p - log[0]["tol"]) > 0.05 * log[0]["tol"], (p, log[0]["tol"])


# -- the card's loop against JAX and the host loop ------------------------------------


@pytest.mark.parametrize("solver_name,metric", list(SINGLE))
def test_card_loop_matches_jax_and_host_loop(solver_name, metric, monkeypatch):
    tol, want = SINGLE[(solver_name, metric)]
    cfg = DiffusionConfig(**_kw(solver_name, metric, tol))
    card = _port(_single(), cfg, ITERS, monkeypatch, card_loop=True)
    _same_run(card, _port(_single(), cfg, ITERS, monkeypatch, card_loop=False))
    out, done, res, log = card
    assert done == want == log[0]["iters"] and len(log[0]["probes"]) == want // CHUNK
    assert res == log[0]["probes"][-1] < log[0]["tol"]
    assert set(log[0]) == {"shape", "cap", "tol", "probe", "iters", "probes"} and log[0]["cap"] == ITERS
    _clear_of(log)
    jax_done, jax_out = _jax(solver_name, metric, tol, False)
    assert jax_done == want
    assert _rmse(out.numpy(), jax_out) <= 1e-4


@pytest.mark.parametrize("solver_name,metric", list(BATCH))
def test_card_loop_batch_waits_for_every_image(solver_name, metric, monkeypatch):
    """Each image alone exits at 8 and 24 iterations; the batch on the card's
    loop runs 24, JAX's count, with the host loop's bits."""
    tol = BATCH[(solver_name, metric)]
    cfg = DiffusionConfig(**_kw(solver_name, metric, tol))
    images, batch = _batch()
    alone = []
    for g, mk, d in images:
        log = []
        solver.solve_level(torch.from_numpy(d), torch.from_numpy(mk), torch.from_numpy(g), 0, 2,
                           ITERS, cfg, log)
        alone.append(log[0]["iters"])
    assert alone == [8, 24]
    card = _port(batch, cfg, ITERS, monkeypatch, card_loop=True)
    _same_run(card, _port(batch, cfg, ITERS, monkeypatch, card_loop=False))
    out, done, _, log = card
    assert done == max(alone) == log[0]["iters"]
    _clear_of(log)
    jax_done, jax_out = _jax(solver_name, metric, tol, True)
    assert jax_done == done
    assert _rmse(out.numpy(), jax_out) <= 1e-4


@pytest.mark.parametrize("solver_name", ["jacobi_chebyshev", "red_black"])
@pytest.mark.parametrize("tol,done,probes", [(1e-12, 20, 3), (0.9, 6, 1)],
                         ids=["tail-runs", "exit-first"])
def test_card_loop_truncated_tail(solver_name, tol, done, probes, monkeypatch):
    """20 = 3 x 6 + 2. Under an unreachable tolerance the card's loop runs
    the tail, reports the whole budget and gives the fixed-count output;
    under one every residual passes it exits at the first probe, and the
    tail, issued, leaves the 6 iterations' output. JAX's ``ran_tail =
    (res >= tol) & (rem > 0)``, and the host loop's bits, either way."""
    cfg = DiffusionConfig(solver=solver_name, early_exit=True, tolerance=tol,
                          residual_check_every=6)
    card = _port(_single(), cfg, 20, monkeypatch, card_loop=True)
    _same_run(card, _port(_single(), cfg, 20, monkeypatch, card_loop=False))
    out, got_done, res, log = card
    assert got_done == done and len(log[0]["probes"]) == probes and res == log[0]["probes"][-1]
    fixed = _port(_single(), dataclasses.replace(cfg, early_exit=False), done, monkeypatch,
                  card_loop=False)
    assert torch.equal(out, fixed[0]) and fixed[1] == done


# -- the block functions under the flag --------------------------------------------------


@pytest.mark.parametrize("route", ["jc", "rb"])
def test_stopped_block_chunk_is_identity(route):
    """A chunk of the halo-block functions with the flag set hands back its
    stack of extended blocks as it came; with the flag clear it is the
    chunk without a flag."""
    r = np.random.default_rng(3)
    shape = (4, 24, 32)
    u, p = (torch.from_numpy((r.random(shape) * 255).astype(np.float32)) for _ in range(2))
    bh, bv = (torch.from_numpy(r.random(shape).astype(np.float32) * 0.3) for _ in range(2))
    inv = torch.from_numpy(1.0 / (0.1 + r.random(shape).astype(np.float32)))
    m = torch.from_numpy((r.random(shape) < 0.05).astype(np.uint8))
    flag = lambda v: torch.full((), v, dtype=torch.int32)  # noqa: E731
    if route == "jc":
        abc = torch.from_numpy(solver.abc_schedule(12, DiffusionConfig())[4:])
        run = lambda stop=None: sweep.halo_block_sweeps(u, p, bh, bv, inv, m, abc,  # noqa: E731
                                                        stop=stop)
        held = (u, p)
    else:
        om = torch.from_numpy(solver.rb_omegas(12, DiffusionConfig())[4:])
        run = lambda stop=None: (rb_sweep.halo_block_rb_sweeps(  # noqa: E731
            u, bh, bv, inv, m, [0, 1, 1, 0], om, stop=stop),)
        held = (u,)
    moved, stopped, clear = run(), run(flag(1)), run(flag(0))
    assert all(torch.equal(a, b) for a, b in zip(stopped, held))
    assert all(torch.equal(a, b) for a, b in zip(clear, moved))
    assert not torch.equal(moved[0], u)


# -- the step -------------------------------------------------------------------------------


def _step_case(solver_name):
    """A 96x128 step of 2 on mesh (2, 2, 2) with a halo of 16: red-black's
    32-wide exchange shards level 0 (blocks of 48x64) and replicates level
    1 (24x32); Jacobi-Chebyshev shards both. A level of each exits early."""
    cfg = DiffusionConfig(max_iterations=40, solver=solver_name, early_exit=True,
                          tolerance=2e-3, residual_check_every=8)
    fn, make_args = sharded.batched_step(mesh.make_mesh(8, device="cpu"), 96, 128, cfg,
                                         fx.EFFECT_DEFOCUS, halo=16)
    return fn, make_args(2)


@pytest.mark.parametrize("solver_name", ["jacobi_chebyshev", "red_black"])
def test_step_reads_nothing_on_the_host(solver_name, monkeypatch):
    """Under the card's loop a ``batched_step`` call (sharded and replicated
    levels, each with its early exit, and the sharded defocus) makes no
    ``.item()``, ``.tolist()`` or ``bool()`` of a tensor, as a CUDA graph
    of it needs; it equals the host loop's step. On the CPU the step keeps
    no program."""
    fn, args = _step_case(solver_name)
    want = fn(*args)

    def refuse(self, *a, **k):
        raise AssertionError("a host read inside the step")

    with monkeypatch.context() as mp:
        mp.setattr(solver, "_host_loop", lambda device: False)
        for name in ("item", "tolist", "__bool__"):
            mp.setattr(torch.Tensor, name, refuse)
        got = fn(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert fn.programs == {}


def test_read_exit_log_fills_sharded_entries(monkeypatch):
    """The card's loop leaves every level's counts on the device, sharded
    levels in the single-device form; ``read_exit_log`` fills them in once,
    to the host loop's log (which ``fn`` reads after the step)."""
    fn, args = _step_case("red_black")
    want = []
    fn(*args, want)
    log = []
    with monkeypatch.context() as mp:
        mp.setattr(solver, "_host_loop", lambda device: False)
        fn.eager(*args, log)
    assert all(set(e) == {"shape", "cap", "tol", "probe", "_device"} for e in log)
    m = mesh.make_mesh(8, device="cpu")
    routes = [sharded.level_is_sharded(m, *e["shape"], "red_black", 16) for e in log]
    assert any(routes) and not all(routes)  # both kinds of level
    assert solver.read_exit_log(log) == want
    assert all(set(e) == {"shape", "cap", "tol", "probe", "iters", "probes"} for e in log)
    assert any(e["iters"] < e["cap"] for e in log)


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("one_device", [True, False])
@pytest.mark.parametrize("plain", [True, False])
def test_step_route_truth_table(device_type, one_device, plain):
    """A CUDA graph per signature only on a card holding every slot, on the
    kernels; every other step runs eagerly."""
    want = device_type == "cuda" and one_device and not plain
    assert sharded.step_captures(device_type, one_device, plain) is want
