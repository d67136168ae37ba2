"""The port's V-cycle (``core/multigrid.py``, ``parallel/sharded.py``) against
the JAX package on the CPU.

The V-cycle's polish is plain ops on both sides. Its damping factors are
full reductions, which XLA and torch sum in different orders, so the
schemes are held to depth RMSE <= 1e-3 on [0, 1] (tests/test_golden.py),
with the scribbles exact; the pointwise pieces to allclose 1e-5. JAX runs
at ``backend="xla", fast_start=False``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.core import multigrid as jmg
from realtimedepthdiffusion_tpu.core import solver as jsolver
from realtimedepthdiffusion_tpu.core import weights as jweights
from realtimedepthdiffusion_tpu.pipeline import DepthPipeline as JPipeline
from realtimedepthdiffusion_tpu_torch import DepthPipeline, interop, ops
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import multigrid as tmg
from realtimedepthdiffusion_tpu_torch.core import solver as tsolver
from realtimedepthdiffusion_tpu_torch.core.weights import edge_weights
from realtimedepthdiffusion_tpu_torch.ops import dispatch
from realtimedepthdiffusion_tpu_torch.parallel import mesh, sharded
from tests.conftest import synthetic_pair

SHAPES = [(96, 128), (181, 243)]
KW = {"max_iterations": 100}


def _rmse(a, b):
    return float(np.sqrt(np.mean(((np.asarray(a) - np.asarray(b)) / 255.0) ** 2)))


def _jcfg(**kw):
    return JConfig(backend="xla", fast_start=False, **KW, **kw)


@pytest.mark.parametrize("h,w", [(7, 9), (33, 41), (64, 48)])
def test_jacobi_sweep_raw_matches_jax(h, w):
    r = np.random.default_rng(h * w)
    gray = r.integers(0, 256, (h, w), dtype=np.uint8)
    depth = (r.random((h, w)) * 255).astype(np.float32)
    e = r.normal(0.0, 40.0, (h, w)).astype(np.float32)  # an error field: any sign
    want = np.asarray(jsolver.jacobi_sweep_raw(
        jnp.asarray(e), jweights.edge_weights(jnp.asarray(gray), jnp.asarray(depth), 0, 2,
                                              JConfig())))
    wts = edge_weights(torch.from_numpy(gray), torch.from_numpy(depth), 0, 2, DiffusionConfig())
    got = tsolver.jacobi_sweep_raw(torch.from_numpy(e), wts).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got.min() < 0.0  # unclipped, where jacobi_sweep clips
    assert float(tsolver.jacobi_sweep(torch.from_numpy(e), wts).min()) >= 0.0


@pytest.mark.parametrize("h,w", [(7, 9), (33, 41), (64, 48), (135, 240)])
def test_restrict_matches_jax(h, w):
    r = np.random.default_rng(h + w)
    x = r.normal(0.0, 100.0, (h, w)).astype(np.float32)
    out = (h // 2, w // 2)
    want = np.asarray(jmg._restrict(jnp.asarray(x), out))
    got = tmg._restrict(torch.from_numpy(x), out)
    assert tuple(got.shape) == out
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def vcycle_run(request):
    """JAX's warm cascade, its polish of it, and its whole V-cycle."""
    h, w = request.param
    rgb, mask, value = synthetic_pair(h, w)
    cfg = _jcfg(multigrid="vcycle")
    pipe = JPipeline(h, w, cfg)
    _, gpyr = pipe.prepare_image(rgb)
    m, v = jnp.asarray(mask), jnp.asarray(value)
    _, warm = jmg.solve_cascade(gpyr, m, v, pipe.initial_state(), cfg)
    polished = jmg.vcycle_polish(gpyr, m, v, warm[0], cfg)
    depth, state = pipe.solve(gpyr, m, v, pipe.initial_state())
    return {"hw": (h, w), "rgb": rgb, "mask": mask, "value": value,
            "warm": tuple(np.asarray(s) for s in warm), "polished": np.asarray(polished),
            "depth": np.asarray(depth), "state": tuple(np.asarray(s) for s in state)}


def _port_inputs(run, cfg):
    pipe = DepthPipeline(*run["hw"], cfg, device="cpu")
    _, gpyr = pipe.prepare_image(run["rgb"])
    m, v = interop.annotation_from_numpy(run["mask"], run["value"], "cpu")
    return pipe, gpyr, m, v


def test_vcycle_polish_matches_jax(vcycle_run):
    """The polish alone, from JAX's own warm state."""
    cfg = DiffusionConfig(multigrid="vcycle", **KW)
    _, gpyr, m, v = _port_inputs(vcycle_run, cfg)
    warm0 = interop.state_from_numpy(vcycle_run["warm"], "cpu")[0]
    before = warm0.clone()
    got = tmg.vcycle_polish(gpyr, m, v, warm0, cfg).numpy()
    assert _rmse(got, vcycle_run["polished"]) <= 1e-3
    mask, value = vcycle_run["mask"], vcycle_run["value"]
    assert np.array_equal(got[mask], value[mask].astype(np.float32))
    assert got.min() >= 0.0 and got.max() <= 255.0
    assert torch.equal(warm0, before)  # the caller's tensor is not touched
    # The polish does move the warm solution, so the comparison means something.
    assert _rmse(got, vcycle_run["warm"][0]) > 1e-5


def test_solve_vcycle_matches_jax(vcycle_run):
    cfg = DiffusionConfig(multigrid="vcycle", **KW)
    pipe, gpyr, m, v = _port_inputs(vcycle_run, cfg)
    ops.reset_launch_counts()
    depth, state = tmg.solve_vcycle(gpyr, m, v, pipe.initial_state(), cfg)
    d = depth.numpy()
    assert _rmse(d, vcycle_run["depth"]) <= 1e-3
    mask, value = vcycle_run["mask"], vcycle_run["value"]
    assert np.array_equal(d[mask], value[mask].astype(np.float32))
    assert state[0] is depth and len(state) == len(vcycle_run["state"])
    for s, js in zip(state[1:], vcycle_run["state"][1:]):  # the warm cascade's levels
        assert _rmse(s.numpy(), js) <= 1e-3
    assert not any(ops.launch_counts().values())  # CPU tensors launch no kernel


def test_vcycle_warm_config():
    cfg = DiffusionConfig(multigrid="vcycle", max_iterations=1000, vcycle_warm_fraction=0.25)
    warm = tmg.vcycle_warm_config(cfg)
    assert (warm.max_iterations, warm.multigrid) == (250, "cascadic")
    dispatch.check_supported(warm)
    small = tmg.vcycle_warm_config(dataclasses.replace(cfg, max_iterations=20))
    assert small.max_iterations == 4 * cfg.chebyshev_s
    assert dataclasses.replace(warm, max_iterations=1000, multigrid="vcycle") == cfg


@pytest.mark.parametrize("multigrid", ["cascadic", "vcycle"])
def test_pipeline_picks_the_scheme(vcycle_run, multigrid):
    """``DepthPipeline.solve`` and ``solve_and_effect`` run the scheme that
    ``cfg.multigrid`` names: each equals that function called directly, and
    the two schemes differ."""
    from realtimedepthdiffusion_tpu_torch.core import effects as fx

    cfg = DiffusionConfig(multigrid=multigrid, **KW)
    pipe, gpyr, m, v = _port_inputs(vcycle_run, cfg)
    scheme = tmg.solve_vcycle if multigrid == "vcycle" else tmg.solve_cascade
    want, _ = scheme(gpyr, m, v, pipe.initial_state(), cfg)
    got, _ = pipe.solve(gpyr, m, v, pipe.initial_state())
    assert torch.equal(got, want)
    rgb_d, _ = pipe.prepare_image(vcycle_run["rgb"])
    d2, _, out = pipe.solve_and_effect(fx.EFFECT_HAZE, gpyr, rgb_d, m, v, pipe.initial_state())
    assert torch.equal(d2, want) and out.dtype == torch.uint8
    other, _ = (tmg.solve_cascade if multigrid == "vcycle" else tmg.solve_vcycle)(
        gpyr, m, v, pipe.initial_state(), cfg)
    assert not torch.equal(got, other)


def test_unknown_multigrid_is_refused():
    with pytest.raises(ValueError, match="unknown multigrid 'wcycle'"):
        DepthPipeline(64, 64, DiffusionConfig(multigrid="wcycle"), device="cpu")


@pytest.mark.parametrize("batch", [None, 2])
def test_solve_vcycle_sharded_matches_jax(vcycle_run, batch):
    """The sharded V-cycle on a CPU slot mesh of 4 against JAX's
    single-device ``solve_vcycle``, for one image and for a batch; its warm
    start ran through the halo-block route."""
    cfg = DiffusionConfig(multigrid="vcycle", **KW)
    pipe, gpyr, m, v = _port_inputs(vcycle_run, cfg)
    state = pipe.initial_state()
    if batch:
        gpyr = tuple(torch.stack([g] * batch) for g in gpyr)
        m, v = torch.stack([m] * batch), torch.stack([v] * batch)
        state = tuple(torch.stack([s] * batch) for s in state)
    sharded.block_calls.clear()
    depth, new_state = sharded.solve_vcycle_sharded(gpyr, m, v, state,
                                                    mesh.make_mesh(4, device="cpu"), cfg)
    assert sharded.block_calls["jacobi_chebyshev"] > 0
    assert new_state[0] is depth
    mask, value = vcycle_run["mask"], vcycle_run["value"]
    for d in (depth if batch else depth[None]):
        d = d.numpy()
        assert _rmse(d, vcycle_run["depth"]) <= 1e-3
        assert np.array_equal(d[mask], value[mask].astype(np.float32))


def test_batched_step_runs_the_vcycle():
    """``batched_step`` under ``multigrid="vcycle"`` equals the
    single-device V-cycle per image (the sharded warm start equals the
    single-device cascade bit for bit, and the polish is the same code)."""
    from realtimedepthdiffusion_tpu_torch.core import effects as fx

    cfg = DiffusionConfig(multigrid="vcycle", max_iterations=40)
    h, w = 64, 96
    fn, make_args = sharded.batched_step(mesh.make_mesh(4, device="cpu"), h, w, cfg,
                                         fx.EFFECT_DEFOCUS)
    rgb, m, v, state = make_args(2)
    depth, _, out = fn(rgb, m, v, state)
    pipe = DepthPipeline(h, w, cfg, device="cpu")
    for n in range(2):
        rgb_d, gpyr = pipe.prepare_image(rgb[n])
        want, _, want_out = pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, m[n], v[n],
                                                  tuple(s[n] for s in state))
        assert torch.equal(depth[n], want) and torch.equal(out[n], want_out)
    cascade, _, _ = sharded.batched_step(mesh.make_mesh(4, device="cpu"), h, w,
                                         dataclasses.replace(cfg, multigrid="cascadic"),
                                         fx.EFFECT_DEFOCUS)[0](rgb, m, v, state)
    assert not torch.equal(depth, cascade)
