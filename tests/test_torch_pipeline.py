"""The port's slice end to end against the JAX package on the CPU: one
``solve_and_effect(EFFECT_DEFOCUS, ...)`` update, a JAX state carried into a
second port solve, the defocus on a shared depth, and the port importing
with JAX, PIL and cv2 blocked.

Depth bar: RMSE <= 1e-3 on [0, 1] (tests/test_golden.py). The port takes
the (a,b,c) form of the Chebyshev update and the JAX xla backend its
omega form, so the two agree to rounding, not bit for bit."""

import argparse
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.core import effects as jfx
from realtimedepthdiffusion_tpu.pipeline import DepthPipeline as JPipeline
from realtimedepthdiffusion_tpu_torch import DepthPipeline, get_pipeline, interop, ops
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import effects as tfx
from tests.conftest import synthetic_pair

H, W = 181, 243  # 3 levels, odd sizes at every level
FAST_HW = (200, 260)  # 3 levels; see fast_run


def _rmse(a, b):
    return float(np.sqrt(np.mean(((np.asarray(a) - np.asarray(b)) / 255.0) ** 2)))


@pytest.fixture(scope="module")
def jax_run():
    """Two JAX updates: a cold one, then a warm one with an extra scribble."""
    rgb, mask, value = synthetic_pair(H, W)
    mask2, value2 = mask.copy(), value.copy()
    mask2[20:30, 200:215] = True
    value2[20:30, 200:215] = 96
    pipe = JPipeline(H, W, JConfig(backend="xla", fast_start=False))
    rgb_d, gpyr = pipe.prepare_image(rgb)
    d1, s1, o1 = pipe.solve_and_effect(jfx.EFFECT_DEFOCUS, gpyr, rgb_d, jnp.asarray(mask),
                                       jnp.asarray(value), pipe.initial_state())
    s1_np = tuple(np.asarray(s) for s in s1)  # the next call donates s1
    d2, _, o2 = pipe.solve_and_effect(jfx.EFFECT_DEFOCUS, gpyr, rgb_d, jnp.asarray(mask2),
                                      jnp.asarray(value2), s1)
    return {
        "rgb": rgb, "mask": mask, "value": value, "mask2": mask2, "value2": value2,
        "gpyr": tuple(np.asarray(g) for g in gpyr), "d1": np.asarray(d1), "s1": s1_np,
        "o1": np.asarray(o1), "d2": np.asarray(d2), "o2": np.asarray(o2),
    }


def _port_update(pipe, rgb, mask, value, state):
    rgb_d, gpyr = pipe.prepare_image(rgb)
    m, v = interop.annotation_from_numpy(mask, value, "cpu")
    return pipe.solve_and_effect(tfx.EFFECT_DEFOCUS, gpyr, rgb_d, m, v, state), gpyr


def test_slice_matches_jax(jax_run):
    ops.reset_launch_counts()
    pipe = DepthPipeline(H, W, DiffusionConfig(), device="cpu")
    (depth, state, out), gpyr = _port_update(pipe, jax_run["rgb"], jax_run["mask"],
                                            jax_run["value"], pipe.initial_state())
    assert [tuple(g.shape) for g in gpyr] == [g.shape for g in jax_run["gpyr"]]
    for g, jg in zip(interop.gray_pyramid_to_numpy(gpyr), jax_run["gpyr"]):
        assert np.array_equal(g, jg)
    d = depth.numpy()
    assert _rmse(d, jax_run["d1"]) <= 1e-3
    mask, value = jax_run["mask"], jax_run["value"]
    assert np.array_equal(d[mask], value[mask].astype(np.float32))
    assert out.dtype == torch.uint8 and tuple(out.shape) == (H, W, 3)
    assert len(state) == 3 and all(s.dtype == torch.float32 for s in state)
    assert ops.launch_counts() == {"jc_sweep_tiles": 0, "jc_sweep_resident": 0,
                                   "defocus_box": 0, "rb_sweep_tiles": 0,
                                   "rb_sweep_resident": 0, "jc_sweep_fused": 0,
                                   "defocus_block": 0, "residual_probe": 0,
                                   "vc_smooth_tiles": 0, "vc_smooth_resident": 0}


def test_jax_state_carried_into_port(jax_run):
    """The JAX state after one update, carried over, warm-starts the port's
    second update (with an added scribble) to the JAX second update."""
    pipe = DepthPipeline(H, W, DiffusionConfig(), device="cpu")
    state = interop.state_from_numpy(jax_run["s1"], "cpu")
    (depth, new_state, _), _ = _port_update(pipe, jax_run["rgb"], jax_run["mask2"],
                                           jax_run["value2"], state)
    d = depth.numpy()
    assert _rmse(d, jax_run["d2"]) <= 1e-3
    mask, value = jax_run["mask2"], jax_run["value2"]
    assert np.array_equal(d[mask], value[mask].astype(np.float32))
    back = interop.state_to_numpy(new_state)
    assert [b.shape for b in back] == [s.shape for s in jax_run["s1"]]


def test_interop_round_trips(jax_run):
    gpyr = interop.gray_pyramid_from_numpy(jax_run["gpyr"], "cpu")
    assert all(g.dtype == torch.uint8 for g in gpyr)
    for a, b in zip(interop.gray_pyramid_to_numpy(gpyr), jax_run["gpyr"]):
        assert np.array_equal(a, b)
    m, v = interop.annotation_from_numpy(jax_run["mask"], jax_run["value"], "cpu")
    assert m.dtype == torch.bool and v.dtype == torch.uint8
    m2, v2 = interop.annotation_to_numpy(m, v)
    assert np.array_equal(m2, jax_run["mask"]) and np.array_equal(v2, jax_run["value"])
    state = interop.state_from_numpy(jax_run["s1"], "cpu")
    for a, b in zip(interop.state_to_numpy(state), jax_run["s1"]):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_defocus_equal_on_shared_depth(jax_run):
    """Given the same clipped depth, the port's defocus equals the JAX
    pipeline's fused effect exactly."""
    clipped = np.clip(jax_run["d1"], 0.0, 255.0)
    pipe = DepthPipeline(H, W, DiffusionConfig(), device="cpu")
    rgb_d, gpyr = pipe.prepare_image(jax_run["rgb"])
    got = pipe.effect(tfx.EFFECT_DEFOCUS, rgb_d, gpyr[0], torch.from_numpy(clipped)).numpy()
    assert np.array_equal(got, jax_run["o1"])


def test_depth_u8_rounds_half_to_even():
    pipe = get_pipeline(4, 4, DiffusionConfig(), device="cpu")
    d = torch.tensor([[-3.0, 0.5, 1.5, 2.5], [254.5, 255.4, 300.0, 127.49]])
    got = pipe.depth_u8(d)
    want = np.clip(np.rint(d.numpy()), 0, 255).astype(np.uint8)
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    assert get_pipeline(4, 4, DiffusionConfig(), device="cpu") is pipe
    with pytest.raises(TypeError):
        DepthPipeline(4, 4, DiffusionConfig())  # the device is never implied


def test_port_imports_without_jax_pil_cv2():
    """The port, a small solve, a fast-profile solve, a sharded batched
    step on a CPU slot mesh, the facade with a V-cycle and an incremental
    re-solve, the oracle, the timer and a PNG written and read back run
    with jax, PIL and cv2 unimportable."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "PIL", "cv2", "realtimedepthdiffusion_tpu"):
            sys.modules[name] = None
        import numpy as np, torch
        import realtimedepthdiffusion_tpu_torch as rt
        from realtimedepthdiffusion_tpu_torch.core import effects as fx
        r = np.random.default_rng(0)
        h, w = 47, 61
        rgb = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
        mask = np.zeros((h, w), bool); mask[10:14, 10:20] = True
        value = np.zeros((h, w), np.uint8); value[10:14, 10:20] = 64
        pipe = rt.DepthPipeline(h, w, rt.DiffusionConfig(max_iterations=40), device="cpu")
        rgb_d, g = pipe.prepare_image(rgb)
        d, s, out = pipe.solve_and_effect(fx.EFFECT_DEFOCUS, g, rgb_d, torch.from_numpy(mask),
                                          torch.from_numpy(value), pipe.initial_state())
        assert bool(torch.isfinite(d).all()) and bool((d[torch.from_numpy(mask)] == 64).all())
        from argparse import Namespace
        from realtimedepthdiffusion_tpu_torch import flags
        kw = flags.resolve_solver_flags(Namespace(
            backend="auto", solver=None, tolerance=None, residual_metric=None, rb_rho=None,
            rb_plain=False, defocus_quality=None, defocus_stride=None, profile="fast"), None)
        fast = rt.DepthPipeline(h, w, rt.DiffusionConfig(**kw), device="cpu")
        d, s = fast.solve(g, torch.from_numpy(mask), torch.from_numpy(value),
                          fast.initial_state())
        assert bool((d[torch.from_numpy(mask)] == 64).all()) and float(d.max()) <= 255.0
        from realtimedepthdiffusion_tpu_torch.parallel import mesh as pmesh, sharded
        fn, make_args = sharded.batched_step(pmesh.make_mesh(4, device="cpu"), 32, 48,
                                             rt.DiffusionConfig(max_iterations=16),
                                             fx.EFFECT_DEFOCUS)
        d, s, out = fn(*make_args(2))
        assert tuple(d.shape) == (2, 32, 48) and out.dtype == torch.uint8
        assert sharded.block_calls["jacobi_chebyshev"] > 0 and sharded.block_calls["defocus"] > 0
        import os, tempfile
        from realtimedepthdiffusion_tpu_torch import io, models, oracle
        from realtimedepthdiffusion_tpu_torch.core import incremental
        from realtimedepthdiffusion_tpu_torch.utils import timing
        assert io.codec() == "zlib"
        timer = timing.StageTimer(device="cpu")
        with timer.stage("facade"):
            model = models.VCycle(device="cpu", max_iterations=16, vcycle_coarse_iters=8)
            d, art, s = model.solve_and_render(rgb, mask, value, "b")
        assert timer.counts["facade"] == 1 and "facade" in timer.report()
        assert d.shape == (h, w) and art.dtype == np.uint8 and float(d.max()) <= 255.0
        live = models.ChebyshevCascade(device="cpu", max_iterations=16, incremental_window=16)
        d, s = live.solve_with_state(rgb, mask, value)
        mask[30:33, 40:44], value[30:33, 40:44] = True, 192
        d2, s2 = live.solve_incremental(rgb, mask, value, s, (31, 42))
        assert bool((d2[mask] == value[mask]).all()) and s2[0].shape == (h, w)
        assert incremental.clamp_origin(-3, 70, 16, 16, h, w) == (0, w - 16)
        want, _ = oracle.numpy_ref.solve_pyramid(
            oracle.numpy_ref.rgb_to_gray(rgb), mask, value, None, live.cfg)
        assert float(np.sqrt(np.mean(((live.solve(rgb, mask, value) - want) / 255.0) ** 2))) <= 1e-3
        tmp = tempfile.mkdtemp()
        u16 = io.depth_to_u16(d2)
        io.imwrite(os.path.join(tmp, "depth16.png"), u16, png_level=1)
        io.imwrite(os.path.join(tmp, "art.png"), art)
        io.save_annotation(os.path.join(tmp, "ann.png"), mask, value)
        with open(os.path.join(tmp, "depth16.png"), "rb") as f:
            assert np.array_equal(io.png_decode(f.read()), u16)
        assert np.array_equal(io.imread_rgb(os.path.join(tmp, "art.png")), art)
        assert io.image_size(os.path.join(tmp, "art.png")) == (h, w)
        m2, v2 = io.load_annotation(os.path.join(tmp, "ann.png"))
        assert np.array_equal(m2, mask) and np.array_equal(v2[mask], value[mask])
        assert not any(m.startswith(("jax", "PIL", "cv2")) for m, v in sys.modules.items()
                       if v is not None)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def _profile_args(**over):
    """A parsed-args namespace as every CLI surface builds it."""
    a = dict(backend="xla", solver=None, tolerance=None, residual_metric=None, rb_rho=None,
             rb_plain=False, defocus_quality=None, defocus_stride=None, profile="fast")
    a.update(over)
    return argparse.Namespace(**a)


@pytest.mark.parametrize("over", [{}, {"solver": "jacobi"}, {"tolerance": 1e-4},
                                  {"profile": None, "rb_plain": True}])
def test_fast_profile_flags_match_jax(over):
    from realtimedepthdiffusion_tpu import flags as jflags
    from realtimedepthdiffusion_tpu_torch import flags

    def fail(msg):
        raise ValueError(msg)

    got = flags.resolve_solver_flags(_profile_args(**over), fail)
    assert got == jflags.resolve_solver_flags(_profile_args(**over), fail)
    if not over:
        assert got == {"backend": "xla", "solver": "red_black", "tolerance": 1e-3,
                       "residual_metric": "rms", "early_exit": True}
    DiffusionConfig(**got)


@pytest.fixture(scope="module")
def fast_run():
    """One fast-profile cascade by the JAX package and by the port on the
    CPU, at a size whose residual probes all sit > 20 % from the threshold."""
    from realtimedepthdiffusion_tpu_torch import flags

    kw = flags.resolve_solver_flags(_profile_args(), None)
    rgb, mask, value = synthetic_pair(*FAST_HW)
    jpipe = JPipeline(*FAST_HW, JConfig(**kw, fast_start=False))
    _, jg = jpipe.prepare_image(rgb)
    jd, js = jpipe.solve(jg, jnp.asarray(mask), jnp.asarray(value), jpipe.initial_state())
    jres = np.asarray(jpipe.residuals(jg, jnp.asarray(mask), jnp.asarray(value), js))
    pipe = DepthPipeline(*FAST_HW, DiffusionConfig(**kw), device="cpu")
    _, g = pipe.prepare_image(rgb)
    m, v = interop.annotation_from_numpy(mask, value, "cpu")
    log = []
    d, s = pipe.solve(g, m, v, pipe.initial_state(), log)
    return {"mask": mask, "value": value, "jd": np.asarray(jd), "jres": jres, "d": d,
            "jstate": tuple(np.asarray(x) for x in js), "pipe": pipe, "gpyr": g, "m": m,
            "v": v, "log": log}


def test_fast_profile_cascade_matches_jax(fast_run):
    """The port's red-black + RMS early exit cascade is within RMSE 1e-3 of
    the JAX package's, with every residual probe more than 5 % away from
    the threshold (so both exit after the same chunk)."""
    d = fast_run["d"].numpy()
    assert _rmse(d, fast_run["jd"]) <= 1e-3
    mask, value = fast_run["mask"], fast_run["value"]
    assert np.array_equal(d[mask], value[mask].astype(np.float32))
    log = fast_run["log"]
    assert [e["shape"] for e in log] == [(50, 65), (100, 130), (200, 260)]
    assert all(e["iters"] < it for e, it in zip(log, (1000, 500, 250)))
    for e in log:
        assert all(abs(p - e["tol"]) > 0.05 * e["tol"] for p in e["probes"])


def test_residuals_match_jax(fast_run):
    """The residuals of the JAX depth state, by the port and by JAX."""
    pipe = fast_run["pipe"]
    state = interop.state_from_numpy(fast_run["jstate"], "cpu")
    res = pipe.residuals(fast_run["gpyr"], fast_run["m"], fast_run["v"], state)
    assert res.dtype == torch.float32 and tuple(res.shape) == (2, pipe.levels)
    np.testing.assert_allclose(res.numpy(), fast_run["jres"], rtol=1e-5, atol=0)
    assert bool((res[1] <= res[0]).all())


def test_depth_u16_matches_jax():
    """At and around the .5 boundaries of d*257, and outside [0, 255]."""
    base = np.array([0.0, 1.0, 127.5, 254.99, 255.0, -1.0, 300.0, 1e-3], np.float32)
    halves = (np.arange(0, 65536, 997, dtype=np.float32) + np.float32(0.5)) / np.float32(257)
    d = np.concatenate([base, halves, np.nextafter(halves, np.float32(0)),
                        np.nextafter(halves, np.float32(300))]).astype(np.float32)
    d = d.reshape(1, -1)
    jpipe = JPipeline(1, d.shape[1], JConfig(backend="xla", fast_start=False))
    want = np.asarray(jpipe.depth_u16(jnp.asarray(d)))
    got = get_pipeline(1, d.shape[1], DiffusionConfig(), device="cpu").depth_u16(
        torch.from_numpy(d))
    assert got.dtype == torch.uint16
    assert want.dtype == np.uint16 and np.array_equal(got.numpy(), want)
