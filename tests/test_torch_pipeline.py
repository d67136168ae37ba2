"""The port's slice end to end against the JAX package on the CPU: one
``solve_and_effect(EFFECT_DEFOCUS, ...)`` update, a JAX state carried into a
second port solve, the defocus on a shared depth, and the port importing
with JAX, PIL and cv2 blocked.

Depth bar: RMSE <= 1e-3 on [0, 1] (tests/test_golden.py). The port takes
the (a,b,c) form of the Chebyshev update and the JAX xla backend its
omega form, so the two agree to rounding, not bit for bit."""

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
                                   "defocus_box": 0}


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
    """The port and a small solve run with jax, PIL and cv2 unimportable."""
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
        assert not any(m.startswith(("jax", "PIL", "cv2")) for m, v in sys.modules.items()
                       if v is not None)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
