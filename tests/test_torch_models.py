"""The port's model facade (``models/depth_diffusion.py``) against the JAX
package's on the CPU: each family's solve within RMSE 1e-3 on [0, 1] of its
JAX twin with scribbles exact, the renders, the warm start, the incremental
re-solve, and the prepared-image cache. numpy goes in and comes out. Also
the stage timer and the profiler trace of ``utils/timing.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import realtimedepthdiffusion_tpu_torch as rt
from realtimedepthdiffusion_tpu import models as jmodels
from realtimedepthdiffusion_tpu_torch import models as tmodels
from tests.conftest import synthetic_pair

H, W = 96, 128
KW = {"max_iterations": 100}
FAMILIES = ["ChebyshevCascade", "JacobiCascade", "RedBlackCascade", "VCycle"]


def _rmse(a, b):
    return float(np.sqrt(np.mean(((np.asarray(a) - np.asarray(b)) / 255.0) ** 2)))


def _jax_model(family, **kw):
    return getattr(jmodels, family)(backend="xla", fast_start=False, **KW, **kw)


@pytest.fixture(scope="module")
def pair():
    return synthetic_pair(H, W)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_configs_match_jax(family):
    """Each family binds the same config as its JAX twin, field for field."""
    want = dataclasses.asdict(getattr(jmodels, family).config)
    assert dataclasses.asdict(getattr(tmodels, family).config) == want
    assert getattr(rt, family) is getattr(tmodels, family)
    assert issubclass(getattr(tmodels, family), tmodels.DepthDiffusionModel)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_solve_matches_jax(pair, family):
    rgb, mask, value = pair
    kw = {"tolerance": 1e-9} if family == "RedBlackCascade" else {}  # the cap, on both sides
    want = _jax_model(family, **kw).solve(rgb, mask, value)
    model = getattr(tmodels, family)(device="cpu", **KW, **kw)
    got = model.solve(rgb, mask, value)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32 and got.shape == (H, W)
    assert _rmse(got, want) <= 1e-3
    assert np.array_equal(got[mask], value[mask].astype(np.float32))


@pytest.mark.parametrize("effect", ["b", "g", "h"])
def test_solve_and_render_matches_jax(pair, effect):
    """One call gives depth, art and state; the art equals ``render`` of
    that depth, and JAX's render of the same depth."""
    rgb, mask, value = pair
    model = tmodels.ChebyshevCascade(device="cpu", **KW)
    depth, art, state = model.solve_and_render(rgb, mask, value, effect)
    assert art.dtype == np.uint8 and art.shape == (H, W, 3)
    assert all(isinstance(s, torch.Tensor) and s.device.type == "cpu" for s in state)
    assert np.array_equal(state[0].numpy(), depth)
    assert np.array_equal(model.render(rgb, depth, effect), art)
    # The defocus is integer and exact; the pointwise effects truncate f32
    # to u8 and sit within one level (tests/test_torch_glue.py).
    jart = _jax_model("ChebyshevCascade").render(rgb, depth, effect).astype(np.int32)
    assert np.abs(art.astype(np.int32) - jart).max() <= (0 if effect == "b" else 1)
    jdepth, _, _ = _jax_model("ChebyshevCascade").solve_and_render(rgb, mask, value, effect)
    assert _rmse(depth, jdepth) <= 1e-3


def test_warm_start_and_state_stay_valid(pair):
    """A state warm-starts the next solve as JAX's does, and is still whole
    afterwards: the port donates nothing."""
    rgb, mask, value = pair
    mask2, value2 = mask.copy(), value.copy()
    mask2[10:16, 100:110] = True
    value2[10:16, 100:110] = 192
    jmodel = _jax_model("ChebyshevCascade")
    _, jstate = jmodel.solve_with_state(rgb, mask, value)
    want, _ = jmodel.solve_with_state(rgb, mask2, value2, jstate)
    model = tmodels.ChebyshevCascade(device="cpu", **KW)
    _, state = model.solve_with_state(rgb, mask, value)
    kept = tuple(s.clone() for s in state)
    got = model.solve(rgb, mask2, value2, state)
    assert _rmse(got, want) <= 1e-3
    assert all(torch.equal(s, k) for s, k in zip(state, kept))
    assert np.array_equal(model.solve(rgb, mask2, value2, state), got)  # and reusable


@pytest.mark.parametrize("center", [(48, 64), np.array([2, 3]), [95, 127]],
                         ids=["inside", "top_left", "far_corner"])
def test_facade_incremental_matches_jax(pair, center):
    rgb, mask, value = pair
    kw = {"incremental_window": 32, "incremental_iterations": 40}
    cy, cx = (int(c) for c in center)
    mask2, value2 = mask.copy(), value.copy()
    rows, cols = slice(max(cy - 4, 0), cy + 4), slice(max(cx - 4, 0), cx + 4)
    mask2[rows, cols] = True
    value2[rows, cols] = 128
    jmodel = _jax_model("ChebyshevCascade", **kw)
    _, jstate = jmodel.solve_with_state(rgb, mask, value)
    # JAX wraps a negative window start to the far side; give it the centre
    # whose window starts at 0, which is where the port clamps to.
    jcenter = np.maximum(np.asarray(center), 16)
    want, _ = jmodel.solve_incremental(rgb, mask2, value2, jstate, jcenter)
    model = tmodels.ChebyshevCascade(device="cpu", **KW, **kw)
    _, state = model.solve_with_state(rgb, mask, value)
    got, new_state = model.solve_incremental(rgb, mask2, value2, state, center)
    assert got.dtype == np.float32 and _rmse(got, want) <= 1e-3
    assert np.array_equal(got[mask2], value2[mask2].astype(np.float32))
    assert np.array_equal(new_state[0].numpy(), got)


def test_image_cache_matches_by_identity(pair):
    """The prepared image is reused for the same array object, rebuilt for
    another one, and dropped by ``invalidate_image_cache``."""
    rgb, mask, value = pair
    model = tmodels.ChebyshevCascade(device="cpu", max_iterations=8)
    model.solve(rgb, mask, value)
    first = model._cache["img"][1]
    model.render(rgb, np.zeros((H, W), np.float32))
    assert model._cache["img"][1] is first  # same object: no new upload or pyramid
    twin = rgb.copy()
    model.solve(twin, mask, value)
    assert model._cache["img"][0] is twin and model._cache["img"][1] is not first
    # A change in place is invisible to the cache until it is dropped.
    before = model.render(twin, np.full((H, W), 128, np.float32), "g")
    twin[:] = 255 - twin
    assert np.array_equal(model.render(twin, np.full((H, W), 128, np.float32), "g"), before)
    model.invalidate_image_cache()
    assert not np.array_equal(model.render(twin, np.full((H, W), 128, np.float32), "g"), before)


def test_device_is_required_and_overrides_apply():
    with pytest.raises(TypeError):
        tmodels.ChebyshevCascade()  # the device is never implied
    model = tmodels.VCycle(rt.DiffusionConfig(multigrid="vcycle", vcycles=1), device="cpu",
                           beta=0.5)
    assert (model.cfg.vcycles, model.cfg.beta, model.cfg.multigrid) == (1, 0.5, "vcycle")
    assert model.device == torch.device("cpu")
    assert model._pipe(32, 48) is model._pipe(32, 48)
    assert model._pipe(32, 48).device == torch.device("cpu")


def test_stage_timer_accumulates_and_syncs():
    """``StageTimer`` against the JAX package's: the same totals, counts and
    report; given a device, its sync hook runs at the end of each stage that
    did not raise (a CPU device needs none)."""
    from realtimedepthdiffusion_tpu.utils import timing as jtiming
    from realtimedepthdiffusion_tpu_torch.utils import timing

    timer, jtimer = timing.StageTimer(), jtiming.StageTimer()
    for t in (timer, jtimer):
        for name in ("solve", "solve", "effect"):
            with t.stage(name):
                pass
    assert dict(timer.counts) == dict(jtimer.counts) == {"solve": 2, "effect": 1}
    assert [ln.split(":")[0] for ln in timer.report().splitlines()] == [
        ln.split(":")[0] for ln in jtimer.report().splitlines()]
    assert timing.StageTimer(device="cpu").sync is None and timer.sync is None
    calls = []
    timer.sync = lambda: calls.append(1)
    with timer.stage("solve"):
        pass
    with pytest.raises(RuntimeError):
        with timer.stage("solve"):
            raise RuntimeError("a stage that fails is still counted, but not waited for")
    assert calls == [1] and timer.counts["solve"] == 4
    timer.reset()
    assert not timer.totals and not timer.counts


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import json

    from realtimedepthdiffusion_tpu_torch.utils import timing

    out = tmp_path / "trace"
    with timing.device_trace(str(out), device="cpu"):
        torch.ones(8, 8) @ torch.ones(8, 8)
    with open(out / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") or "matmul" in e.get("name", "") for e in events)
