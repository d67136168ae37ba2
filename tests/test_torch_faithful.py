"""The port's CUDA-faithful oracle (``oracle/faithful.py``) against the JAX
package's, and the port's CPU pipeline against it at the bar of
tests/test_faithful.py (RMSE <= 1e-3 on [0, 1] at a reduced budget)."""

import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu.config import DiffusionConfig as JaxConfig
from realtimedepthdiffusion_tpu.oracle import faithful as jfaithful
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.oracle import faithful
from tests.conftest import synthetic_pair

cv2 = pytest.importorskip("cv2")


def _bgr_pair(h, w, seed):
    rgb, mask, value = synthetic_pair(h, w, seed)
    return np.ascontiguousarray(rgb[..., ::-1]), mask, value


def test_available():
    assert faithful.available() and jfaithful.available()


@pytest.mark.parametrize("h,w", [(64, 64), (65, 63), (101, 77)])
def test_faithful_gray_pyramid_equals_jax(h, w):
    bgr = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    cfg = DiffusionConfig()
    sizes = [cfg.level_size(h, w, lv) for lv in range(cfg.num_levels(h, w))]
    got = faithful.faithful_gray_pyramid(bgr, sizes)
    want = jfaithful.faithful_gray_pyramid(bgr, sizes)
    assert [g.shape for g in got] == [tuple(s) for s in sizes]
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("h,w,seed", [(64, 80, 1), (69, 85, 2), (96, 128, 3)])
def test_faithful_solve_equals_jax(h, w, seed):
    """The same inputs through both oracles: bit-equal depth and state."""
    bgr, mask, value = _bgr_pair(h, w, seed)
    got, got_state = faithful.solve_pyramid(bgr, mask, value, None,
                                            DiffusionConfig(max_iterations=40))
    want, want_state = jfaithful.solve_pyramid(bgr, mask, value, None,
                                               JaxConfig(max_iterations=40))
    assert np.array_equal(got, want)
    assert len(got_state) == len(want_state)
    assert all(np.array_equal(a, b) for a, b in zip(got_state, want_state))
    assert np.array_equal(faithful.depth_u8(got), jfaithful.depth_u8(want))
    # A warm state carried into a second solve.
    again, _ = faithful.solve_pyramid(bgr, mask, value, got_state,
                                      DiffusionConfig(max_iterations=40))
    want_again, _ = jfaithful.solve_pyramid(bgr, mask, value, want_state,
                                            JaxConfig(max_iterations=40))
    assert np.array_equal(again, want_again)


@pytest.mark.parametrize("h,w,seed", [(96, 128, 1), (69, 85, 4)])
def test_pipeline_parity_vs_faithful_oracle(h, w, seed):
    """The port's pipeline on the CPU against the faithful oracle on
    synthetic_pair: RMSE <= 1e-3 on normalized depth, the bar of
    tests/test_faithful.py (at its budget of 120)."""
    from realtimedepthdiffusion_tpu_torch import DepthPipeline

    bgr, mask, value = _bgr_pair(h, w, seed)
    cfg = DiffusionConfig(max_iterations=120)
    want, _ = faithful.solve_pyramid(bgr, mask, value, None, cfg)
    pipe = DepthPipeline(h, w, cfg, device="cpu")
    _, gpyr = pipe.prepare_image(np.ascontiguousarray(bgr[..., ::-1]))
    depth, _ = pipe.solve(gpyr, torch.from_numpy(mask), torch.from_numpy(value),
                          pipe.initial_state())
    rmse = float(np.sqrt(np.mean(((depth.numpy() - want) / 255.0) ** 2)))
    assert rmse <= 1e-3, rmse
