"""The port's copy of the NumPy oracle (``oracle/numpy_ref.py``) against
the JAX package's original, array for array, and the port's CPU solve held
to it (depth RMSE <= 1e-3 on [0, 1], scribbles exact): what ``chip_smoke.py``
repeats on the card, where the original cannot be imported."""

import inspect

import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.oracle import numpy_ref as joracle
from realtimedepthdiffusion_tpu_torch import DepthPipeline, interop
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.oracle import numpy_ref as toracle
from tests.conftest import synthetic_pair

SOLVERS = [{"solver": "jacobi_chebyshev"}, {"solver": "jacobi"}, {"solver": "red_black"},
           {"solver": "jacobi_chebyshev", "gray_pyramid": "floor"}]


def _rmse(a, b):
    return float(np.sqrt(np.mean(((np.asarray(a) - np.asarray(b)) / 255.0) ** 2)))


def test_copy_has_the_originals_functions():
    """Same public functions with the same signatures; only the config the
    module reads is the port's."""
    def public(mod):
        return {n: str(inspect.signature(f)).replace("realtimedepthdiffusion_tpu_torch",
                                                     "realtimedepthdiffusion_tpu")
                for n, f in vars(mod).items()
                if inspect.isfunction(f) and f.__module__ == mod.__name__}

    assert public(toracle) == public(joracle) and "solve_pyramid" in public(toracle)
    assert toracle.DiffusionConfig is DiffusionConfig


@pytest.mark.parametrize("kw", SOLVERS, ids=lambda k: "-".join(k.values()))
@pytest.mark.parametrize("h,w", [(96, 128), (61, 47)])
def test_solve_pyramid_equals_the_original(h, w, kw):
    rgb, mask, value = synthetic_pair(h, w)
    kw = dict(kw, max_iterations=24)
    gray = joracle.rgb_to_gray(rgb)
    assert np.array_equal(toracle.rgb_to_gray(rgb), gray)
    want, want_state = joracle.solve_pyramid(gray, mask, value, None, JConfig(**kw))
    got, got_state = toracle.solve_pyramid(gray, mask, value, None, DiffusionConfig(**kw))
    assert got.dtype == np.float32 and np.array_equal(got, want)
    assert len(got_state) == len(want_state)
    for a, b in zip(got_state, want_state):
        assert np.array_equal(a, b)
    # Warm: the state carried into a second solve with one more scribble.
    mask[3:6, 3:9], value[3:6, 3:9] = True, 192
    want2, _ = joracle.solve_pyramid(gray, mask, value, want_state, JConfig(**kw))
    got2, _ = toracle.solve_pyramid(gray, mask, value, got_state, DiffusionConfig(**kw))
    assert np.array_equal(got2, want2)


@pytest.mark.parametrize("effect", ["desaturation", "haze", "defocus", "defocus_naive"])
def test_effects_equal_the_original(effect):
    r = np.random.default_rng(4)
    rgb = r.integers(0, 256, (40, 52, 3), dtype=np.uint8)
    depth = (r.random((40, 52)) * 255).astype(np.float32)
    if effect == "desaturation":
        gray = joracle.rgb_to_gray(rgb)
        got, want = toracle.desaturation(rgb, gray, depth), joracle.desaturation(rgb, gray, depth)
    else:
        got = getattr(toracle, effect)(rgb, depth, DiffusionConfig())
        want = getattr(joracle, effect)(rgb, depth, JConfig())
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["pyr_up", "pyr_down_gray_ceil", "annotation_pyr_down", "paint",
                                  "edge_weights", "chebyshev_omegas", "rb_omegas"])
def test_pieces_equal_the_original(name):
    r = np.random.default_rng(6)
    gray = r.integers(0, 256, (33, 41), dtype=np.uint8)
    depth = (r.random((33, 41)) * 255).astype(np.float32)
    mask = r.random((33, 41)) < 0.1
    value = r.integers(0, 255, (33, 41), dtype=np.uint8)
    args = {
        "pyr_up": (depth, (67, 82)), "pyr_down_gray_ceil": (gray,),
        "annotation_pyr_down": (mask, value, (16, 20)),
        "paint": (mask.copy(), value.copy(), 10, 12, 128, 6),
        "chebyshev_omegas": (40,), "rb_omegas": (40,),
    }
    if name == "edge_weights":
        got = toracle.edge_weights(gray, depth, 0, 2, DiffusionConfig())
        want = joracle.edge_weights(gray, depth, 0, 2, JConfig())
    else:
        got = getattr(toracle, name)(*args[name])
        want = getattr(joracle, name)(*[a.copy() if isinstance(a, np.ndarray) else a
                                        for a in args[name]])
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None and b is None) or np.array_equal(a, b)


@pytest.mark.parametrize("h,w", [(96, 128), (181, 243)])
def test_port_cpu_solve_within_bar_of_the_oracle(h, w):
    """The port's plain path on the CPU against the oracle copy's cascade
    (which is Jacobi-Chebyshev whatever ``cfg.solver`` says)."""
    rgb, mask, value = synthetic_pair(h, w)
    cfg = DiffusionConfig(max_iterations=200)
    want, want_state = toracle.solve_pyramid(toracle.rgb_to_gray(rgb), mask, value, None, cfg)
    pipe = DepthPipeline(h, w, cfg, device="cpu")
    _, gpyr = pipe.prepare_image(rgb)
    m, v = interop.annotation_from_numpy(mask, value, "cpu")
    depth, state = pipe.solve(gpyr, m, v, pipe.initial_state())
    d = depth.numpy()
    assert _rmse(d, want) <= 1e-3
    assert np.array_equal(d[mask], value[mask].astype(np.float32))
    for s, o in zip(state, want_state):
        assert _rmse(s.numpy(), o) <= 1e-3


@pytest.mark.parametrize("level,max_level", [(0, 2), (1, 2), (2, 2)])
def test_port_red_black_level_within_bar_of_the_oracle(level, max_level):
    """One red-black level by the port's plain path against the oracle
    copy's ``solve_level_red_black``."""
    from realtimedepthdiffusion_tpu_torch.core.annotation import seed_depth
    from realtimedepthdiffusion_tpu_torch.core.solver import solve_level

    r = np.random.default_rng(level)
    h, w = 45, 61
    gray = r.integers(0, 256, (h, w), dtype=np.uint8)
    mask = r.random((h, w)) < 0.06
    value = r.integers(0, 255, (h, w), dtype=np.uint8)
    depth = toracle.seed_depth(np.full((h, w), 255.0, np.float32), mask, value)
    cfg = DiffusionConfig(solver="red_black")
    want = toracle.solve_level_red_black(depth, mask, gray, level, max_level, 30, cfg)
    got = solve_level(seed_depth(torch.full((h, w), 255.0), torch.from_numpy(mask),
                                 torch.from_numpy(value)), torch.from_numpy(mask),
                      torch.from_numpy(gray), level, max_level, 30, cfg).numpy()
    assert _rmse(got, want) <= 1e-3
    assert np.array_equal(got[mask], value[mask].astype(np.float32))
