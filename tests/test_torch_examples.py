"""Smoke tests of the port's examples (``realtimedepthdiffusion_tpu_torch/examples``),
twins of tests/test_examples.py at its sizes, with ``--device cpu``."""

import importlib.util
import os
import sys

import numpy as np
import pytest

from realtimedepthdiffusion_tpu_torch.io import imwrite

_EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "realtimedepthdiffusion_tpu_torch", "examples")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"torch_example_{name}",
                                                  os.path.join(_EXAMPLES, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture()
def tiny_pair(tmp_path, rng):
    img = os.path.join(tmp_path, "tiny.png")
    ann = os.path.join(tmp_path, "tiny_ann.png")
    imwrite(img, rng.integers(0, 256, (96, 128, 3), dtype=np.uint8))
    a = np.full((96, 128), 32, np.uint8)  # sentinel = unannotated
    a[10:20, 10:30] = 0
    a[70:80, 90:120] = 254
    imwrite(ann, a)
    return img, ann


def test_example_01_depth_and_effects(tiny_pair, tmp_path):
    img, ann = tiny_pair
    out = os.path.join(tmp_path, "out")
    depth = _load("01_depth_and_effects").main(
        ["--image", img, "--annotation", ann, "--out", out, "--iterations", "40",
         "--device", "cpu"])
    assert depth.shape == (96, 128)
    assert (depth[10:20, 10:30] == 0).all() and (depth[70:80, 90:120] == 254).all()
    for f in ("DepthMap.png", "Effect_refocus.png", "Effect_desaturation.png",
              "Effect_haze.png"):
        assert os.path.exists(os.path.join(out, f))


def test_example_02_warm_edits(tiny_pair):
    img, _ = tiny_pair
    depth = _load("02_warm_edits").main(
        ["--image", img, "--iterations", "40", "--incremental", "8", "--device", "cpu"])
    assert depth.shape == (96, 128)
    assert float(np.min(depth)) >= 0.0 and float(np.max(depth)) <= 255.0


def test_example_03_batch_serving(tiny_pair, tmp_path):
    img, ann = tiny_pair
    imgs, anns = os.path.join(tmp_path, "imgs"), os.path.join(tmp_path, "anns")
    os.makedirs(imgs), os.makedirs(anns)
    os.rename(img, os.path.join(imgs, "a.png"))
    os.rename(ann, os.path.join(anns, "a.png"))
    out = os.path.join(tmp_path, "depths")
    written = _load("03_batch_serving").main(
        ["--images", imgs, "--annotations", anns, "--out", out, "--iterations", "40",
         "--device", "cpu"])
    assert len(written) == 1 and os.path.exists(written[0])
    assert os.path.exists(os.path.join(out, "a_effect.png"))


@pytest.mark.parametrize("slots", [None, 8])
def test_example_04_multichip(slots):
    argv = ["--rows", "64", "--cols", "96", "--iterations", "24", "--device", "cpu"]
    depth = _load("04_multichip").main(argv + ([] if slots is None else ["--slots", str(slots)]))
    assert depth.shape == (2 if slots == 8 else 1, 64, 96)


def test_examples_default_to_the_card(tiny_pair, tmp_path):
    """Without --device the examples ask for the card, which raises where
    there is none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    img, ann = tiny_pair
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("02_warm_edits").main(["--image", img, "--iterations", "8"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _load("04_multichip").main(["--rows", "32", "--cols", "48"])
