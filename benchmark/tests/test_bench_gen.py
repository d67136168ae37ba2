"""The seeded generators repeat by seed, and the stroke mixes take the
paths they exist for: every ``spread`` update's dirty rect passes the
1080p window, no ``strokes`` update's does. Both keep to one drag of 4
events per GUI tick; ``spread`` paints it with a broad brush."""

import numpy as np
import pytest

from benchmark import gen, spec
from benchmark.reference import plain

H, W = 1080, 1920


def test_strokes_repeat_by_seed():
    t = spec.traffic("strokes")
    a = gen.strokes(np.random.default_rng(2**40 + 3), H, W, t, 500)
    b = gen.strokes(np.random.default_rng(2**40 + 3), H, W, t, 500)
    c = gen.strokes(np.random.default_rng(2**40 + 4), H, W, t, 500)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])


def test_pairs_repeat_by_seed():
    a = [gen.pair(2**40 + 5, k, 96, 128) for k in range(2)]
    b = [gen.pair(2**40 + 5, k, 96, 128) for k in (1, 0)][::-1]  # in another order
    for p, q in zip(a, b):
        assert all(np.array_equal(x, y) for x, y in zip(p, q))
    assert not np.array_equal(a[0][0], a[1][0])
    assert a[0][1].sum() == a[1][1].sum()  # the same blocks, placed anew
    assert not np.array_equal(a[0][0], gen.pair(2**40 + 6, 0, 96, 128)[0])


def _rects(traffic_name, n=2000, seed=17):
    cfg = spec.config(spec.load(), "fast_1080p")["diffusion"]
    t = spec.traffic(traffic_name)
    keys, events = gen.strokes(np.random.default_rng(seed), H, W, t, n)
    radius = gen.brush_side(plain.brush_radius(cfg, H, W), t)
    mask, value = np.zeros((H, W), bool), np.zeros((H, W), np.uint8)
    out = []
    for k in range(n):
        rects = []
        for x, y in events[k].tolist():
            assert 0 <= x < W and 0 <= y < H
            plain.merge_rect(rects, plain.paint(mask, value, x, y, 254, radius),
                             cfg["incremental_max_rects"])
        out.append(rects)
    return out, cfg["incremental_window"]


@pytest.mark.parametrize("traffic_name,exceeds", [("strokes", False), ("spread", True)])
def test_rects_against_the_window(traffic_name, exceeds):
    t = spec.traffic(traffic_name)
    assert t["events"] == 4 and (t["step_min"], t["step_max"]) == (6, 10)
    all_rects, win = _rects(traffic_name)
    for rects in all_rects:
        assert len(rects) == 1
        y0, x0, y1, x1 = rects[0]
        assert (max(y1 - y0 + 1, x1 - x0 + 1) > win) == exceeds
