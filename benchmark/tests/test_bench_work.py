"""work.py's counts against hand counts at a small shape."""

import pytest

from benchmark import work


def test_cascade_levels_by_hand():
    # 192 x 256: min 192 // 45 = 4, log2 4 + 1 = 3 levels; 1000 / 4, / 2, / 1.
    assert work.cascade_levels(192, 256, 45, 1000) == [(192, 256, 250), (96, 128, 500),
                                                       (48, 64, 1000)]


def test_jc_level_by_hand():
    h, w, n = 48, 64, 1000
    flops = 14 * h * w * n  # 4 mul + 3 add, 1 mul, 6 of the Chebyshev step
    n_bytes = 21 * h * w    # u, two pair weights, inverse sum in; mask; u out
    assert work.jc_level_s(h, w, n) == pytest.approx(max(flops / 67e12, n_bytes / 3.35e12))
    assert work.jc_level_s(h, w, 0) == 0.0


def test_defocus_by_hand():
    px = 96 * 128
    assert work.defocus_s(96, 128) == pytest.approx(max(20 * px / 67e12, 10 * px / 3.35e12))
    # bytes bound it
    assert work.defocus_s(96, 128) == pytest.approx(10 * px / 3.35e12)


def test_cascade_sum():
    want = sum(work.jc_level_s(h, w, n) for h, w, n in [(192, 256, 250), (96, 128, 500),
                                                         (48, 64, 1000)])
    assert work.jc_cascade_s(192, 256, 45, 1000) == pytest.approx(want)
