"""CUDA-faithful oracle: what the reference *binary* actually computes.

The port's own copy of ``realtimedepthdiffusion_tpu/oracle/faithful.py``,
over the port's ``oracle/numpy_ref.py`` and ``config.py``; the text below is
the original's.

The framework's main oracle (numpy_ref.py) and pipeline use a single clean
floor-size pyramid convention. The real reference binary does not: it
allocates floor-size buffers but drives them with OpenCV's ceil-size pyramid
ops, reconciled through quirks this module replicates exactly — by calling
OpenCV itself for every pyramid op, so its numerics (fixed-point 8U pyrDown,
float pyrUp borders) are the ground truth, not a re-derivation:

- Gray pyramid (src/main.cpp:140-147 and again :241-247): the GPU pyrDown
  guard `(rows + 1 / 2) == halfRows` is dead code (C precedence, bug #1 in
  SURVEY.md), so the CPU `cv::pyrDown` fallback ALWAYS runs. `cv::pyrDown`
  ignores the preallocated floor-size dst and reallocates it to OpenCV's
  ceil sizes; `GpuMat::upload` then reallocates the device gray mat to match
  (ceil). The solver, however, is invoked with rows/cols from the
  floor-sized depth mats (src/main.cpp:266-268) while indexing the gray
  buffer through its own (ceil) pitch — i.e. it consumes the TOP-LEFT
  FLOOR-SIZE CROP of a pure ceil pyrDown chain.
- Depth pyrUp (src/main.cpp:272-279): even sizes take `cv::cuda::pyrUp`
  (plain 2x), odd take CPU `cv::pyrUp` to the explicit floor dst size. Both
  are the same 5-tap kernel; this oracle uses CPU `cv::pyrUp` with an
  explicit dstsize for both (the even case is identical by definition;
  CUDA-vs-CPU float summation-order differences are below the parity
  budget).
- Level-0 gray comes from `cv::cuda::cvtColor` (src/main.cpp:138); this
  oracle uses CPU `cv::cvtColor`, which implements the same fixed-point
  BGR2GRAY arithmetic.
- Annotation pyramids, seeding, weights and the Jacobi+Chebyshev sweeps run
  entirely in floor-size buffers in the reference (device mats that are
  never reallocated), so they are shared with numpy_ref (whose three
  documented deviations — reciprocal multiply, clamp-before-u8-truncate,
  non-finite-reciprocal flush — remain the only known deltas from the CUDA
  arithmetic).

Requires cv2, used only at the test/parity boundary (the product pipeline
never imports this module, and the port runs where cv2 is missing:
``available()`` says whether it imported).
"""

from __future__ import annotations

import numpy as np

from ..config import DiffusionConfig
from . import numpy_ref as ref

try:  # cv2 is a test-boundary dependency, not a product one
    import cv2
except Exception:  # pragma: no cover
    cv2 = None


def available() -> bool:
    return cv2 is not None


def faithful_gray_pyramid(bgr: np.ndarray, sizes: list) -> list:
    """Ceil-size cv::pyrDown chain, cropped to floor sizes at consumption
    (see module doc). ``bgr`` is the OpenCV-ordered image, as the binary
    reads it with cv::imread."""
    full = [cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)]
    for _ in range(1, len(sizes)):
        full.append(cv2.pyrDown(full[-1]))
    return [g[: s[0], : s[1]] for g, s in zip(full, sizes)]


def solve_pyramid(
    bgr: np.ndarray,
    mask0: np.ndarray,
    value0: np.ndarray,
    depth_state: list | None = None,
    cfg: DiffusionConfig = DiffusionConfig(),
):
    """Full coarse-to-fine solve with the binary's exact pyramid semantics.

    Returns (depth0_f32, depth_state) like numpy_ref.solve_pyramid. The
    final 8-bit map the binary writes is ``depth_u8(depth0)``.
    """
    if cv2 is None:  # pragma: no cover
        raise RuntimeError("cv2 unavailable; faithful oracle needs OpenCV")
    h, w = bgr.shape[:2]
    levels = cfg.num_levels(h, w)
    sizes = [cfg.level_size(h, w, l) for l in range(levels)]

    grays = faithful_gray_pyramid(bgr, sizes)
    masks, values = [mask0], [value0]
    for l in range(1, levels):
        m, v = ref.annotation_pyr_down(masks[-1], values[-1], sizes[l])
        masks.append(m)
        values.append(v)

    if depth_state is None:
        depth_state = [np.full(s, cfg.depth_init, dtype=np.float32) for s in sizes]
    depth_state = [d.copy() for d in depth_state]

    L = levels - 1
    depth_state[L] = ref.seed_depth(depth_state[L], masks[L], values[L])
    for level in range(L, -1, -1):
        iters = cfg.level_iterations(levels, level)
        depth_state[level] = ref.solve_level(
            depth_state[level], masks[level], grays[level], level, L, iters, cfg
        )
        if level > 0:
            th, tw = sizes[level - 1]
            up = cv2.pyrUp(depth_state[level], dstsize=(tw, th))
            depth_state[level - 1] = ref.seed_depth(
                up.astype(np.float32), masks[level - 1], values[level - 1]
            )
    return depth_state[0], depth_state


def depth_u8(depth: np.ndarray) -> np.ndarray:
    """GpuMat::convertTo(CV_8UC1) (src/main.cpp:290): saturate_cast with
    round-half-to-even."""
    return np.clip(np.rint(depth), 0, 255).astype(np.uint8)
