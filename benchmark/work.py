"""The least time of the kernels' work on one H100, from the algorithm's
shapes alone, so that any kernel doing the same work reads the same bound.

Peaks are NVIDIA's published figures for the H100 SXM at its full 700 W:
67 TFLOP/s FP32 outside the tensor cores (an FMA counts two) and
3.35 TB/s of HBM. A run prints the card's power limit beside them.

Operations and bytes are counted as the algorithm needs them, never as an
implementation moves them: each input byte is read once and each output
byte written once per call, and the floating-point operations are the
multiplies and adds of the update (the clip's min and max and the
scribble's select are not counted).

The pattern is ``chip_smoke.py:bound()``'s, restated on the published
FP32 peak (that one assumed a 33.5 T/s issue rate).
"""

from __future__ import annotations

PEAK_FLOP_S = 67e12
PEAK_BYTES_S = 3.35e12

# One Jacobi-Chebyshev update of a pixel: the weighted sum of four
# neighbours (4 multiplies, 3 adds), times the reciprocal weight (1), and
# the Chebyshev step omega * (gamma * (r - u) + u - prev) + prev (2
# multiplies, 4 adds): 14 FLOPs.
JC_FLOPS_PER_PX = 14
# Per level call: u in, the horizontal and vertical pair weights and the
# reciprocal sum in (float32 each), the scribble mask in (1 byte), u out.
JC_BYTES_PER_PX = 4 + 4 + 4 + 4 + 1 + 4
# One box-blur pixel of the defocus: its half-width (a multiply and a
# divide) and per channel the mean of four corner sums (3 adds, 1 divide):
# 2 + 3 * 4 = 14 operations; the summed-area table's two adds per pixel and
# channel, 6 more.
DEFOCUS_OPS_PER_PX = 14 + 6
# RGB in (3 bytes), the depth in (float32), RGB out (3).
DEFOCUS_BYTES_PER_PX = 3 + 4 + 3


def least_s(flops: float, n_bytes: float) -> float:
    """The least time of a call: the larger of its operations over the
    FP32 peak and its bytes over the memory peak."""
    return max(flops / PEAK_FLOP_S, n_bytes / PEAK_BYTES_S)


def jc_level_s(h: int, w: int, sweeps: int) -> float:
    """The least time of ``sweeps`` Jacobi-Chebyshev sweeps of an h x w
    level in one call."""
    if sweeps <= 0:
        return 0.0
    return least_s(JC_FLOPS_PER_PX * h * w * sweeps, JC_BYTES_PER_PX * h * w)


def cascade_levels(rows: int, cols: int, base_size: int, max_iterations: int):
    """[(h, w, sweeps)] of the cascade's levels: floor sizes, log2(min //
    base) + 1 levels, max_iterations / 2^(L-1-l) sweeps at level l."""
    q = max(min(rows, cols) // base_size, 1)
    levels = q.bit_length()
    return [(rows >> l, cols >> l, int(max_iterations / 2.0 ** (levels - 1 - l)))
            for l in range(levels)]


def jc_cascade_s(rows: int, cols: int, base_size: int, max_iterations: int) -> float:
    """The least time of one fixed-count Jacobi-Chebyshev cascade's sweeps."""
    return sum(jc_level_s(h, w, n) for h, w, n in cascade_levels(rows, cols, base_size,
                                                                 max_iterations))


def defocus_s(rows: int, cols: int) -> float:
    """The least time of one defocus of a rows x cols image."""
    px = rows * cols
    return least_s(DEFOCUS_OPS_PER_PX * px, DEFOCUS_BYTES_PER_PX * px)
