"""The least time of the V-cycle's polish (``core/multigrid.py:
vcycle_polish``) on one H100, from the algorithm's shapes, in the manner of
``work.py`` and on its peaks: operations and bytes as the algorithm needs
them, never as an implementation moves them.

The work is counted from the port's counters, which the session keeps while
a profiler runs (``core/multigrid.py:vcycle_work``): ``vcycle.px_sweeps``,
the pixels times sweeps of every smoothing (pre, post and coarse) at every
level of every cycle, ``vcycle.px``, the pixels of every level visit, and
``vcycle.cycles``, which with the coarsest level's shape gives that level's
pixels. Only the smoothing's operations and streams are counted: on every
level but the coarsest, a visit smooths twice, before the restriction and
after the coarse correction, so no implementation can smooth it in one pass
over its planes; the coarsest smooths once. A level visit's residual,
restriction, pyrUp and damped correction (about 3 sweeps' worth a visit,
against 16 to 200 sweeps of smoothing, and their streams) and the levels'
weights are not counted, so the least time is a lower bound and a share of
it cannot pass 100 %.
"""

from __future__ import annotations

from benchmark import work

# One Jacobi sweep of the error equation at a pixel, e <- M e + rhs: the
# weighted sum of four neighbours (4 multiplies, 3 adds), times the
# reciprocal weight (1), plus the right-hand side (1): 9 FLOPs. The
# scribbles' select is not counted.
SWEEP_FLOPS_PER_PX = 9
# Per smoothing pass: the right-hand side in, the horizontal and vertical
# pair weights and the reciprocal sum in (float32 each), the scribble mask in
# (1 byte), the error out (float32).
PASS_BYTES_PER_PX = 4 + 4 + 4 + 4 + 1 + 4


def flops(px_sweeps: int) -> float:
    """The polish's counted floating-point operations."""
    return SWEEP_FLOPS_PER_PX * px_sweeps


def passes_px(px: int, coarse_px: int) -> int:
    """Pixels of every smoothing pass: two a visit of a finer level, one a
    visit of the coarsest, whose visits hold ``coarse_px`` of the ``px``."""
    return 2 * px - coarse_px


def least_s(px_sweeps: int, px: int, coarse_px: int) -> float:
    """The least time of the counted work: the larger of its operations over
    the FP32 peak and its passes' bytes over the memory peak."""
    return work.least_s(flops(px_sweeps), PASS_BYTES_PER_PX * passes_px(px, coarse_px))
