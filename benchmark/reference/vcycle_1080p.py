"""The plain reference of ``vcycle_1080p``: the V-cycle scheme
(``multigrid: "vcycle"``), in plain torch.

Every function of ``plain.INTERFACE`` but ``cascade`` is ``plain``'s, and
so are the cascadic solve, pyrUp and edge weights that ``cascade`` builds
on. ``cascade`` is the V-cycle, written from the algorithm: a cascadic warm
start at ``max_iterations * vcycle_warm_fraction`` iterations (at least
``4 * chebyshev_s``), then ``vcycles`` error-correction cycles at the
finest level. On level l a cycle solves (I - M_l) e = rhs approximately,
where M_l is the level's weighted 4-neighbour average, unclipped, and e = 0
on the level's scribbles:

1. pre-smooth: ``vcycle_pre_smooth`` Jacobi sweeps e <- M e + rhs from
   e = 0;
2. the residual rhs - (I - M) e, restricted by 2x2 full weighting (the
   mean of each cell's four pixels) onto the next level's floor-size grid,
   0 on its scribbles;
3. recurse; the coarsest level takes ``vcycle_coarse_iters`` sweeps from
   e = 0 and nothing else;
4. pyrUp the coarse error, zero it on the scribbles (c), and add alpha * c
   with alpha = <r, A c> / <A c, A c>, A = I - M off the scribbles and r
   the residual of step 2 before its restriction: the factor that makes
   the residual's L2 norm least along c (0 where A c = 0);
5. post-smooth: ``vcycle_post_smooth`` sweeps.

On the finest level a cycle's right-hand side is the residual M u - u of
the current solution off the scribbles; its error is added to u with the
same damping, and u is clipped to [0, 255] after each cycle. Each level's
operator is fixed through the cycles: the edge weights of the level's gray
image and of the warm fine solution restricted down the pyramid by the
same 2x2 mean. Only level 0 of the returned state is polished; the coarser
levels are the warm cascade's.

Departures from the JAX package's V-cycle
(``realtimedepthdiffusion_tpu/core/multigrid.py:solve_vcycle``), each a
rounding difference only:

- the warm start is ``plain.cascade``, whose Chebyshev step is the
  reference program's ``omega * (gamma * (r - u) + u - prev) + prev``;
- the restriction adds a cell's four pixels in row-major order, where the
  JAX package reduces a 2x2 window in XLA's order;
- the two inner products of the damping are torch sums, in torch's order;
- every step runs in ``dt``, the weights, errors, sums and pyrUp too (the
  JAX package's polish and pyrUp run in float32; ``dt`` is float32 but for
  the control).

Nothing here or in the code it judges multiplies matrices or convolves,
but TF32 is turned off for both at import, so that no such rounding could
enter the comparison.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference import plain
from benchmark.reference.plain import (  # noqa: F401  (plain.INTERFACE, kept)
    annotation_pyramids, brush_radius, defocus, edge_weights, gray_pyramid, merge_rect, paint,
    pyr_up, rgb_to_gray, scribble_value, to_u8, windowed)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def warm_iterations(cfg, max_iterations=None):
    """The warm cascade's budget: ``vcycle_warm_fraction`` of the budget,
    at least four Chebyshev warm-ups."""
    budget = int(cfg["max_iterations"] if max_iterations is None else max_iterations)
    return max(int(budget * float(cfg["vcycle_warm_fraction"])), 4 * int(cfg["chebyshev_s"]))


def average(u, wts):
    """(wl*ul + wr*ur + wu*uu + wd*ud) * inv, unclipped: M u; a neighbour
    past the border reads 0."""
    wl, wr, wu, wd, inv = wts
    s = wl * F.pad(u[:, :-1], (1, 0))
    s = s + wr * F.pad(u[:, 1:], (0, 1))
    s = s + wu * F.pad(u[:-1, :], (0, 0, 1, 0))
    s = s + wd * F.pad(u[1:, :], (0, 0, 0, 1))
    return s * inv


def restrict(x, shape):
    """2x2 full weighting onto the floor-size grid ``shape``."""
    oh, ow = shape
    x = x[:2 * oh, :2 * ow]
    return 0.25 * (x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2])


def polish(cfg, grays, masks, u, dt):
    """``vcycles`` error-correction cycles on the warm fine solution ``u``
    (the module's docstring); returns the polished level 0 in ``dt``."""
    levels = len(grays)
    L = levels - 1
    sizes = [tuple(g.shape) for g in grays]
    zero = torch.zeros((), dtype=dt, device=u.device)
    u = u.to(dt)
    wts, d = [], u
    for level in range(levels):
        if level > 0:
            d = restrict(d, sizes[level])
        wts.append(edge_weights(cfg, grays[level], d, level, L, dt))

    def apply_a(e, level):
        return torch.where(masks[level], zero, e - average(e, wts[level]))

    def smooth(e, rhs, level, sweeps):
        for _ in range(sweeps):
            e = torch.where(masks[level], zero, average(e, wts[level]) + rhs)
        return e

    def damped(e, c, r, level):
        c = torch.where(masks[level], zero, c)
        ac = apply_a(c, level)
        den = (ac * ac).sum()
        alpha = torch.where(den > 0, (r * ac).sum() / den, zero)
        return e + alpha * c

    def cycle(rhs, level):
        e = torch.zeros(sizes[level], dtype=dt, device=rhs.device)
        if level == L:
            return smooth(e, rhs, level, int(cfg["vcycle_coarse_iters"]))
        e = smooth(e, rhs, level, int(cfg["vcycle_pre_smooth"]))
        r = rhs - apply_a(e, level)
        rc = torch.where(masks[level + 1], zero, restrict(r, sizes[level + 1]))
        e = damped(e, pyr_up(cycle(rc, level + 1), sizes[level]), r, level)
        return smooth(e, rhs, level, int(cfg["vcycle_post_smooth"]))

    for _ in range(int(cfg["vcycles"])):
        r = torch.where(masks[0], zero, average(u, wts[0]) - u)
        u = damped(u, cycle(r, 0), r, 0).clamp(0.0, 255.0)
    return u


def cascade(cfg, grays, masks, values, state, dt, max_iterations=None):
    """The V-cycle from the warm ``state``: ``plain``'s cascadic solve at
    ``warm_iterations``, then ``polish`` on its level 0. Returns (depth0,
    state)."""
    if cfg["multigrid"] != "vcycle":
        raise ValueError(f"this reference computes the V-cycle only, not {cfg['multigrid']!r}")
    _, st = plain.cascade(dict(cfg, multigrid="cascadic"), grays, masks, values, state, dt,
                          max_iterations=warm_iterations(cfg, max_iterations))
    u = polish(cfg, grays, masks, st[0], dt)
    return u, [u] + list(st[1:])
