"""The plain reference of what the timed path computes, in plain torch.

Written from the reference program's description (the port's own NumPy
oracle, ``oracle/numpy_ref.py``, and the windowed re-solve of
``core/incremental.py``), it imports nothing of the port and takes nothing
the port made: the benchmark hands it the same seeded image, annotation and
stroke events it hands the session, and it derives the planes, pyramids,
weights, solves, effect and u8 map again. Runs on any device; ``dt`` is
the floating type of the solve (float32; bfloat16 for the control).

Departures from the port's arithmetic, each a rounding difference only:
the Jacobi-Chebyshev update is the reference program's
``omega * (gamma * (r - u) + u - prev) + prev`` (the port computes
``a*r + b*u + c*prev``), and nothing here pins an operation order.

The configuration is a plain dict of ``DiffusionConfig`` keys; every key
read here must be in it. What this file does not compute it refuses
(``ValueError``): the approximate defocus, a ``multigrid`` other than
"cascadic", a solver other than red-black and Jacobi-Chebyshev.

The interface the drivers call (``INTERFACE``). A configuration held to
other maths has a file of its own, ``reference/<config>.py``
(``spec.reference``), that provides every one of these, imported from
here (``from benchmark.reference.plain import *``) or defined anew:

- ``rgb_to_gray(rgb)``: (H, W, 3) uint8 -> (H, W) uint8;
- ``gray_pyramid(cfg, gray0)``: the list of gray levels, finest first;
- ``annotation_pyramids(cfg, mask0, value0)``: (masks, values), lists of
  bool and uint8 levels;
- ``cascade(cfg, grays, masks, values, state, dt, max_iterations=None)``:
  the full solve from the warm ``state`` (a list of levels); (depth0,
  state);
- ``windowed(cfg, grays, masks, values, state, center, dt)``: the
  windowed re-solve of one edit at level-0 ``center`` (y, x); (depth0,
  state);
- ``defocus(cfg, rgb, depth)``: the effect image, (H, W, 3) uint8;
- ``to_u8(depth)``: the u8 depth map;
- ``brush_radius(cfg, h, w)``: the session's default brush side, int;
- ``scribble_value(key)``: the depth a key 0..4 paints, int;
- ``paint(mask, value, x, y, color, radius)``: one dab on numpy planes, in
  place; its rect (y0, x0, y1, x1) or None;
- ``merge_rect(rects, rect, kmax, gap=8)``: the session's dirty-rect rule,
  in place on the list ``rects``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

INTERFACE = ("rgb_to_gray", "gray_pyramid", "annotation_pyramids", "cascade", "windowed",
             "defocus", "to_u8", "brush_radius", "scribble_value", "paint", "merge_rect")
_TINY = float(np.finfo(np.float32).tiny)


# --------------------------------------------------------------- geometry
def num_levels(cfg, h, w):
    q = max(min(h, w) // int(cfg["pyramid_base_size"]), 1)
    return int(math.log2(q)) + 1


def level_sizes(cfg, h, w):
    return [(h >> l, w >> l) for l in range(num_levels(cfg, h, w))]


def level_iterations(max_iterations, levels, level):
    return int(max_iterations / (2.0 ** ((levels - 1) - level)))


def brush_radius(cfg, h, w):
    return int(min(h, w) * float(cfg["brush_fraction"]))


def scribble_value(key):
    return min(int(key) * 64, 254)


# ------------------------------------------------------------ annotations
def paint(mask, value, x, y, color, radius):
    """Square brush on numpy planes, in place; returns the rect (y0, x0,
    y1, x1) or None: |px - x| <= radius // 2 and |py - y| <= radius // 2."""
    h, w = mask.shape
    half = max(int(radius), 0) // 2
    y0, y1 = max(y - half, 0), min(y + half, h - 1)
    x0, x1 = max(x - half, 0), min(x + half, w - 1)
    if y0 > y1 or x0 > x1:
        return None
    mask[y0:y1 + 1, x0:x1 + 1] = True
    value[y0:y1 + 1, x0:x1 + 1] = color
    return (y0, x0, y1, x1)


def merge_rect(rects, rect, kmax, gap=8):
    """The live session's dirty-rect rule: a new rect absorbs every pending
    rect within ``gap`` px of it; past ``kmax`` rects the two whose centres
    lie nearest (in city-block distance) merge."""
    def near(a, b):
        return not (a[2] + gap < b[0] or b[2] + gap < a[0]
                    or a[3] + gap < b[1] or b[3] + gap < a[1])

    def union(a, b):
        return (min(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]), max(a[3], b[3]))

    cur = tuple(rect)
    merged = True
    while merged:
        merged = False
        for i, r in enumerate(rects):
            if near(cur, r):
                cur = union(cur, r)
                rects.pop(i)
                merged = True
                break
    rects.append(cur)
    while len(rects) > max(int(kmax), 1):
        best = None
        for i in range(len(rects)):
            for j in range(i + 1, len(rects)):
                a, b = rects[i], rects[j]
                d = abs((a[0] + a[2]) - (b[0] + b[2])) + abs((a[1] + a[3]) - (b[1] + b[3]))
                if best is None or d < best[0]:
                    best = (d, i, j)
        _, i, j = best
        rects[i] = union(rects[i], rects[j])
        rects.pop(j)
    return rects


# ---------------------------------------------------------------- pyramids
def rgb_to_gray(rgb):
    x = rgb.to(torch.int64)
    return ((x[..., 0] * 9798 + x[..., 1] * 19235 + x[..., 2] * 3735 + 16384) >> 15).to(torch.uint8)


def _reflect_index(n, pad, device):
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * n - 2
    m = torch.remainder(i, period)
    return torch.where(m < n, m, period - m)


def _reflect_pad2(a):
    a = a.index_select(0, _reflect_index(a.shape[0], 2, a.device))
    return a.index_select(1, _reflect_index(a.shape[1], 2, a.device))


def pyr_down_ceil(gray):
    """OpenCV's 8-bit pyrDown to the ceil size: [1 4 6 4 1]/16 per axis,
    reflect-101, round half up, integer."""
    h, w = gray.shape
    oh, ow = (h + 1) // 2, (w + 1) // 2
    k = (1, 4, 6, 4, 1)
    p = _reflect_pad2(gray.to(torch.int64))
    acc = torch.zeros((h + 4, ow), dtype=torch.int64, device=gray.device)
    for t in range(5):
        acc += k[t] * p[:, t:t + 2 * ow:2]
    out = torch.zeros((oh, ow), dtype=torch.int64, device=gray.device)
    for t in range(5):
        out += k[t] * acc[t:t + 2 * oh:2, :]
    return ((out + 128) >> 8).to(torch.uint8)


def gray_pyramid(cfg, gray0):
    """The "opencv" chain (ceil sizes, each level cropped to the floor
    size) or the "floor" chain."""
    h, w = gray0.shape
    sizes = level_sizes(cfg, h, w)
    pyr, full = [gray0], gray0
    for l in range(1, len(sizes)):
        if cfg["gray_pyramid"] == "opencv":
            full = pyr_down_ceil(full)
            pyr.append(full[:sizes[l][0], :sizes[l][1]].contiguous())
        elif cfg["gray_pyramid"] == "floor":
            pyr.append(pyr_down_ceil(pyr[-1])[:sizes[l][0], :sizes[l][1]].contiguous())
        else:
            raise ValueError(f"gray_pyramid {cfg['gray_pyramid']!r}")
    return pyr


def annotation_down(mask, value, out_shape):
    """Coarse (y, x) takes the last masked pixel, in row-major order, of
    fine {2y-1, 2y} x {2x-1, 2x}."""
    oh, ow = out_shape
    h, w = mask.shape
    dev = mask.device
    out_m = torch.zeros((oh, ow), dtype=torch.bool, device=dev)
    out_v = torch.zeros((oh, ow), dtype=torch.uint8, device=dev)
    ys, xs = torch.arange(oh, device=dev), torch.arange(ow, device=dev)
    for dy in (-1, 0):
        for dx in (-1, 0):
            py, px = 2 * ys + dy, 2 * xs + dx
            yv, xv = (py >= 0) & (py < h), (px >= 0) & (px < w)
            pyc, pxc = py.clamp(0, h - 1), px.clamp(0, w - 1)
            m = mask[pyc][:, pxc] & yv[:, None] & xv[None, :]
            out_v = torch.where(m, value[pyc][:, pxc], out_v)
            out_m |= m
    return out_m, out_v


def annotation_pyramids(cfg, mask0, value0):
    h, w = mask0.shape
    masks, values = [mask0], [value0]
    for s in level_sizes(cfg, h, w)[1:]:
        m, v = annotation_down(masks[-1], values[-1], s)
        masks.append(m)
        values.append(v)
    return masks, values


def pyr_up(src, out_shape):
    """pyrUp: zero-insert, reflect-101, [1 4 6 4 1]/8 per axis; an odd
    height repeats the last even output row, an odd width takes the last
    source column."""
    def axis_up(a, n_out, odd_copy_out):
        h = a.shape[0]
        z = torch.zeros((2 * h,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        z[0::2] = a
        zp = z.index_select(0, _reflect_index(2 * h, 2, a.device))
        out = (zp[0:2 * h] + 4.0 * zp[1:2 * h + 1] + 6.0 * zp[2:2 * h + 2]
               + 4.0 * zp[3:2 * h + 3] + zp[4:2 * h + 4]) * 0.125
        if n_out == 2 * h + 1:
            extra = out[2 * h - 2:2 * h - 1] if odd_copy_out else a[h - 1:h]
            out = torch.cat([out, extra], dim=0)
        return out[:n_out]

    oh, ow = out_shape
    t = axis_up(src, oh, True)
    return axis_up(t.t(), ow, False).t().contiguous()


def seed(depth, mask, value):
    return torch.where(mask, value.to(depth.dtype), depth)


# ------------------------------------------------------------------ solve
def edge_weights(cfg, gray, depth, level, max_level, dt):
    """(wl, wr, wu, wd, inv): exp(-beta |dgray|) between neighbours, 0 past
    the border and where subnormal; below the coarsest level 1.0 where the
    clipped, truncated depths differ by at most the threshold (0 at level
    0); inv = 1 / sum, 0 where the sum is subnormal."""
    g = gray.to(torch.int32)
    beta = float(np.float32(cfg["beta"]))

    def base(sad):
        w = torch.exp(-beta * sad.to(torch.float32))
        return torch.where(w >= _TINY, w, torch.zeros_like(w))

    bh, bv = base((g[:, 1:] - g[:, :-1]).abs()), base((g[1:, :] - g[:-1, :]).abs())
    if level != max_level:
        thr = 0 if level == 0 else int(cfg["depth_edge_threshold"])
        d8 = depth.to(torch.float32).clamp(0.0, 255.0).to(torch.uint8).to(torch.int32)
        bh = torch.where((d8[:, 1:] - d8[:, :-1]).abs() > thr, bh, torch.ones_like(bh))
        bv = torch.where((d8[1:, :] - d8[:-1, :]).abs() > thr, bv, torch.ones_like(bv))
    wl, wr = F.pad(bh, (1, 0)), F.pad(bh, (0, 1))
    wu, wd = F.pad(bv, (0, 0, 1, 0)), F.pad(bv, (0, 0, 0, 1))
    count = wl + wr + wu + wd
    inv = torch.where(count >= _TINY, 1.0 / count, torch.zeros_like(count))
    return tuple(t.to(dt) for t in (wl, wr, wu, wd, inv))


def relax(u, wts):
    """clip((wl*ul + wr*ur + wu*uu + wd*ud) * inv, 0, 255); a neighbour
    past the border reads 0."""
    wl, wr, wu, wd, inv = wts
    s = wl * F.pad(u[:, :-1], (1, 0))
    s = s + wr * F.pad(u[:, 1:], (0, 1))
    s = s + wu * F.pad(u[:-1, :], (0, 0, 1, 0))
    s = s + wd * F.pad(u[1:, :], (0, 0, 0, 1))
    return (s * inv).clamp(0.0, 255.0)


def chebyshev_omegas(cfg, iters):
    s = int(cfg["chebyshev_s"])
    rho2 = np.float32(cfg["chebyshev_rho"]) * np.float32(cfg["chebyshev_rho"])
    out, omega = [], np.float32(0.0)
    for i in range(iters):
        if i < s:
            omega = np.float32(1.0)
        elif i == s:
            omega = np.float32(2.0 / (2.0 - np.float64(rho2)))
        else:
            omega = np.float32(4.0 / (4.0 - np.float64(rho2 * omega)))
        out.append(float(omega))
    return out


def rb_omegas(cfg, iters):
    out = [[1.0, 1.0] for _ in range(iters)]
    if cfg["rb_chebyshev"]:
        rho2 = float(np.float32(cfg["rb_rho"])) ** 2
        s, omega = int(cfg["chebyshev_s"]), 1.0
        for half in range(2 * iters):
            if half < s:
                omega = 1.0
            elif half == s:
                omega = 1.0 / (1.0 - rho2 / 2.0)
            else:
                omega = 1.0 / (1.0 - rho2 * omega / 4.0)
            out[half // 2][half % 2] = float(np.float32(omega))
    return out


def residual(cfg, u, mask, wts):
    """The early exit's residual of relax(u) - u off the scribbles: the
    root mean square ("rms") or the max norm ("max")."""
    r = torch.where(mask, torch.zeros_like(u), relax(u, wts) - u).to(torch.float32)
    if cfg["residual_metric"] == "max":
        return float(r.abs().max())
    cnt = max(float((~mask).sum()), 1.0)
    return math.sqrt(float((r * r).sum()) / cnt)


def solve_level(cfg, depth, mask, gray, level, max_level, iters, dt):
    """``iters`` iterations of ``cfg["solver"]`` from the seeded ``depth``
    (scribbles never move), the weights taken from the incoming depth;
    under the early exit, in chunks of ``residual_check_every`` with the
    residual probed after each, stopping below ``tolerance * 255``."""
    if iters <= 0:
        return depth
    wts = edge_weights(cfg, gray, depth, level, max_level, dt)
    u = depth.to(dt)
    solver = cfg["solver"]
    if solver == "red_black":
        yy = torch.arange(u.shape[0], device=u.device)[:, None]
        xx = torch.arange(u.shape[1], device=u.device)[None, :]
        red = (yy + xx) % 2 == 0
        free_r, free_b = red & ~mask, ~red & ~mask
        table = rb_omegas(cfg, iters)
    elif solver == "jacobi_chebyshev":
        table = chebyshev_omegas(cfg, iters)
        gamma = float(np.float32(cfg["chebyshev_gamma"]))
        prev = torch.zeros_like(u)
    else:
        raise ValueError(f"the reference has no solver {solver!r}")
    chunk = max(int(cfg["residual_check_every"]), 1) if cfg["early_exit"] else iters
    tol = float(np.float32(cfg["tolerance"]) * np.float32(255.0))
    for base in range(0, iters, chunk):
        for i in range(base, min(base + chunk, iters)):
            if solver == "red_black":
                om_r, om_b = table[i]
                r = relax(u, wts)
                u = torch.where(free_r, (u + om_r * (r - u)).clamp(0.0, 255.0), u)
                r = relax(u, wts)
                u = torch.where(free_b, (u + om_b * (r - u)).clamp(0.0, 255.0), u)
            else:
                omega = table[i]
                r = relax(u, wts)
                out = omega * (gamma * (r - u) + u - prev) + prev
                prev, u = u, torch.where(mask, u, out)
        if cfg["early_exit"]:
            res = residual(cfg, u, mask, wts)
            if not res >= tol:  # NaN stops too
                break
    return u


def cascade(cfg, grays, masks, values, state, dt, max_iterations=None):
    """Coarse to fine from the warm ``state``: seed the coarsest level,
    solve each level, pyrUp into the next and seed it. Returns (depth0,
    state)."""
    if cfg["multigrid"] != "cascadic":
        raise ValueError(f"the reference computes the cascadic scheme only, not "
                         f"{cfg['multigrid']!r}")
    iters_cap = int(cfg["max_iterations"] if max_iterations is None else max_iterations)
    levels = len(grays)
    L = levels - 1
    st = [s.to(dt) for s in state]
    st[L] = seed(st[L], masks[L], values[L])
    for level in range(L, -1, -1):
        st[level] = solve_level(cfg, st[level], masks[level], grays[level], level, L,
                                level_iterations(iters_cap, levels, level), dt)
        if level > 0:
            up = pyr_up(st[level], tuple(grays[level - 1].shape))
            st[level - 1] = seed(up, masks[level - 1], values[level - 1])
    return st[0], st


def windowed(cfg, grays, masks, values, state, center, dt):
    """The windowed re-solve of one edit at level-0 ``center`` (y, x): the
    coarse levels re-solve whole at the cascade's budget; each fine level
    (``incremental_window_levels`` of them, where the window is smaller
    than the level) first takes the coarser level's change, pyrUp'd, over
    its whole extent, then re-solves a window of ``incremental_window >>
    level`` px around the edit, clamped inside the level, at
    ``incremental_iterations >> level`` iterations with the window's
    border ring held fixed and weights from the window's own crop."""
    levels = len(grays)
    L = levels - 1
    inc = int(cfg["incremental_iterations"]) or int(cfg["max_iterations"])
    st = [s.to(dt) for s in state]
    delta = None
    for level in range(L, -1, -1):
        h, w = grays[level].shape
        win = int(cfg["incremental_window"]) >> level
        old = st[level]
        u = old if delta is None else old + pyr_up(delta, (h, w))
        u = seed(u, masks[level], values[level])
        if not (level < int(cfg["incremental_window_levels"]) and win < min(h, w)):
            st[level] = solve_level(cfg, u, masks[level], grays[level], level, L,
                                    level_iterations(int(cfg["max_iterations"]), levels, level),
                                    dt)
            delta = st[level] - old
            continue
        iters = max(inc >> level, 1)
        n_glob = min(int(cfg["incremental_global_smooth"]), iters)
        if n_glob > 0:
            u = solve_level(cfg, u, masks[level], grays[level], level, L, n_glob, dt)
        oy = min(max((center[0] >> level) - win // 2, 0), h - win)
        ox = min(max((center[1] >> level) - win // 2, 0), w - win)
        ring = torch.zeros((win, win), dtype=torch.bool, device=u.device)
        ring[0, :] = ring[-1, :] = ring[:, 0] = ring[:, -1] = True
        crop = (slice(oy, oy + win), slice(ox, ox + win))
        u_w = solve_level(cfg, u[crop].contiguous(), masks[level][crop] | ring,
                          grays[level][crop].contiguous(), level, L, iters, dt)
        new = u.clone()
        new[crop] = u_w
        st[level] = new
        delta = new - old
    return st[0], st


# ---------------------------------------------------------------- effects
def defocus(cfg, rgb, depth):
    """Depth-proportional box blur of the clipped depth: half-width
    int(k * depth / 255) // 2 with k = int(aperture * diagonal); window
    [y - half, y + half - 1] clipped to the image; the mean of the box,
    truncated; an empty window keeps the pixel. Exact box sums in int64."""
    h, w = depth.shape
    k = int(float(cfg["defocus_aperture"]) * math.sqrt(h * h + w * w))
    quality = cfg["pallas_defocus_quality"]
    if quality == "approx" or (quality == "auto" and k // 2 > int(cfg["pallas_defocus_auto_max_half"])):
        raise ValueError("the reference computes the exact defocus only")
    d = depth.to(torch.float32).clamp(0.0, 255.0)
    c255 = torch.full((), 255.0, device=d.device)
    half = ((float(k) * d) / c255).to(torch.int32) // 2
    sat = torch.zeros((h + 1, w + 1, 3), dtype=torch.int64, device=d.device)
    sat[1:, 1:] = rgb.to(torch.int64).cumsum(0).cumsum(1)
    yy = torch.arange(h, device=d.device)[:, None].expand(h, w)
    xx = torch.arange(w, device=d.device)[None, :].expand(h, w)
    y0, y1 = (yy - half).clamp(min=0), (yy + half - 1).clamp(max=h - 1)
    x0, x1 = (xx - half).clamp(min=0), (xx + half - 1).clamp(max=w - 1)
    cnt = ((y1 - y0 + 1) * (x1 - x0 + 1)).clamp(min=1)
    y0c, y1c = y0.clamp(0, h - 1), y1.clamp(0, h - 1)
    x0c, x1c = x0.clamp(0, w - 1), x1.clamp(0, w - 1)
    box = sat[y1c + 1, x1c + 1] - sat[y0c, x1c + 1] - sat[y1c + 1, x0c] + sat[y0c, x0c]
    mean = (box.to(torch.float32) / cnt.to(torch.float32)[..., None]).to(torch.uint8)
    empty = (half == 0) | (y0 > y1) | (x0 > x1)
    return torch.where(empty[..., None], rgb, mean)


def to_u8(depth):
    """round half to even, then clip to [0, 255]."""
    return torch.round(depth.to(torch.float32)).clamp(0, 255).to(torch.uint8)
