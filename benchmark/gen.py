"""Seeded inputs of the benchmark: images, annotations, brush strokes and
batches of pairs. Everything here is numpy from ``numpy.random``
generators seeded by the run's seed, so the same seed gives the same
inputs.

``photo_like`` is the photograph-like generator (``chip_smoke.py`` and the
card tests draw their inputs from here too). ``dense_scribbles`` lays a
4 x 6 grid of 30 x 40 blocks at 1080p, with each block's place jittered
and its depth drawn from the seed. The stroke generator reads a traffic
file's parameters (``traffic/*.json``).
"""

from __future__ import annotations

import numpy as np

DEPTH_KEYS = (0, 64, 128, 192, 254)  # keys '0'..'4': min(key * 64, 254)


def photo_like(rng, h, w):
    """Smooth shading, a few soft-edged discs and fine noise: neighbouring
    pixels differ by a few gray levels but at the discs' edges, as in a
    photograph."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 3), 128.0, np.float32)
    for c in range(3):
        for _ in range(4):
            fx, fy, ph = rng.uniform(0.5, 3.0), rng.uniform(0.5, 3.0), rng.uniform(0.0, 6.28)
            img[..., c] += 25.0 * np.sin(6.2832 * (fx * xx / w + fy * yy / h) + ph)
    for _ in range(8):
        cy, cx, rad = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(80, 300)
        off = rng.uniform(-70, 70, 3).astype(np.float32)
        inside = 1.0 / (1.0 + np.exp(np.clip((np.hypot(yy - cy, xx - cx) - rad) / 2.0, -60, 60)))
        img += inside[..., None] * off
    img += rng.integers(-4, 5, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def dense_scribbles(rng, h, w):
    """A dense annotation, as a user leaves it after many strokes: a 4 x 6
    grid of blocks, 30 x 40 at 1080 rows and scaled with the height, each
    moved by up to a fortieth of the image and given a depth of
    ``DEPTH_KEYS``. Returns (mask bool, value uint8)."""
    mask = np.zeros((h, w), bool)
    value = np.zeros((h, w), np.uint8)
    bh, bw = max(round(30 * h / 1080), 2), max(round(40 * h / 1080), 2)
    jy, jx = max(h // 40, 1), max(w // 40, 1)
    for gy in range(4):
        for gx in range(6):
            y = h // 11 + gy * (h // 4) + int(rng.integers(-jy, jy + 1))
            x = w // 16 + gx * (w // 6) + int(rng.integers(-jx, jx + 1))
            y, x = min(max(y, 0), h - bh), min(max(x, 0), w - bw)
            mask[y:y + bh, x:x + bw] = True
            value[y:y + bh, x:x + bw] = DEPTH_KEYS[int(rng.integers(0, len(DEPTH_KEYS)))]
    return mask, value


def strokes(rng, h, w, traffic, n_updates):
    """``n_updates`` updates of a session's brush traffic. Returns (keys,
    events): keys an (n,) int array of depth keys 0..4, events an (n, e, 2)
    int array of (x, y) paint positions, ``e = traffic["events"]`` per update.

    Each update is one drag from a seeded start: consecutive events lie
    ``step_min``..``step_max`` px apart, in a random direction. The start is
    drawn so that every event lies at least ``margin`` px inside the image."""
    e = int(traffic["events"])
    smin, smax = float(traffic["step_min"]), float(traffic["step_max"])
    margin = int(traffic["margin"])
    keys = rng.integers(0, len(DEPTH_KEYS), n_updates)
    step = rng.uniform(smin, smax, (n_updates, e - 1))
    theta = rng.uniform(0.0, 2 * np.pi, (n_updates, 1))
    dx, dy = step * np.cos(theta), step * np.sin(theta)
    zero = np.zeros((n_updates, 1))
    ox = np.rint(np.concatenate([zero, np.cumsum(dx, axis=1)], axis=1)).astype(np.int64)
    oy = np.rint(np.concatenate([zero, np.cumsum(dy, axis=1)], axis=1)).astype(np.int64)
    lo_x, hi_x = margin - ox.min(axis=1), w - 1 - margin - ox.max(axis=1)
    lo_y, hi_y = margin - oy.min(axis=1), h - 1 - margin - oy.max(axis=1)
    if (hi_x < lo_x).any() or (hi_y < lo_y).any():
        raise ValueError(f"a stroke of {e} events does not fit a {h}x{w} image")
    x0 = lo_x + np.floor(rng.uniform(0, 1, n_updates) * (hi_x - lo_x + 1)).astype(np.int64)
    y0 = lo_y + np.floor(rng.uniform(0, 1, n_updates) * (hi_y - lo_y + 1)).astype(np.int64)
    events = np.stack([x0[:, None] + ox, y0[:, None] + oy], axis=2)
    return keys, events


def brush_side(default, traffic):
    """The brush side after the traffic's ``brush_steps`` presses of the
    GUI's '+' key (+2 px each, from the session's default; none by
    default)."""
    return default + 2 * int(traffic.get("brush_steps", 0))


def pair(seed, k, h, w):
    """Pair ``k`` of a seeded batch: an (rgb, mask, value) ``photo_like``
    image under a ``dense_scribbles`` annotation, from a generator of its
    own, so that pairs can be made in any order and on any thread."""
    rng = np.random.default_rng([seed % (1 << 64), 2, k])
    rgb = photo_like(rng, h, w)
    mask, value = dense_scribbles(rng, h, w)
    return rgb, mask, value


def annotation_plane(mask, value, sentinel):
    """(mask, value) in the annotation PNG's encoding: the value where
    scribbled, the sentinel elsewhere."""
    return np.where(mask, value, np.uint8(sentinel)).astype(np.uint8)
