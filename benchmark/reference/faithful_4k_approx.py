"""The plain reference of ``faithful_4k_approx``: the live session at
2160x3840 with every setting at the repo's default, whose ``"auto"``
defocus resolves to the approximate blur, in plain torch.

Every function of ``plain.INTERFACE`` but ``defocus`` is ``plain``'s.
``defocus`` is ``plain.defocus``'s box blur, with the half-widths snapped
first, written from the approximation's rule:

- the aperture k = int(``defocus_aperture`` * diagonal) and a pixel's
  half-width int(k * depth / 255) // 2 of the clipped depth, as in
  ``plain``; the largest, ``k // 2``, is max_half;
- the quality: ``pallas_defocus_quality`` "exact" or "approx" as given;
  "auto" is exact while max_half <= ``pallas_defocus_auto_max_half`` and
  approximate above it;
- approximate: with t = min(``pallas_defocus_exact_upto``, max_half) and
  q = ``pallas_defocus_stride``, a half-width h <= t stays; a larger one
  goes to the nearest of t + q, t + 2q, ..., ties to the larger,
  t + floor((h - t + q // 2) / q) * q, and no further than the largest
  such step within max_half, t + (max_half - t) // q * q (at 4K, max_half
  55, t 16, q 4: 20, 24, ..., 52);
- then the box of the snapped half-width, its mean truncated, the pixel
  itself where the half-width is 0 (``plain.defocus``).

Departures from ``plain.defocus``: none in the box; the exact blur is the
approximate one's special case with no snap, so this ``defocus`` equals
``plain``'s wherever the quality resolves to exact. Nothing here or in the
code it judges multiplies matrices or convolves, but TF32 is turned off
for both at import, so that no such rounding could enter the comparison.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.plain import (  # noqa: F401  (plain.INTERFACE, kept)
    annotation_pyramids, brush_radius, cascade, gray_pyramid, merge_rect, paint, rgb_to_gray,
    scribble_value, to_u8, windowed)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def aperture(cfg, h, w):
    """k, the widest window of an h x w image."""
    return int(float(cfg["defocus_aperture"]) * math.sqrt(h * h + w * w))


def quality(cfg, max_half):
    """"exact" or "approx" once "auto" is resolved at ``max_half``."""
    q = cfg["pallas_defocus_quality"]
    if q == "auto":
        return "exact" if max_half <= int(cfg["pallas_defocus_auto_max_half"]) else "approx"
    if q not in ("exact", "approx"):
        raise ValueError(f"pallas_defocus_quality {q!r}")
    return q


def snap(cfg, half, max_half):
    """The half-widths ``half`` (int) as the approximate blur takes them
    (the module's docstring); unchanged where the quality is exact."""
    if quality(cfg, max_half) == "exact":
        return half
    t = min(int(cfg["pallas_defocus_exact_upto"]), max_half)
    q = int(cfg["pallas_defocus_stride"])
    top = t + (max_half - t) // q * q
    step = t + torch.div(half - t + q // 2, q, rounding_mode="floor") * q
    return torch.where(half <= t, half, step.clamp(t, top))


def defocus(cfg, rgb, depth):
    """Depth-proportional box blur of the clipped depth with the snapped
    half-widths: window [y - half, y + half - 1] clipped to the image; the
    mean of the box, truncated; an empty window keeps the pixel. Exact box
    sums in int64."""
    h, w = depth.shape
    k = aperture(cfg, h, w)
    d = depth.to(torch.float32).clamp(0.0, 255.0)
    c255 = torch.full((), 255.0, device=d.device)
    half = snap(cfg, ((float(k) * d) / c255).to(torch.int32) // 2, k // 2)
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
