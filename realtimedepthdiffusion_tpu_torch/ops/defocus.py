"""The defocus effect: kernel K3 (``csrc/defocus.cu``) and its plain version.

Counterpart of ``realtimedepthdiffusion_tpu/ops/pallas_defocus.py`` and of
the defocus half of ``core/effects.py``. ``defocus_box`` (K3) replaces
``_defocus_kernel`` and, as the same output, ``_defocus_kernel_stacked``
and ``_defocus_kernel_coldiff``: ``pallas_defocus_variant`` changes
nothing here. ``defocus_sat`` is the plain twin of ``defocus_xla`` (a
summed-area table, four corners per pixel, one f32 divide), which the CPU
runs and K3 is held to on the card, bit for bit.
"""

from __future__ import annotations

import warnings

import torch

from ..config import DiffusionConfig
from . import build


def resolved_defocus_quality(cfg: DiffusionConfig, max_half: int) -> str:
    """'exact' or 'approx' once 'auto' is resolved: exact while max_half <=
    ``pallas_defocus_auto_max_half``, approx above it, with a warning."""
    q = cfg.pallas_defocus_quality
    if q != "auto":
        return q
    if max_half <= cfg.pallas_defocus_auto_max_half:
        return "exact"
    # The warnings registry shows each distinct message once per call site,
    # so every (max_half, threshold, stride) regime is announced once.
    warnings.warn(
        f"defocus quality 'auto': aperture max_half {max_half} exceeds the "
        f"exact threshold ({cfg.pallas_defocus_auto_max_half}); using the "
        f"bounded-error approx (stride {cfg.pallas_defocus_stride}). Pass "
        "pallas_defocus_quality='exact' to force the exact blur.",
        RuntimeWarning,
        stacklevel=2,
    )
    return "approx"


def _snap_params(cfg: DiffusionConfig, max_half: int):
    """(t, q): halves above t round onto t + j*q; None for 'exact'."""
    if resolved_defocus_quality(cfg, max_half) != "approx":
        return None
    return min(cfg.pallas_defocus_exact_upto, max_half), cfg.pallas_defocus_stride


def defocus_candidates(max_half: int, cfg: DiffusionConfig) -> list:
    """The half-widths a pixel can take: 1..max_half for 'exact'; every half
    up to ``pallas_defocus_exact_upto`` then a stride progression for 'approx'."""
    snap = _snap_params(cfg, max_half)
    if snap is None:
        return list(range(1, max_half + 1))
    t, q = snap
    return list(range(1, t + 1)) + list(range(t + q, max_half + 1, q))


def snap_half_widths(half: torch.Tensor, max_half: int, cfg: DiffusionConfig) -> torch.Tensor:
    """Snap half-widths onto ``defocus_candidates`` (identity for 'exact'):
    halves <= t pass, larger ones round to the nearest stride step (ties
    upward), clamped to the largest candidate."""
    snap = _snap_params(cfg, max_half)
    if snap is None:
        return half
    t, q = snap
    hi = half.to(torch.int32)
    cmax = t + (max_half - t) // q * q
    snapped = torch.clamp(t + torch.div(hi - t + q // 2, q, rounding_mode="floor") * q, t, cmax)
    return torch.where(hi <= t, hi, snapped).to(half.dtype)


def defocus_half_widths(depth: torch.Tensor, full_h: int, full_w: int,
                        cfg: DiffusionConfig = DiffusionConfig()) -> torch.Tensor:
    """Per-pixel window half-width (uint8), in the form K3 pins:
    min(trunc(k * max(d, 0) / 255) // 2, max_half), then the quality snap."""
    k = cfg.defocus_kernel_size(full_h, full_w)
    kd = float(k) * torch.clamp_min(depth.to(torch.float32), 0.0)
    # A device tensor as divisor: on CUDA, torch divides by a Python or CPU
    # scalar as a multiply by its reciprocal, which is not the IEEE divide
    # that K3 and the reference use and can flip a half-width.
    ka = (kd / torch.full((), 255.0, device=kd.device)).to(torch.int32)
    half = torch.clamp_max(torch.div(ka, 2, rounding_mode="floor"), k // 2)
    return snap_half_widths(half, k // 2, cfg).to(torch.uint8)


def defocus_sat(rgb: torch.Tensor, depth: torch.Tensor,
                cfg: DiffusionConfig = DiffusionConfig()) -> torch.Tensor:
    """Plain version of K3 (twin of ``defocus_xla``): (H,W,3) uint8 ->
    (H,W,3) uint8, each pixel the mean over its clipped window
    [y-h, y+h-1] x [x-h, x+h-1], or itself where h == 0."""
    h, w = depth.shape
    dev = depth.device
    half = defocus_half_widths(depth, h, w, cfg).to(torch.int64)
    chw = rgb[..., :3].permute(2, 0, 1)
    # int64: the largest entry, 255*h*w, passes 2^31 - 1 at DCI 4K
    # (2160x4096). K3 keeps 32 bits and wraps; both give the same boxes.
    sat = torch.cumsum(torch.cumsum(chw, dim=1, dtype=torch.int64), dim=2, dtype=torch.int64)
    sat = torch.nn.functional.pad(sat, (1, 0, 1, 0)).reshape(3, -1)  # (3, (h+1)*(w+1))
    yy = torch.arange(h, device=dev)[:, None]
    xx = torch.arange(w, device=dev)[None, :]
    ya = torch.clamp(yy - half, 0, h)
    yb = torch.clamp(yy + half, 0, h)
    xa = torch.clamp(xx - half, 0, w)
    xb = torch.clamp(xx + half, 0, w)

    def corner(y, x):
        return sat[:, y * (w + 1) + x]

    box = corner(yb, xb) - corner(ya, xb) - corner(yb, xa) + corner(ya, xa)
    cnt = ((yb - ya) * (xb - xa)).to(torch.float32)
    out = torch.where(half > 0, box.to(torch.float32) / cnt, chw.to(torch.float32))
    return out.to(torch.uint8).permute(1, 2, 0).contiguous()


def defocus_box(rgb: torch.Tensor, depth: torch.Tensor,
                cfg: DiffusionConfig = DiffusionConfig()) -> torch.Tensor:
    """K3: the defocus of (H,W,3) uint8 ``rgb`` by float32 ``depth`` on the card."""
    h, w = depth.shape
    if not (rgb.is_cuda and depth.is_cuda):
        raise ValueError(
            f"defocus_box: expected CUDA tensors, got {rgb.device} and {depth.device}"
        )
    if rgb.dtype != torch.uint8 or tuple(rgb.shape) != (h, w, 3):
        raise ValueError(f"defocus_box: rgb must be ({h}, {w}, 3) uint8, got "
                         f"{tuple(rgb.shape)} {rgb.dtype}")
    if depth.dtype != torch.float32:
        raise ValueError(f"defocus_box: depth must be float32, got {depth.dtype}")
    rgb = rgb.contiguous()
    depth = depth.contiguous()
    k = cfg.defocus_kernel_size(h, w)
    max_half = k // 2
    snap = _snap_params(cfg, max_half)
    t, q = snap if snap is not None else (0, 0)
    half = torch.empty((h, w), dtype=torch.uint8, device=depth.device)
    # Scratch for K3's SAT, which it reads and writes as unsigned 32-bit.
    sat = torch.empty((3, h + 1, w + 1), dtype=torch.int32, device=depth.device)
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=depth.device)
    lib = build.load_library()
    err = lib.defocus_box(
        rgb.data_ptr(), depth.data_ptr(), half.data_ptr(), sat.data_ptr(),
        out.data_ptr(), h, w, k, max_half, int(snap is not None), t, q,
        torch.cuda.current_stream(depth.device).cuda_stream,
    )
    build.check("defocus_box", err)
    defocus_box.launches += 1
    return out


defocus_box.launches = 0
