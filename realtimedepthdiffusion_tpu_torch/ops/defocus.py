"""The defocus effect: kernel K3 (``csrc/defocus.cu``) and its plain version.

Counterpart of ``realtimedepthdiffusion_tpu/ops/pallas_defocus.py`` and of
the defocus half of ``core/effects.py``. ``defocus_box`` (K3) replaces
``_defocus_kernel`` and, as the same output, ``_defocus_kernel_stacked``
and ``_defocus_kernel_coldiff``: ``pallas_defocus_variant`` changes
nothing here. ``defocus_sat`` is the plain twin of ``defocus_xla`` (a
summed-area table, four corners per pixel, one f32 divide), which the CPU
runs and K3 is held to on the card, bit for bit.

``defocus_block`` runs K3 on one block of a sharded image, extended by a
ring of neighbour pixels, with the block's global origin and the whole
image's size; it replaces ``defocus_block_pallas`` and keeps its layout.
``defocus_block_sat`` is its plain version. A whole image is the block
with ring 0, origin (0, 0) and its own size.
"""

from __future__ import annotations

import warnings

import torch

from ..config import DiffusionConfig
from . import build
from .sweep import _same_device


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


def _box_blur_plain(chw: torch.Tensor, half: torch.Tensor, ring: int, oy: int, ox: int,
                    full_h: int, full_w: int) -> torch.Tensor:
    """The blur of the (hb, wb) interior at (ring, ring) of the (3, hb+2*ring,
    wb+2*ring) uint8 image ``chw``, which sits at (oy, ox) in a full_h x
    full_w image: each pixel the mean over its window [y-h, y+h-1] x
    [x-h, x+h-1], summed in ``chw`` and counted clipped to the whole image,
    or itself where h == 0. Returns (hb, wb, 3) uint8."""
    hb, wb = half.shape
    he, we = hb + 2 * ring, wb + 2 * ring
    dev = half.device
    hv = half.to(torch.int64)
    # int64: the largest entry, 255*h*w, passes 2^31 - 1 at DCI 4K
    # (2160x4096). K3 keeps 32 bits and wraps; both give the same boxes.
    sat = torch.cumsum(torch.cumsum(chw, dim=1, dtype=torch.int64), dim=2, dtype=torch.int64)
    sat = torch.nn.functional.pad(sat, (1, 0, 1, 0)).reshape(3, -1)  # (3, (he+1)*(we+1))
    yy = torch.arange(hb, device=dev)[:, None]
    xx = torch.arange(wb, device=dev)[None, :]
    ya = torch.clamp(yy + ring - hv, 0, he)
    yb = torch.clamp(yy + ring + hv, 0, he)
    xa = torch.clamp(xx + ring - hv, 0, we)
    xb = torch.clamp(xx + ring + hv, 0, we)

    def corner(y, x):
        return sat[:, y * (we + 1) + x]

    box = corner(yb, xb) - corner(ya, xb) - corner(yb, xa) + corner(ya, xa)
    gy, gx = yy + oy, xx + ox
    cnt = ((torch.clamp_max(gy + hv, full_h) - torch.clamp_min(gy - hv, 0))
           * (torch.clamp_max(gx + hv, full_w) - torch.clamp_min(gx - hv, 0))).to(torch.float32)
    centre = chw[:, ring:ring + hb, ring:ring + wb]
    out = torch.where(hv > 0, box.to(torch.float32) / cnt, centre.to(torch.float32))
    return out.to(torch.uint8).permute(1, 2, 0).contiguous()


def defocus_sat(rgb: torch.Tensor, depth: torch.Tensor,
                cfg: DiffusionConfig = DiffusionConfig()) -> torch.Tensor:
    """Plain version of K3 (twin of ``defocus_xla``): (H,W,3) uint8 ->
    (H,W,3) uint8, each pixel the mean over its clipped window
    [y-h, y+h-1] x [x-h, x+h-1], or itself where h == 0."""
    h, w = depth.shape
    half = defocus_half_widths(depth, h, w, cfg)
    return _box_blur_plain(rgb[..., :3].permute(2, 0, 1), half, 0, 0, 0, h, w)


def block_ring(full_h: int, full_w: int, cfg: DiffusionConfig = DiffusionConfig()) -> int:
    """The ring a block of a full_h x full_w image carries for the defocus:
    max_half + 1 of the whole image's aperture, wider than any window."""
    return cfg.defocus_kernel_size(full_h, full_w) // 2 + 1


def _check_block(chw_e: torch.Tensor, half: torch.Tensor, full_h: int, full_w: int,
                 cfg: DiffusionConfig) -> int:
    ew = block_ring(full_h, full_w, cfg)
    hb, wb = half.shape
    if tuple(chw_e.shape) != (3, hb + 2 * ew, wb + 2 * ew):
        raise ValueError(
            f"defocus_block: the extended block is {tuple(chw_e.shape)}, expected "
            f"{(3, hb + 2 * ew, wb + 2 * ew)} (interior {(hb, wb)} and a {ew}-wide ring)"
        )
    if chw_e.dtype != torch.uint8 or half.dtype != torch.uint8:
        raise ValueError(f"defocus_block: expected uint8, got {chw_e.dtype} and {half.dtype}")
    return ew


def defocus_block_sat(chw_e: torch.Tensor, half: torch.Tensor, oy: int, ox: int,
                      full_h: int, full_w: int,
                      cfg: DiffusionConfig = DiffusionConfig()) -> torch.Tensor:
    """Plain version of ``defocus_block``."""
    ew = _check_block(chw_e, half, full_h, full_w, cfg)
    return _box_blur_plain(chw_e, half, ew, int(oy), int(ox), full_h, full_w)


def defocus_block(chw_e: torch.Tensor, half: torch.Tensor, oy: int, ox: int,
                  full_h: int, full_w: int,
                  cfg: DiffusionConfig = DiffusionConfig()) -> torch.Tensor:
    """The defocus of one block of a sharded full_h x full_w image, in
    ``defocus_block_pallas``' layout: ``chw_e`` is the (3, hb+2*ew, wb+2*ew)
    uint8 block with an ew = ``block_ring`` ring of neighbour pixels (zeros
    past the image), ``half`` the interior's (hb, wb) uint8 half-widths from
    ``defocus_half_widths`` on the whole image, (oy, ox) the interior's
    global origin. Returns the interior's (hb, wb, 3) uint8 blur, equal to
    that crop of the whole image's. Plain torch for CPU tensors, K3 for
    CUDA tensors."""
    if chw_e.device.type == "cpu":
        return defocus_block_sat(chw_e, half, oy, ox, full_h, full_w, cfg)
    if not (chw_e.is_cuda and half.is_cuda):
        raise ValueError(
            f"defocus_block: expected CUDA tensors, got {chw_e.device} and {half.device}"
        )
    _same_device("defocus_block", chw_e=chw_e, half=half)
    ew = _check_block(chw_e, half, full_h, full_w, cfg)
    hb, wb = half.shape
    chw_e = chw_e.contiguous()
    half = half.contiguous()
    sat = torch.empty((3, hb + 2 * ew + 1, wb + 2 * ew + 1), dtype=torch.int32,
                      device=chw_e.device)
    out = torch.empty((hb, wb, 3), dtype=torch.uint8, device=chw_e.device)
    lib = build.load_library()
    # The launch goes to the current device: make it the tensors' one.
    with torch.cuda.device(chw_e.device):
        err = lib.defocus_block(
            chw_e.data_ptr(), half.data_ptr(), sat.data_ptr(), out.data_ptr(), hb, wb, ew,
            int(oy), int(ox), full_h, full_w,
            torch.cuda.current_stream(chw_e.device).cuda_stream,
        )
    build.check("defocus_block", err)
    defocus_block.launches += 1
    return out


defocus_block.launches = 0


def defocus_box(rgb: torch.Tensor, depth: torch.Tensor,
                cfg: DiffusionConfig = DiffusionConfig()) -> torch.Tensor:
    """K3: the defocus of (H,W,3) uint8 ``rgb`` by float32 ``depth`` on the card."""
    h, w = depth.shape
    if not (rgb.is_cuda and depth.is_cuda):
        raise ValueError(
            f"defocus_box: expected CUDA tensors, got {rgb.device} and {depth.device}"
        )
    _same_device("defocus_box", rgb=rgb, depth=depth)
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
    # The launch goes to the current device: make it the tensors' one.
    with torch.cuda.device(depth.device):
        err = lib.defocus_box(
            rgb.data_ptr(), depth.data_ptr(), half.data_ptr(), sat.data_ptr(),
            out.data_ptr(), h, w, k, max_half, int(snap is not None), t, q,
            torch.cuda.current_stream(depth.device).cuda_stream,
        )
    build.check("defocus_box", err)
    defocus_box.launches += 1
    return out


defocus_box.launches = 0
