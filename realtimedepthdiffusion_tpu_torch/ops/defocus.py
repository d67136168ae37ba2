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

K3 has two routes, picked by ``defocus_route`` from the aperture's
max_half. The tile route is one launch and keeps no table in device
memory: each CTA takes the summed-area table of its own tile's
neighbourhood in shared memory. Where that neighbourhood outgrows one
CTA's shared memory, the table route scans a table of the whole image in
device memory and gathers from it. ``box_blur_tiles_plain`` computes the
tile route's geometry in plain torch, tile by tile, for the CPU tests.

``render_counts`` tallies the whole-image renders, K3's and
``defocus_sat``'s: ``"renders"`` each one, ``"approx"`` those whose
half-widths were snapped (the quality resolved to 'approx'). A render is
counted where it is issued, eagerly or into a capture; a replayed graph
adds its capture's renders again (``utils/program.py``).
"""

from __future__ import annotations

import collections
import warnings

import torch

from ..config import DiffusionConfig
from . import build
from .sweep import SMEM_PER_CTA, _same_device

# The tile sides K3's tile route has an instance for (csrc/defocus.cu): 64
# on 512 threads, 96 on 768.
DEFOCUS_TILES = (64, 96)
# The tile route serves apertures up to this max_half, the last whose
# 96-tile's table fits one CTA's shared memory; the table route serves the
# ones above it. A 64-tile's table fits up to max_half 88, but scans 14
# times the tile there. On an NVIDIA H100 80GB HBM3 at its 700 W limit, at
# 2160x3840 (chip_smoke.py's sweep, device time): at max_half 88, 64-tiles
# 0.690 ms against the table route's 0.617; at 72, 96-tiles 0.391 against
# 0.575.
DEFOCUS_TILE_MAX_HALF = 72
# While two CTAs of 64-tiles share an SM (max_half <= 52) they beat
# 96-tiles, which scan less of their region twice but run one CTA an SM:
# 0.340 against 0.358 ms at max_half 52, and 0.539 against 0.361 at 55,
# where one CTA of 64-tiles is left (the same sweep).
_TWO_CTAS = SMEM_PER_CTA // 2
# Rows per band of the table route's column scan (csrc/defocus.cu).
SAT_BAND_ROWS = 64
render_counts = collections.Counter()


def _tally(snap) -> None:
    render_counts["renders"] += 1
    if snap is not None:
        render_counts["approx"] += 1


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


def defocus_tile_smem(tile: int, max_half: int) -> int:
    """The tile route's shared memory: the 32-bit table of a tile's
    neighbourhood, tile + 2*max_half a side, behind a zero row and column."""
    return 4 * (tile + 2 * max_half + 1) ** 2


def defocus_route(max_half: int, force: str | None = None):
    """K3's route at an aperture of ``max_half``: ("tile", T) while T x T
    tiles' neighbourhoods fit one CTA's shared memory and max_half <=
    ``DEFOCUS_TILE_MAX_HALF``, else ("table", None). ``force`` ("tile" or
    "table") picks the route instead; a forced tile route that does not
    fit raises."""
    if force not in (None, "tile", "table"):
        raise ValueError(f"defocus_route: force must be 'tile' or 'table', got {force!r}")
    fits = [t for t in DEFOCUS_TILES if defocus_tile_smem(t, max_half) <= SMEM_PER_CTA]
    if force == "table" or (force is None and (not fits or max_half > DEFOCUS_TILE_MAX_HALF)):
        return "table", None
    if not fits:
        raise ValueError(f"defocus_route: no tile holds max_half {max_half} in "
                         f"{SMEM_PER_CTA} bytes of shared memory")
    if defocus_tile_smem(fits[0], max_half) <= _TWO_CTAS:
        return "tile", fits[0]
    return "tile", fits[-1]


def _check_route(route, max_half: int):
    kind, tile = route
    if kind == "table" and tile is None:
        return 0
    if (kind != "tile" or tile not in DEFOCUS_TILES
            or defocus_tile_smem(tile, max_half) > SMEM_PER_CTA):
        raise ValueError(f"route {route!r} does not serve max_half {max_half}")
    return tile


def _table_scratch(he: int, we: int, device):
    """The table route's scratch: the 32-bit table (K3 reads and writes it
    as unsigned) and the column scan's totals per band of rows."""
    return [torch.empty((3, he + 1, we + 1), dtype=torch.int32, device=device),
            torch.empty((3, -(-he // SAT_BAND_ROWS), we + 1), dtype=torch.int32, device=device)]


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


def box_blur_tiles_plain(chw: torch.Tensor, half: torch.Tensor, ring: int, oy: int, ox: int,
                         full_h: int, full_w: int, tile: int) -> torch.Tensor:
    """``_box_blur_plain`` the way K3's tile route computes it: every
    tile x tile tile of outputs from the table of its own region alone, the
    tile plus its largest half-width each way, clipped to ``chw``. Sums are
    int32: a region's total stays below 2^24."""
    hb, wb = half.shape
    he, we = hb + 2 * ring, wb + 2 * ring
    dev = half.device
    out = torch.empty((hb, wb, 3), dtype=torch.uint8, device=dev)
    for y0 in range(0, hb, tile):
        for x0 in range(0, wb, tile):
            th, tw = min(tile, hb - y0), min(tile, wb - x0)
            hv = half[y0:y0 + th, x0:x0 + tw].to(torch.int64)
            margin = int(hv.max())
            ty0, tx0 = y0 + ring, x0 + ring
            ry0, rx0 = max(ty0 - margin, 0), max(tx0 - margin, 0)
            region = chw[:, ry0:min(ty0 + th + margin, he), rx0:min(tx0 + tw + margin, we)]
            sat = torch.cumsum(torch.cumsum(region, dim=1, dtype=torch.int32), dim=2,
                               dtype=torch.int32)
            sat = torch.nn.functional.pad(sat, (1, 0, 1, 0))
            ly = torch.arange(th, device=dev)[:, None] + ty0
            lx = torch.arange(tw, device=dev)[None, :] + tx0
            blur = hv > 0
            # half 0 is the pixel itself: the 1 x 1 box, undivided.
            ya = torch.clamp_min(ly - hv, 0) - ry0
            yb = torch.where(blur, torch.clamp_max(ly + hv, he), ly + 1) - ry0
            xa = torch.clamp_min(lx - hv, 0) - rx0
            xb = torch.where(blur, torch.clamp_max(lx + hv, we), lx + 1) - rx0
            box = sat[:, yb, xb] - sat[:, ya, xb] - sat[:, yb, xa] + sat[:, ya, xa]
            gy, gx = ly - ring + oy, lx - ring + ox
            cnt = ((torch.clamp_max(gy + hv, full_h) - torch.clamp_min(gy - hv, 0))
                   * (torch.clamp_max(gx + hv, full_w) - torch.clamp_min(gx - hv, 0)))
            cnt = torch.where(blur, cnt, torch.ones_like(cnt)).to(torch.float32)
            val = (box.to(torch.float32) / cnt).to(torch.uint8)
            out[y0:y0 + th, x0:x0 + tw] = val.permute(1, 2, 0)
    return out


def defocus_sat(rgb: torch.Tensor, depth: torch.Tensor,
                cfg: DiffusionConfig = DiffusionConfig()) -> torch.Tensor:
    """Plain version of K3 (twin of ``defocus_xla``): (H,W,3) uint8 ->
    (H,W,3) uint8, each pixel the mean over its clipped window
    [y-h, y+h-1] x [x-h, x+h-1], or itself where h == 0."""
    h, w = depth.shape
    half = defocus_half_widths(depth, h, w, cfg)
    _tally(_snap_params(cfg, cfg.defocus_kernel_size(h, w) // 2))
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
                  cfg: DiffusionConfig = DiffusionConfig(), route=None) -> torch.Tensor:
    """The defocus of one block of a sharded full_h x full_w image, in
    ``defocus_block_pallas``' layout: ``chw_e`` is the (3, hb+2*ew, wb+2*ew)
    uint8 block with an ew = ``block_ring`` ring of neighbour pixels (zeros
    past the image), ``half`` the interior's (hb, wb) uint8 half-widths from
    ``defocus_half_widths`` on the whole image, (oy, ox) the interior's
    global origin. Returns the interior's (hb, wb, 3) uint8 blur, equal to
    that crop of the whole image's. Plain torch for CPU tensors, K3 for
    CUDA tensors, on ``route`` or else on ``defocus_route`` of the whole
    image's max_half, ew - 1: the ring is exactly the neighbourhood the
    tile route's edge tiles need."""
    if chw_e.device.type == "cpu":
        return defocus_block_sat(chw_e, half, oy, ox, full_h, full_w, cfg)
    if not (chw_e.is_cuda and half.is_cuda):
        raise ValueError(
            f"defocus_block: expected CUDA tensors, got {chw_e.device} and {half.device}"
        )
    _same_device("defocus_block", chw_e=chw_e, half=half)
    ew = _check_block(chw_e, half, full_h, full_w, cfg)
    hb, wb = half.shape
    tile = _check_route(route or defocus_route(ew - 1), ew - 1)
    chw_e = chw_e.contiguous()
    half = half.contiguous()
    scratch = [] if tile else _table_scratch(hb + 2 * ew, wb + 2 * ew, chw_e.device)
    sat, tot = [t.data_ptr() for t in scratch] or [None] * 2
    out = torch.empty((hb, wb, 3), dtype=torch.uint8, device=chw_e.device)
    lib = build.load_library()
    # The launch goes to the current device: make it the tensors' one.
    with torch.cuda.device(chw_e.device):
        err = lib.defocus_block(
            chw_e.data_ptr(), half.data_ptr(), sat, tot, out.data_ptr(), hb, wb, ew,
            int(oy), int(ox), full_h, full_w, ew - 1, tile,
            torch.cuda.current_stream(chw_e.device).cuda_stream,
        )
    build.check("defocus_block", err)
    defocus_block.launches += 1
    return out


defocus_block.launches = 0


def defocus_box(rgb: torch.Tensor, depth: torch.Tensor,
                cfg: DiffusionConfig = DiffusionConfig(), route=None) -> torch.Tensor:
    """K3: the defocus of (H,W,3) uint8 ``rgb`` by float32 ``depth`` on the
    card, on ``route`` or else on ``defocus_route`` of the aperture."""
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
    tile = _check_route(route or defocus_route(max_half), max_half)
    # The table route's scratch: the half-widths, the table and its totals.
    scratch = [] if tile else [torch.empty((h, w), dtype=torch.uint8, device=depth.device),
                               *_table_scratch(h, w, depth.device)]
    half, sat, tot = [t.data_ptr() for t in scratch] or [None] * 3
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=depth.device)
    lib = build.load_library()
    # The launch goes to the current device: make it the tensors' one.
    with torch.cuda.device(depth.device):
        err = lib.defocus_box(
            rgb.data_ptr(), depth.data_ptr(), half, sat, tot, out.data_ptr(), h, w, k,
            max_half, int(snap is not None), t, q, tile,
            torch.cuda.current_stream(depth.device).cuda_stream,
        )
    build.check("defocus_box", err)
    defocus_box.launches += 1
    _tally(snap)
    return out


defocus_box.launches = 0
