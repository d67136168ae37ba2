"""The V-cycle's error smoother: kernels ``vc_smooth_tiles`` and ``vc_smooth_resident`` (``csrc/vc_smooth.cu``) and their plain version.

A smoothing pass of ``core/multigrid.py:vcycle_polish`` (a pre- or
post-smoothing on a finer level, or the coarsest level's solve) runs
``sweeps`` Jacobi sweeps of the error equation (I - M) e = rhs, e = 0 on
scribbles. The JAX package runs them in plain XLA ops, so these kernels
replace no Pallas kernel; they take the place of the 17 kernels a plain
sweep runs on the card.

- ``smooth_plain`` is the pass in torch ops. The CPU runs it; on the card
  the kernels are held to it, bit for bit.
- ``smooth_plan`` picks a pass's route and its launches from the level's
  shape and the pass's sweeps, on the host: the resident route (one CTA
  holds the level whole and runs every sweep in one launch) where
  ``resident_fits``, else the tile route (K1's temporally blocked
  tile, ``k`` sweeps a launch with a ``k``-pixel ring recomputed, ``k`` the
  pass's sweeps up to ``MAX_TILE_SWEEPS``, the rest in chunks).
- ``smooth_cuda`` runs a pass on the kernels by that plan; it launches on
  the current stream, syncs nothing and allocates only through torch, so a
  CUDA graph can hold it. ``ops/dispatch.py:smooth_error`` picks it or the
  plain version by the tensors' device.

``vc_smooth_tiles.launches`` and ``vc_smooth_resident.launches`` count the
kernels' launches.
"""

from __future__ import annotations

import torch

from . import build
from .sweep import SMEM_PER_CTA, _check, _same_device, _stream, average_plain

# The tile route's deepest ring: its CTA is K1's shallow tile, 64 x 8 threads
# of 8 rows (``csrc/vc_smooth.cu``), which keeps a 32 x 32 interior at 16.
MAX_TILE_SWEEPS = 16
# The resident route's CTA: a warp's multiple of columns across and as many
# thread rows of RESIDENT_ROWS pixels as the level needs, on at most
# RESIDENT_THREADS threads (1080p's and 4K's coarsest level, 67 x 120: 128 x
# 8 threads).
RESIDENT_ROWS = 9
RESIDENT_THREADS = 1024


def smooth_plain(e, rhs, mask, wts, sweeps: int):
    """``sweeps`` Jacobi sweeps of (I - M) e = rhs from ``e``, e = 0 where
    the bool ``mask`` is set, in torch ops: the weighted average of the four
    neighbours (``average_plain``), plus rhs. The pass the kernels compute."""
    for _ in range(sweeps):
        e = torch.where(mask, 0.0, average_plain(e, wts.wl, wts.wr, wts.wu, wts.wd,
                                                 wts.inv_count) + rhs)
    return e


def _smem(eh: int, ew: int) -> int:
    """Shared memory (bytes) of a tile of eh x ew: two buffers of e with a
    one-pixel ring (``csrc/vc_smooth.cu:vc_smem``)."""
    return 8 * (eh + 2) * (ew + 2)


def resident_fits(h: int, w: int) -> bool:
    """Whether the resident CTA's threads and shared memory hold an (h, w)
    level (``csrc/vc_smooth.cu:vc_resident_cta``)."""
    bx, by = -(-w // 32) * 32, -(-h // RESIDENT_ROWS)
    return bx * by <= RESIDENT_THREADS and _smem(by * RESIDENT_ROWS, bx) <= SMEM_PER_CTA


def smooth_plan(h: int, w: int, sweeps: int):
    """``(route, launches)`` of a pass of ``sweeps`` sweeps on an (h, w)
    level: ``"resident"`` where ``resident_fits``, one
    launch of every sweep; else ``"tiles"``, launches of
    ``MAX_TILE_SWEEPS`` sweeps and one of the rest (one launch a pass of 8,
    the default). ``launches`` lists each launch's sweeps, none for 0
    sweeps. From the shape alone, on the host."""
    if resident_fits(h, w):
        return "resident", [sweeps] if sweeps > 0 else []
    return "tiles", [min(MAX_TILE_SWEEPS, sweeps - b) for b in range(0, sweeps, MAX_TILE_SWEEPS)]


def _check_pass(fn, e_in, e_out, rhs, bh, bv, inv, mask_u8):
    shape = tuple(e_in.shape)
    if len(shape) != 2:
        raise ValueError(f"{fn}: expected (h, w) planes, got {shape}")
    for name, t in (("e_in", e_in), ("e_out", e_out), ("rhs", rhs), ("bh", bh), ("bv", bv),
                    ("inv", inv)):
        _check(name, t, torch.float32, shape)
    _check("mask", mask_u8, torch.uint8, shape)
    _same_device(fn, e_in=e_in, e_out=e_out, rhs=rhs, bh=bh, bv=bv, inv=inv, mask=mask_u8)
    return shape


def vc_smooth_tiles(e_in, e_out, rhs, bh, bv, inv, mask_u8, n: int, k: int) -> None:
    """The tile route: ``n`` <= ``k`` sweeps from ``e_in`` into ``e_out``
    in one launch, on tiles that carry a ring of ``k``. ``bh``/``bv``: the
    weights toward the right and lower neighbours (``wts.wr``, ``wts.wd``),
    ``inv`` the reciprocal sum, ``mask_u8`` 1 on scribbles."""
    h, w = _check_pass("vc_smooth_tiles", e_in, e_out, rhs, bh, bv, inv, mask_u8)
    if not 1 <= k <= MAX_TILE_SWEEPS or not 1 <= n <= k:
        raise ValueError(f"vc_smooth_tiles: {n} sweeps at ring {k}; the ring is 1.."
                         f"{MAX_TILE_SWEEPS} and at least the sweeps")
    lib = build.load_library()
    with torch.cuda.device(e_in.device):
        err = lib.vc_smooth_tiles(e_in.data_ptr(), e_out.data_ptr(), rhs.data_ptr(),
                                  bh.data_ptr(), bv.data_ptr(), inv.data_ptr(),
                                  mask_u8.data_ptr(), h, w, n, k, _stream(e_in))
    build.check("vc_smooth_tiles", err)
    vc_smooth_tiles.launches += 1


vc_smooth_tiles.launches = 0


def vc_smooth_resident(e_in, e_out, rhs, bh, bv, inv, mask_u8, n: int) -> None:
    """The resident route: ``n`` sweeps from ``e_in`` into ``e_out`` in one
    launch of one CTA that holds the level (``resident_fits``). Planes as
    ``vc_smooth_tiles`` takes them."""
    h, w = _check_pass("vc_smooth_resident", e_in, e_out, rhs, bh, bv, inv, mask_u8)
    if not resident_fits(h, w) or n < 1:
        raise ValueError(f"vc_smooth_resident: {n} sweeps of a {h}x{w} level, which one CTA "
                         "does not hold")
    lib = build.load_library()
    with torch.cuda.device(e_in.device):
        err = lib.vc_smooth_resident(e_in.data_ptr(), e_out.data_ptr(), rhs.data_ptr(),
                                     bh.data_ptr(), bv.data_ptr(), inv.data_ptr(),
                                     mask_u8.data_ptr(), h, w, n, _stream(e_in))
    build.check("vc_smooth_resident", err)
    vc_smooth_resident.launches += 1


vc_smooth_resident.launches = 0


def smooth_cuda(e, rhs, mask, wts, sweeps: int):
    """``smooth_plain`` on the kernels, by ``smooth_plan``: a fresh plane a
    launch (a tile's ring reads its neighbours' old pixels)."""
    h, w = e.shape
    route, launches = smooth_plan(h, w, sweeps)
    mask_u8 = mask.view(torch.uint8) if mask.dtype == torch.bool else mask
    for n in launches:
        out = torch.empty_like(e)
        if route == "resident":
            vc_smooth_resident(e, out, rhs, wts.wr, wts.wd, wts.inv_count, mask_u8, n)
        else:
            vc_smooth_tiles(e, out, rhs, wts.wr, wts.wd, wts.inv_count, mask_u8, n, n)
        e = out
    return e
