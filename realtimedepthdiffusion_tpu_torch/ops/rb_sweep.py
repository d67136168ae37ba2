"""The red-black level solve: kernels K4 and K5 (``csrc/rb_sweep.cu``) and their plain version.

Counterpart of the red-black section of
``realtimedepthdiffusion_tpu/ops/pallas_sweep.py`` (``:1170-1926``):

- ``rb_sweep_tiles`` (K4) runs up to k red-black iterations over the whole
  level, or over a stack of equally shaped planes with a checkerboard
  parity each, in temporally blocked tiles; it replaces
  ``_rb_strip_mega_kernel``, the chunked ``_strip_rb_kernel`` and the
  quadrant-compacted ``_rb_compact_mega_kernel``, which all compute the
  same iterate. ``rb_tile_config`` picks its CTA shape.
- ``rb_sweep_resident`` (K5) runs n iterations of a level that one CTA's
  threads hold in registers, a patch of pixels each, in one launch; it
  replaces ``_resident_rb_kernel``. ``rb_resident_config`` picks its CTA.
- ``rb_iter_plain`` / ``solve_level_rb_plain`` compute the same thing with
  torch ops in ``_rb_iter_full``'s order. The CPU runs them, and on the
  card they are what the kernels are held to, bit for bit.
- ``solve_level_rb_cuda`` routes a level to K5 when it fits and to K4
  otherwise. ``pallas_rb_resident``, ``pallas_rb_megakernel``,
  ``pallas_rb_compact`` and ``pallas_in_kernel_halo`` choose between TPU
  kernels of one iterate; they change nothing here.
- ``chunks_plain`` / ``chunks_cuda`` run a level's iterations in chunks for
  the residual early exit (``core/solver.py:_chunked_early_exit``); on the
  card each chunk is one K5 launch or ceil(n/k) K4 launches, each handed
  the early exit's device flag ``stop``, which turns it into a no-op (K5)
  or a copy of its input (K4).
- ``halo_block_rb_sweeps`` runs the iterations between two halo exchanges
  of the sharded step on a stack of halo-extended blocks: one K4 launch
  over the whole stack, whose ``parity`` per block keeps the whole image's
  checkerboard, in place of the TPU's ``_halo_block_rb_kernel`` per block
  and its u8 colour plane. ``halo_block_rb_sweeps_plain`` is its plain
  version.

Each kernel wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import build
from .sweep import (SMEM_PER_CTA, _check, _check_table, _same_device, _stream, check_stop,
                    device_table, left_up_weights, relax_plain, table_rows, unless_stopped)

# Iterations per K4 launch. One iteration is two half-sweeps, each of which
# widens the dependency cone by a pixel, so a tile carries a ring of 2k. On
# an NVIDIA H100 80GB HBM3 at its 700 W limit k = 4 took less device time
# than k = 8 (1080p L0: 0.47 against 0.69-0.70 ms; L1: 0.29 against 0.38)
# but twice the launches, which the host paces at L1 (1.4-1.5 against
# 0.76-0.95 ms as launched), and the fast frame is bound by the host.
RB_TILE_ITERS = 8
# K4's CTA shapes (threads across, threads down, rows, columns): each
# thread owns a patch of rows x columns pixels, so the extended tile is
# (down * rows) x (across * columns) and its interior that less 4k each
# way. Both sides of the tile are even, which puts every tile's origin on
# a red cell. The kernel has the patches 4x2, 8x1 (K1's column) and 8x2.
# 4x2 won at k = 8 over 8x1, whose lanes idle through the other colour's
# half-sweep (L0: 0.69-0.70 against 1.15 ms of device time), and lost 0.1 ms
# at L0 to 8x2 on 64 x 128, which ties it at L1 and runs one CTA per SM.
RB_TILE_SHALLOW = (32, 16, 4, 2)  # 64 x 64: k <= 15
RB_TILE_DEEP = (48, 10, 8, 2)  # 80 x 96: the rings of k = 16 to 19
RB_TILE_PATCHES = ((4, 2), (8, 1), (8, 2))
RB_TILE_MAX_THREADS = 512
# The largest k a shape carries.
MAX_RB_TILE_ITERS = 19
# K4 takes at most this many planes per launch: their parities are the
# bits of one 64-bit word.
RB_TILE_MAX_PLANES = 64
# K5's patch (rows, columns) and the most threads of its one CTA: a thread
# keeps its patch's u, weights and mask bits in registers, 64 of them, so
# the CTA holds 1024 x 4 x 2 pixels.
RB_RESIDENT_PATCH = (4, 2)
RB_RESIDENT_MAX_THREADS = 1024


def red_black_parity(h: int, w: int, device=None, parity: int = 0) -> torch.Tensor:
    """Checkerboard mask: True at red cells ((y + x + parity) even). A block
    of a larger image passes the parity of its origin there."""
    yy = torch.arange(h, device=device)[:, None]
    xx = torch.arange(w, device=device)[None, :]
    return (yy + xx + parity) % 2 == 0


def rb_iter_plain(u, wl, bh, wu, bv, inv, mask, red, om_r: float, om_b: float):
    """One red-black iteration: at the red cells that are not scribbled,
    clip(u + om_r*(r - u), 0, 255) with r the clipped weighted average of
    the current state; then the same at the black cells, with om_b, from
    the half-updated state."""
    free = ~mask
    r = relax_plain(u, wl, bh, wu, bv, inv)
    u = torch.where(red & free, torch.clamp(u + om_r * (r - u), 0.0, 255.0), u)
    r = relax_plain(u, wl, bh, wu, bv, inv)
    return torch.where(~red & free, torch.clamp(u + om_b * (r - u), 0.0, 255.0), u)


def _same(u):
    return u


def chunks_plain(depth: torch.Tensor, mask: torch.Tensor, wts, om: np.ndarray):
    """A level's iterations in plain torch, as ``(state, run, u_of)``:
    ``run(u, base, n, stop=None)`` runs iterations base .. base+n-1 of the
    (iters, 2) omega table ``om``, unless the flag ``stop`` is set, and
    returns the new u, which is the state."""
    mask = mask.to(torch.bool)
    red = red_black_parity(*depth.shape, device=depth.device)

    def run(u0, base, n, stop=None):
        u = u0
        for om_r, om_b in om[base:base + n].tolist():
            u = rb_iter_plain(u, wts.wl, wts.wr, wts.wu, wts.wd, wts.inv_count, mask,
                              red, om_r, om_b)
        return unless_stopped(stop, (u0,), (u,))[0]

    return depth.to(torch.float32), run, _same


def solve_level_rb_plain(depth: torch.Tensor, mask: torch.Tensor, wts,
                         om: np.ndarray) -> torch.Tensor:
    """Every iteration of the (iters, 2) omega table ``om``, plain torch."""
    u, run, _ = chunks_plain(depth, mask, wts, om)
    return run(u, 0, om.shape[0])


def _check_planes(fn, shape, u, u_out, bh, bv, inv, mask_u8, om_dev, base, n):
    for name, t in (("bh", bh), ("bv", bv), ("inv", inv)):
        _check(name, t, torch.float32, shape)
    _check("mask", mask_u8, torch.uint8, shape)
    _check_table("om", om_dev, 2)
    _same_device(fn, u=u, u_out=u_out, bh=bh, bv=bv, inv=inv, mask=mask_u8, om=om_dev)
    if n < 1 or base < 0 or base + n > om_dev.shape[0]:
        raise ValueError(
            f"iterations {base}..{base + n - 1} do not fit a table of {om_dev.shape[0]}"
        )


def rb_tile_extent(tile):
    """(rows, columns) of the extended tile of the CTA shape ``tile``."""
    bx, by, rows, cols = tile
    return by * rows, bx * cols


def rb_smem_bytes(tile) -> int:
    """K4's and K5's shared memory: one f32 buffer of u, every row split
    into its ``cols`` de-interleaved sub-planes with an end slot each side,
    and a row above and below. A CTA of K5 stays below 100 KB of it
    whatever its shape."""
    bx, by, rows, cols = tile
    return 4 * (by * rows + 2) * cols * (bx + 2)


def rb_tile_config(k: int):
    """K4's (threads across, threads down, rows, columns) at k iterations
    per launch: the first of its shapes whose interior is positive."""
    for tile in (RB_TILE_SHALLOW, RB_TILE_DEEP):
        if min(rb_tile_extent(tile)) > 4 * k:
            return tile
    raise ValueError(f"k must be in 1..{MAX_RB_TILE_ITERS}, got {k}")


def _check_rb_tile(tile, k: int):
    bx, by, rows, cols = tile
    eh, ew = rb_tile_extent(tile)
    if ((rows, cols) not in RB_TILE_PATCHES or bx * by > RB_TILE_MAX_THREADS or ew % 2
            or min(eh, ew) <= 4 * k or rb_smem_bytes(tile) > SMEM_PER_CTA):
        raise ValueError(f"tile {tuple(tile)} cannot carry a ring of {2 * k} (k={k})")
    return bx, by, rows, cols


def _parities(parity, nb: int):
    """``parity`` as one 0/1 per plane: an int stands for every plane."""
    if isinstance(parity, (int, np.integer)):
        return [parity & 1] * nb
    parity = [int(q) & 1 for q in parity]
    if len(parity) != nb:
        raise ValueError(f"parity: expected {nb} values, one per plane, got {len(parity)}")
    return parity


def rb_sweep_tiles(u_in, u_out, bh, bv, inv, mask_u8, om_dev, base: int, n_active: int,
                   k: int = RB_TILE_ITERS, tile=None, parity=0, stop=None) -> None:
    """K4: iterations base .. base+n_active-1 of the (iters, 2) device
    omega table ``om_dev``, reading ``u_in`` and writing ``u_out``: (h, w)
    planes, or (nb, h, w) stacks of nb independent planes, one launch for
    every 64 of them. Red is where (y + x + parity) is even; ``parity`` is
    one int, or one per plane. ``tile`` overrides ``rb_tile_config(k)``.
    Where the device flag ``stop`` (``ops/sweep.py:check_stop``) is set,
    the launch copies u_in to u_out instead."""
    if u_in.dim() not in (2, 3):
        raise ValueError(f"u_in: expected (h, w) or (nb, h, w), got {tuple(u_in.shape)}")
    shape = tuple(u_in.shape)
    nb, h, w = (1, *shape) if len(shape) == 2 else shape
    _check("u_in", u_in, torch.float32, shape)
    _check("u_out", u_out, torch.float32, shape)
    _check_planes("rb_sweep_tiles", shape, u_in, u_out, bh, bv, inv, mask_u8, om_dev, base,
                  n_active)
    if not 1 <= k <= MAX_RB_TILE_ITERS:
        raise ValueError(f"k must be in 1..{MAX_RB_TILE_ITERS}, got {k}")
    if n_active > k:
        raise ValueError(f"n_active {n_active} exceeds k={k}")
    bx, by, rows, cols = _check_rb_tile(tile or rb_tile_config(k), k)
    parity = _parities(parity, nb)
    stop_ptr = check_stop("rb_sweep_tiles", stop, u_in.device)
    lib = build.load_library()
    planes = (u_in, u_out, bh, bv, inv, mask_u8)
    # The launch goes to the current device: make it the tensors' one.
    with torch.cuda.device(u_in.device):
        for z in range(0, nb, RB_TILE_MAX_PLANES):
            bits = sum(q << i for i, q in enumerate(parity[z:z + RB_TILE_MAX_PLANES]))
            err = lib.rb_sweep_tiles(
                *(t.data_ptr() + z * h * w * t.element_size() for t in planes),
                om_dev.data_ptr(), min(RB_TILE_MAX_PLANES, nb - z), h, w, base, n_active, k,
                bx, by, rows, cols, bits, stop_ptr, _stream(u_in),
            )
            build.check("rb_sweep_tiles", err)
            rb_sweep_tiles.launches += 1


rb_sweep_tiles.launches = 0


def rb_resident_config(h: int, w: int):
    """K5's (threads across, threads down, rows, columns) for an (h, w)
    level, one patch a thread, or None where one CTA does not cover it."""
    rows, cols = RB_RESIDENT_PATCH
    bx, by = -(-w // cols), -(-h // rows)
    return (bx, by, rows, cols) if bx * by <= RB_RESIDENT_MAX_THREADS else None


def rb_resident_fits(h: int, w: int) -> bool:
    """Whether one CTA of K5 holds an (h, w) level."""
    return rb_resident_config(h, w) is not None


def rb_sweep_resident(u, bh, bv, inv, mask_u8, om_dev, base: int, n: int,
                      stop=None) -> None:
    """K5: iterations base .. base+n-1 of the (iters, 2) device omega table
    ``om_dev`` on the level ``u``, in place; none where the device flag
    ``stop`` is set."""
    h, w = u.shape
    _check("u", u, torch.float32, (h, w))
    _check_planes("rb_sweep_resident", (h, w), u, u, bh, bv, inv, mask_u8, om_dev, base, n)
    shape = rb_resident_config(h, w)
    if shape is None:
        raise ValueError(f"a {h}x{w} level does not fit one CTA of "
                         f"{RB_RESIDENT_MAX_THREADS} threads, {RB_RESIDENT_PATCH} pixels each")
    stop_ptr = check_stop("rb_sweep_resident", stop, u.device)
    lib = build.load_library()
    # The launch goes to the current device: make it the tensors' one.
    with torch.cuda.device(u.device):
        err = lib.rb_sweep_resident(
            u.data_ptr(), bh.data_ptr(), bv.data_ptr(), inv.data_ptr(), mask_u8.data_ptr(),
            om_dev.data_ptr(), h, w, base, n, *shape[:2], stop_ptr, _stream(u),
        )
    build.check("rb_sweep_resident", err)
    rb_sweep_resident.launches += 1


rb_sweep_resident.launches = 0


def _tiles_chunk(u, bh, bv, inv, m8, om_dev, base, n, k, tile=None, stop=None):
    """Iterations base .. base+n-1 in ceil(n/k) K4 launches; u ping-pongs
    between the given buffer and a new one. Returns the one that holds the
    result, which is the state unchanged where ``stop`` is set."""
    us = [u, torch.empty_like(u)]
    n_blocks = -(-n // k)
    for blk in range(n_blocks):
        b = base + blk * k
        rb_sweep_tiles(us[blk % 2], us[1 - blk % 2], bh, bv, inv, m8, om_dev, b,
                       min(k, base + n - b), k, tile, stop=stop)
    return us[n_blocks % 2]


def chunks_cuda(depth: torch.Tensor, mask: torch.Tensor, wts, om: np.ndarray,
                k: int = RB_TILE_ITERS):
    """``chunks_plain`` on the card: a chunk is one K5 launch when one CTA
    holds the level, else ceil(n/k) K4 launches, each handed the flag
    ``stop``."""
    u = depth.to(torch.float32).contiguous().clone()
    om_dev = device_table(om, u.device)
    planes = (wts.wr.contiguous(), wts.wd.contiguous(), wts.inv_count.contiguous(),
              mask.to(torch.uint8).contiguous())

    if rb_resident_fits(*u.shape):
        def run(u, base, n, stop=None):
            rb_sweep_resident(u, *planes, om_dev, base, n, stop)
            return u
    else:
        def run(u, base, n, stop=None):
            return _tiles_chunk(u, *planes, om_dev, base, n, k, stop=stop)

    return u, run, _same


def solve_level_rb_cuda(depth: torch.Tensor, mask: torch.Tensor, wts, om: np.ndarray,
                        k: int = RB_TILE_ITERS) -> torch.Tensor:
    """Every iteration of the (iters, 2) omega table on the card: one K5
    launch when one CTA holds the level, else ceil(iters/k) launches of
    K4."""
    if om.shape[0] == 0:
        return depth.to(torch.float32).contiguous().clone()
    u, run, _ = chunks_cuda(depth, mask, wts, om, k)
    return run(u, 0, om.shape[0])


def halo_block_rb_sweeps_plain(u_e, bh_e, bv_e, inv_e, m_e, parity, om, stop=None):
    """Plain version of ``halo_block_rb_sweeps``: ``rb_iter_plain`` once per
    row of ``om``, on each block alone; where the flag ``stop`` is set, the
    blocks as they came (``unless_stopped``)."""
    wl, wu = left_up_weights(bh_e, bv_e)
    mask = m_e.to(torch.bool)
    h, w = u_e.shape[-2:]
    if u_e.dim() == 2:
        red = red_black_parity(h, w, device=u_e.device, parity=_parities(parity, 1)[0])
    else:
        red = torch.stack([red_black_parity(h, w, device=u_e.device, parity=q)
                           for q in _parities(parity, u_e.shape[0])])
    u = u_e
    for om_r, om_b in table_rows(om):
        u = rb_iter_plain(u, wl, bh_e, wu, bv_e, inv_e, mask, red, om_r, om_b)
    return unless_stopped(stop, (u_e,), (u,))[0]


def halo_block_rb_sweeps(u_e, bh_e, bv_e, inv_e, m_e, parity, om, stop=None):
    """The (n, 2) omegas ``om`` on a halo-extended (h, w) block of the
    sharded step, or on an (nb, h, w) stack of them, red where (y + x +
    parity) is even in block coordinates: ``parity`` is that of the block's
    global origin, one int per block of a stack. Plain torch for CPU
    tensors, one K4 launch over the whole stack with n_active = k = n for
    CUDA tensors, handed the early exit's flag ``stop``
    (``ops/sweep.py:check_stop``; a stopped launch copies the blocks
    across); the result is a new tensor. The caller's halo is at least 2n
    wide (each iteration reads two rings) and it crops them."""
    if u_e.device.type == "cpu":
        return halo_block_rb_sweeps_plain(u_e, bh_e, bv_e, inv_e, m_e, parity, om, stop)
    if not u_e.is_cuda:
        raise ValueError(f"halo_block_rb_sweeps: unsupported device {u_e.device}")
    n = om.shape[0]
    u_out = torch.empty_like(u_e)
    rb_sweep_tiles(u_e, u_out, bh_e, bv_e, inv_e, m_e.to(torch.uint8), om, 0,
                   n, n, parity=parity, stop=stop)
    return u_out
