"""The level solve: kernels K1 and K2 (``csrc/sweep.cu``) and their plain version.

Counterpart of ``realtimedepthdiffusion_tpu/ops/pallas_sweep.py``:

- ``jc_sweep_tiles`` (K1) launches up to k temporally blocked sweeps over
  the whole level; it replaces ``_strip_mega_kernel_arena``.
- ``jc_sweep_resident`` (K2) runs every sweep of a level that fits one
  CTA's shared memory in one launch; it replaces ``_resident_kernel``.
- ``sweep_plain`` / ``solve_level_plain`` compute the same thing with torch
  ops, one rounding per op in the kernels' order. The CPU runs them, and
  on the card they are what the kernels are held to, bit for bit.
- ``solve_level_cuda`` routes a level to K1 or K2, in the part of
  ``solve_level_pallas``. ``strip_route`` adds K6 (``ops/fused_sweep.py``),
  which derives the weights in the kernel, for levels whose weight planes
  outgrow the card's L2 cache; ``ops/dispatch.py`` applies it.
- ``chunks_plain`` / ``chunks_cuda`` run a level's sweeps in chunks that
  carry (u, prev) from one to the next, for the residual early exit
  (``core/solver.py:_chunked_early_exit``); they are the counterpart of
  ``solve_level_strips_early_exit``. As there, every level of the early
  exit goes through K1, since K2 keeps no ``prev`` between launches.
- ``halo_block_sweeps`` runs the sweeps between two halo exchanges of the
  sharded step (``parallel/sharded.py``) on one halo-extended block: one K1
  launch over the block, in place of the TPU's ``_halo_block_kernel``.
  ``halo_block_sweeps_plain`` is its plain version.

Each kernel wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import build

# Sweeps per K1 launch: the ring of halo each tile carries. Deeper blocks
# read the state from device memory less often and recompute more halo.
TILE_SWEEPS = 8
# The largest ring K1 accepts (shared memory grows as (32+2k)*(64+2k)*8 B).
MAX_TILE_SWEEPS = 32
# One CTA's shared memory on Hopper (232,448 bytes) and K2's need per pixel
# of the level padded by a one-pixel ring: u, prev, bh, bv, inv (f32) and
# mask (u8).
SMEM_PER_CTA = 232448
RESIDENT_BYTES_PER_PX = 21
# What K1 reads of a level's weights on every launch: bh, bv, inv (f32) and
# mask (u8).
WEIGHT_PLANE_BYTES_PER_PX = 13


def relax_plain(u, wl, bh, wu, bv, inv):
    """The weighted 4-neighbour average, clip((wl*ul + bh*ur + wu*uu +
    bv*ud) * inv, 0, 255), summed left to right; a neighbour outside the
    image reads as 0."""
    ul = F.pad(u[:, :-1], (1, 0))
    ur = F.pad(u[:, 1:], (0, 1))
    uu = F.pad(u[:-1, :], (0, 0, 1, 0))
    ud = F.pad(u[1:, :], (0, 0, 0, 1))
    s = wl * ul
    s = s + bh * ur
    s = s + wu * uu
    s = s + bv * ud
    return torch.clamp(s * inv, 0.0, 255.0)


def sweep_plain(u, prev, wl, bh, wu, bv, inv, mask, a, b, c):
    """One Jacobi-Chebyshev sweep in the kernels' op order; returns (u', u)."""
    r = relax_plain(u, wl, bh, wu, bv, inv)
    out = a * r
    out = out + b * u
    out = out + c * prev
    return torch.where(mask, u, out), u


def left_up_weights(bh, bv):
    """(wl, wu) of a block from its pair weights: the weight toward the
    left (upper) neighbour is the pair weight one pixel to the left (up),
    and 0 in the first column (row), as the kernels read it."""
    return F.pad(bh[..., :-1], (1, 0)), F.pad(bv[..., :-1, :], (0, 0, 1, 0))


def _first(state):
    return state[0]


def chunks_plain(depth: torch.Tensor, mask: torch.Tensor, wts, abc: np.ndarray):
    """A level's sweeps in plain torch, as ``(state, run, u_of)``:
    ``run(state, base, n)`` runs sweeps base .. base+n-1 of the (iters, 3)
    schedule ``abc`` on the (u, prev) state, and ``u_of(state)`` is u."""
    mask = mask.to(torch.bool)

    def run(state, base, n):
        u, prev = state
        for a, b, c in abc[base:base + n].tolist():
            u, prev = sweep_plain(u, prev, wts.wl, wts.wr, wts.wu, wts.wd,
                                  wts.inv_count, mask, a, b, c)
        return u, prev

    u = depth.to(torch.float32)
    return (u, torch.zeros_like(u)), run, _first


def solve_level_plain(depth: torch.Tensor, mask: torch.Tensor, wts, abc: np.ndarray) -> torch.Tensor:
    """All sweeps of one level (``abc``: the (iters, 3) schedule), plain torch."""
    state, run, u_of = chunks_plain(depth, mask, wts, abc)
    return u_of(run(state, 0, abc.shape[0]))


def _check(name, t, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_table(name, t, cols):
    if t.dim() != 2 or t.shape[1] != cols:
        raise ValueError(f"{name}: expected shape (iters, {cols}), got {tuple(t.shape)}")
    _check(name, t, torch.float32, t.shape)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def jc_sweep_tiles(u_in, p_in, u_out, p_out, bh, bv, inv, mask_u8, abc_dev,
                   base: int, n_active: int, k: int = TILE_SWEEPS) -> None:
    """K1: sweeps base .. base+n_active-1 of the (iters, 3) device table
    ``abc_dev``, reading (u_in, p_in) and writing (u_out, p_out)."""
    h, w = u_in.shape
    for name, t in (("u_in", u_in), ("p_in", p_in), ("u_out", u_out),
                    ("p_out", p_out), ("bh", bh), ("bv", bv), ("inv", inv)):
        _check(name, t, torch.float32, (h, w))
    _check("mask", mask_u8, torch.uint8, (h, w))
    _check_table("abc", abc_dev, 3)
    if not 1 <= k <= MAX_TILE_SWEEPS:
        raise ValueError(f"k must be in 1..{MAX_TILE_SWEEPS}, got {k}")
    if not 1 <= n_active <= k or base < 0 or base + n_active > abc_dev.shape[0]:
        raise ValueError(
            f"sweeps {base}..{base + n_active - 1} with k={k} do not fit a "
            f"table of {abc_dev.shape[0]}"
        )
    lib = build.load_library()
    # The launch goes to the current device: make it the tensors' one.
    with torch.cuda.device(u_in.device):
        err = lib.jc_sweep_tiles(
            u_in.data_ptr(), p_in.data_ptr(), u_out.data_ptr(), p_out.data_ptr(),
            bh.data_ptr(), bv.data_ptr(), inv.data_ptr(), mask_u8.data_ptr(),
            abc_dev.data_ptr(), h, w, base, n_active, k, _stream(u_in),
        )
    build.check("jc_sweep_tiles", err)
    jc_sweep_tiles.launches += 1


jc_sweep_tiles.launches = 0


def resident_fits(h: int, w: int) -> bool:
    """Whether K2 can hold an (h, w) level in one CTA's shared memory."""
    return (h + 2) * (w + 2) * RESIDENT_BYTES_PER_PX <= SMEM_PER_CTA


def strip_route(h: int, w: int, l2_bytes: int) -> str:
    """The kernel of an (h, w) Jacobi level on a card with an L2 cache of
    ``l2_bytes``: "K2" when the level fits one CTA's shared memory; else
    "K6" when K1's weight planes would not stay in L2, so that K6 derives
    the weights in the kernel instead; else "K1". It is the Hopper reading
    of the reference's arena/uarena choice (``_plan_strips``,
    ``pallas_sweep.py:902-917``), with L2 in place of VMEM."""
    if resident_fits(h, w):
        return "K2"
    if WEIGHT_PLANE_BYTES_PER_PX * h * w > l2_bytes:
        return "K6"
    return "K1"


def jc_sweep_resident(u, bh, bv, inv, mask_u8, abc_dev) -> None:
    """K2: every sweep of the (iters, 3) device table ``abc_dev`` on the
    level ``u``, in place, starting from a zero Chebyshev history."""
    h, w = u.shape
    for name, t in (("u", u), ("bh", bh), ("bv", bv), ("inv", inv)):
        _check(name, t, torch.float32, (h, w))
    _check("mask", mask_u8, torch.uint8, (h, w))
    _check_table("abc", abc_dev, 3)
    if not resident_fits(h, w):
        raise ValueError(f"a {h}x{w} level does not fit one CTA's shared memory")
    lib = build.load_library()
    err = lib.jc_sweep_resident(
        u.data_ptr(), bh.data_ptr(), bv.data_ptr(), inv.data_ptr(),
        mask_u8.data_ptr(), abc_dev.data_ptr(), h, w, abc_dev.shape[0], _stream(u),
    )
    build.check("jc_sweep_resident", err)
    jc_sweep_resident.launches += 1


jc_sweep_resident.launches = 0


def solve_level_cuda(depth: torch.Tensor, mask: torch.Tensor, wts, abc: np.ndarray,
                     k: int = TILE_SWEEPS) -> torch.Tensor:
    """All sweeps of one level on the card: K2 when the level fits one CTA's
    shared memory, else ceil(iters/k) launches of K1."""
    h, w = depth.shape
    iters = abc.shape[0]
    u = depth.to(torch.float32).contiguous().clone()
    if iters == 0:
        return u
    abc_dev = torch.from_numpy(np.ascontiguousarray(abc, np.float32)).to(u.device)
    bh = wts.wr.contiguous()
    bv = wts.wd.contiguous()
    inv = wts.inv_count.contiguous()
    m8 = mask.to(torch.uint8).contiguous()
    if resident_fits(h, w):
        jc_sweep_resident(u, bh, bv, inv, m8, abc_dev)
        return u
    return _solve_tiles(u, bh, bv, inv, m8, abc_dev, k)


def _solve_tiles(u, bh, bv, inv, m8, abc_dev, k):
    """Every sweep of the table with K1, from a zero Chebyshev history."""
    return _tiles_chunk(u, torch.zeros_like(u), bh, bv, inv, m8, abc_dev, 0,
                        abc_dev.shape[0], k)[0]


def ping_pong(u, prev, launch, base, n, k):
    """Sweeps base .. base+n-1 in ceil(n/k) calls of ``launch(u_in, p_in,
    u_out, p_out, b, n_active)``, a kernel of up to k sweeps; (u, prev)
    ping-pong between the given pair and a new one, and the last launch runs
    the remaining sweeps. Returns the pair that holds the result."""
    us = [u, torch.empty_like(u)]
    ps = [prev, torch.empty_like(u)]
    n_blocks = -(-n // k)
    for blk in range(n_blocks):
        src, dst = blk % 2, 1 - blk % 2
        b = base + blk * k
        launch(us[src], ps[src], us[dst], ps[dst], b, min(k, base + n - b))
    return us[n_blocks % 2], ps[n_blocks % 2]


def _tiles_chunk(u, prev, bh, bv, inv, m8, abc_dev, base, n, k):
    """Sweeps base .. base+n-1 on K1 (``ping_pong``)."""
    def launch(u_in, p_in, u_out, p_out, b, n_active):
        jc_sweep_tiles(u_in, p_in, u_out, p_out, bh, bv, inv, m8, abc_dev, b, n_active, k)

    return ping_pong(u, prev, launch, base, n, k)


def chunks_cuda(depth: torch.Tensor, mask: torch.Tensor, wts, abc: np.ndarray,
                k: int = TILE_SWEEPS):
    """``chunks_plain`` on the card: each chunk is ceil(n/k) launches of K1."""
    u = depth.to(torch.float32).contiguous().clone()
    abc_dev = torch.from_numpy(np.ascontiguousarray(abc, np.float32)).to(u.device)
    planes = (wts.wr.contiguous(), wts.wd.contiguous(), wts.inv_count.contiguous(),
              mask.to(torch.uint8).contiguous())

    def run(state, base, n):
        return _tiles_chunk(*state, *planes, abc_dev, base, n, k)

    return (u, torch.zeros_like(u)), run, _first


def halo_block_sweeps_plain(u_e, p_e, bh_e, bv_e, inv_e, m_e, abc):
    """Plain version of ``halo_block_sweeps``: ``sweep_plain`` once per row
    of ``abc``, on the block alone."""
    wl, wu = left_up_weights(bh_e, bv_e)
    mask = m_e.to(torch.bool)
    u, prev = u_e, p_e
    for a, b, c in abc.tolist():
        u, prev = sweep_plain(u, prev, wl, bh_e, wu, bv_e, inv_e, mask, a, b, c)
    return u, prev


def halo_block_sweeps(u_e, p_e, bh_e, bv_e, inv_e, m_e, abc):
    """The (n, 3) schedule ``abc`` on one halo-extended (h, w) block of the
    sharded step; returns (u, prev). Plain torch for CPU tensors, one K1
    launch with n_active = k = n for CUDA tensors.

    K1 reads zeros past the block where the TPU kernel's rolls wrap around;
    either way only the outer n rings are wrong, and the caller, whose halo
    is at least n wide, crops them."""
    if u_e.device.type == "cpu":
        return halo_block_sweeps_plain(u_e, p_e, bh_e, bv_e, inv_e, m_e, abc)
    if not u_e.is_cuda:
        raise ValueError(f"halo_block_sweeps: unsupported device {u_e.device}")
    n = abc.shape[0]
    u_out, p_out = torch.empty_like(u_e), torch.empty_like(u_e)
    jc_sweep_tiles(u_e, p_e, u_out, p_out, bh_e, bv_e, inv_e, m_e.to(torch.uint8),
                   abc, 0, n, n)
    return u_out, p_out
