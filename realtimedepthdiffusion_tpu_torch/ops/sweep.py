"""The level solve: kernels K1 and K2 (``csrc/sweep.cu``) and their plain version.

Counterpart of ``realtimedepthdiffusion_tpu/ops/pallas_sweep.py``:

- ``jc_sweep_tiles`` (K1) launches up to k temporally blocked sweeps over
  the whole level, or over a stack of equally shaped planes; it replaces
  ``_strip_mega_kernel_arena``.
- ``jc_sweep_resident`` (K2) runs sweeps base .. base+n-1 of a level that a
  thread-block cluster holds on chip, a band of rows per CTA, in one
  launch, carrying (u, prev) in and out; it replaces ``_resident_kernel``.
  ``resident_cluster`` is its fit rule, ``resident_max_cluster`` asks the
  card how large a cluster it runs. The CTAs exchange their band edges
  once every s sweeps and recompute ghost rows in between;
  ``resident_plan`` picks s and the thread layout per launch.
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
  ``solve_level_strips_early_exit``. On the card a chunk is one K2 launch
  on a level a cluster holds, else ceil(n/k) K1 launches. A chunk takes
  the early exit's device flag ``stop``: where it is set, every launch of
  the chunk leaves the state as it is (``stop`` on the kernels), so the
  loop decides on the card and a CUDA graph can hold all its chunks.
- ``device_table`` puts an iteration table on the card once per contents
  and device; every kernel wrapper reads its table from there.
- ``halo_block_sweeps`` runs the sweeps between two halo exchanges of the
  sharded step (``parallel/sharded.py``) on a stack of halo-extended
  blocks: one K1 launch over the whole stack, in place of the TPU's
  ``_halo_block_kernel`` per block. ``halo_block_sweeps_plain`` is its
  plain version.

Each kernel wrapper counts its launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import build

# Sweeps per K1 launch: the ring of halo each tile carries. Deeper blocks
# read the state from device memory less often and recompute more halo.
TILE_SWEEPS = 8
# The largest ring K1 accepts.
MAX_TILE_SWEEPS = 32
# K1's CTA shapes (threads across, threads down, rows per thread): each
# thread owns a column of rows_per_thread pixels, so the extended tile is
# (down * rows) x across and its interior that less 2k each way. The first
# serves k <= 16 (a 64x64 tile, 48x48 inside at k = 8); the second, whose
# 1024 threads keep 6 pixels each, the rings of 17 to 32 (72x80).
TILE_SHALLOW = (64, 8, 8)
TILE_DEEP = (80, 12, 6)
# One CTA's shared memory on Hopper (232,448 bytes).
SMEM_PER_CTA = 232448
# K2's band: at most RESIDENT_ROWS rows of at most RESIDENT_MAX_W columns
# per CTA, one column per thread, whose pixels live in registers.
RESIDENT_ROWS = 17
RESIDENT_MAX_W = 512
# K2's thread layouts (rows per thread, most threads a CTA): with ghost
# rows, thread rows of 2, 4 or 6 rows, as many as the extended band (the
# band and its ghost rows) needs; or one thread row of RESIDENT_ROWS rows at
# one exchange a sweep. Fewer rows a thread were faster at the same sweeps
# per exchange (more warps hide a sweep's latency; PERF.md).
RESIDENT_BLOCKED_LAYOUTS = ((2, 1024), (4, 1024), (6, 1024))
# The most sweeps K2 runs between two exchanges of its band edges.
RESIDENT_MAX_S = 8
# K2's cluster sizes; a cluster of 16 CTAs is the largest Hopper allows
# (above 8 as a non-portable size). The CPU routes as the H100 does, which
# runs 16.
CLUSTER_SIZES = (1, 2, 4, 8, 16)
H100_MAX_CLUSTER = 16
# What K1 reads of a level's weights on every launch: bh, bv, inv (f32) and
# mask (u8).
WEIGHT_PLANE_BYTES_PER_PX = 13


def average_plain(u, wl, bh, wu, bv, inv):
    """The weighted 4-neighbour average, (wl*ul + bh*ur + wu*uu + bv*ud) *
    inv, summed left to right over the last two axes; a neighbour outside
    the image reads as 0. Unclipped: the linear operator of the V-cycle's
    error equations."""
    ul = F.pad(u[..., :-1], (1, 0))
    ur = F.pad(u[..., 1:], (0, 1))
    uu = F.pad(u[..., :-1, :], (0, 0, 1, 0))
    ud = F.pad(u[..., 1:, :], (0, 0, 0, 1))
    s = wl * ul
    s = s + bh * ur
    s = s + wu * uu
    s = s + bv * ud
    return s * inv


def relax_plain(u, wl, bh, wu, bv, inv):
    """``average_plain`` clipped to [0, 255]: the relaxation of the primal
    variable, as the kernels compute it."""
    return torch.clamp(average_plain(u, wl, bh, wu, bv, inv), 0.0, 255.0)


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


def unless_stopped(stop, old, new):
    """``new``, or ``old`` where the 0-d device flag ``stop`` is set: a
    stopped kernel launch in plain torch. ``stop`` None is never set."""
    if stop is None:
        return new
    halt = stop != 0
    return tuple(torch.where(halt, o, n) for o, n in zip(old, new))


def chunks_plain(depth: torch.Tensor, mask: torch.Tensor, wts, abc: np.ndarray):
    """A level's sweeps in plain torch, as ``(state, run, u_of)``:
    ``run(state, base, n, stop=None)`` runs sweeps base .. base+n-1 of the
    (iters, 3) schedule ``abc`` on the (u, prev) state, or leaves it where
    the flag ``stop`` is set, and ``u_of(state)`` is u."""
    mask = mask.to(torch.bool)

    def run(state, base, n, stop=None):
        u, prev = state
        for a, b, c in abc[base:base + n].tolist():
            u, prev = sweep_plain(u, prev, wts.wl, wts.wr, wts.wu, wts.wd,
                                  wts.inv_count, mask, a, b, c)
        return unless_stopped(stop, state, (u, prev))

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


def _same_device(fn: str, **tensors) -> None:
    """Raise unless every tensor lies on the first one's device: a kernel
    launches on one card and reads every pointer there."""
    (first, t0), *rest = tensors.items()
    for name, t in rest:
        if t.device != t0.device:
            raise ValueError(f"{fn}: {name} is on {t.device} but {first} on {t0.device}")


def check_stop(fn: str, stop, device) -> int | None:
    """The device address of the early exit's flag ``stop`` (a 0-d int32
    tensor on ``device``), or None (null: no flag)."""
    if stop is None:
        return None
    if stop.dtype != torch.int32 or stop.dim() != 0 or stop.device != device:
        raise ValueError(f"{fn}: stop must be a 0-d int32 tensor on {device}, got "
                         f"{tuple(stop.shape)} {stop.dtype} on {stop.device}")
    return stop.data_ptr()


def _check_table(name, t, cols):
    if t.dim() != 2 or t.shape[1] != cols:
        raise ValueError(f"{name}: expected shape (iters, {cols}), got {tuple(t.shape)}")
    _check(name, t, torch.float32, t.shape)


# Every table ``device_table`` has put on a device, by (contents, device).
_TABLES = {}


def device_table(table, device) -> torch.Tensor:
    """An iteration table (the (iters, 3) (a, b, c) rows or the (iters, 2)
    red-black omegas, numpy) as a float32 tensor on ``device``, copied there
    once per contents and device and kept for the life of the process. So a
    frame waits on no copy from pageable host memory, and a CUDA graph that
    reads the table never sees it freed. A first copy cannot happen while a
    graph is being captured: the first solve of a pipeline runs eagerly and
    makes them."""
    device = torch.device(device)
    host = np.ascontiguousarray(table, np.float32)
    key = (host.shape, host.tobytes(), device)
    if key not in _TABLES:
        _TABLES[key] = torch.tensor(host, device=device)
    return _TABLES[key]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def tile_config(k: int):
    """K1's (threads across, threads down, rows per thread) at ring k."""
    return TILE_SHALLOW if k <= 16 else TILE_DEEP


def jc_sweep_tiles(u_in, p_in, u_out, p_out, bh, bv, inv, mask_u8, abc_dev,
                   base: int, n_active: int, k: int = TILE_SWEEPS, tile=None,
                   stop=None) -> None:
    """K1: sweeps base .. base+n_active-1 of the (iters, 3) device table
    ``abc_dev``, reading (u_in, p_in) and writing (u_out, p_out): (h, w)
    planes, or (nb, h, w) stacks of nb independent planes, one launch for
    all. ``tile`` overrides ``tile_config(k)``. Where the device flag
    ``stop`` (``check_stop``) is set, the launch copies (u_in, p_in) to
    (u_out, p_out) instead."""
    if u_in.dim() not in (2, 3):
        raise ValueError(f"u_in: expected (h, w) or (nb, h, w), got {tuple(u_in.shape)}")
    shape = tuple(u_in.shape)
    nb, h, w = (1, *shape) if len(shape) == 2 else shape
    for name, t in (("u_in", u_in), ("p_in", p_in), ("u_out", u_out),
                    ("p_out", p_out), ("bh", bh), ("bv", bv), ("inv", inv)):
        _check(name, t, torch.float32, shape)
    _check("mask", mask_u8, torch.uint8, shape)
    _check_table("abc", abc_dev, 3)
    _same_device("jc_sweep_tiles", u_in=u_in, p_in=p_in, u_out=u_out, p_out=p_out, bh=bh, bv=bv,
                 inv=inv, mask=mask_u8, abc=abc_dev)
    if not 1 <= k <= MAX_TILE_SWEEPS:
        raise ValueError(f"k must be in 1..{MAX_TILE_SWEEPS}, got {k}")
    if not 1 <= n_active <= k or base < 0 or base + n_active > abc_dev.shape[0]:
        raise ValueError(
            f"sweeps {base}..{base + n_active - 1} with k={k} do not fit a "
            f"table of {abc_dev.shape[0]}"
        )
    bx, by, rows = tile or tile_config(k)
    if rows not in (6, 8) or bx * by > (512 if rows == 8 else 1024) or min(bx, by * rows) <= 2 * k:
        raise ValueError(f"tile {(bx, by, rows)} cannot carry a ring of {k}")
    stop_ptr = check_stop("jc_sweep_tiles", stop, u_in.device)
    lib = build.load_library()
    # The launch goes to the current device: make it the tensors' one.
    with torch.cuda.device(u_in.device):
        err = lib.jc_sweep_tiles(
            u_in.data_ptr(), p_in.data_ptr(), u_out.data_ptr(), p_out.data_ptr(),
            bh.data_ptr(), bv.data_ptr(), inv.data_ptr(), mask_u8.data_ptr(),
            abc_dev.data_ptr(), nb, h, w, base, n_active, k, bx, by, rows, stop_ptr,
            _stream(u_in),
        )
    build.check("jc_sweep_tiles", err)
    jc_sweep_tiles.launches += 1


jc_sweep_tiles.launches = 0


def resident_cluster(h: int, w: int, max_cluster: int):
    """The cluster K2 runs an (h, w) level on, on a card that runs clusters
    of up to ``max_cluster`` CTAs: the largest, since more CTAs share a
    sweep's issue and were faster at every level measured (PERF.md),
    if its bands hold at most ``RESIDENT_ROWS`` rows of at most
    ``RESIDENT_MAX_W`` columns; else None."""
    if w <= RESIDENT_MAX_W and -(-h // max_cluster) <= RESIDENT_ROWS:
        return max_cluster
    return None


def resident_smem(eh: int, w: int, s: int) -> int:
    """K2's shared memory (bytes) for an extended band of ``eh`` rows of
    ``w``, ``s`` sweeps per exchange: three planes of u, u and bh with a
    one-pixel ring, and two mailboxes of the band's first and last s rows'
    u and prev (``csrc/sweep.cu:resident_smem``)."""
    return 4 * (3 * (eh + 2) * (w + 2) + 8 * s * w)


def resident_layouts(rows: int, w: int, s: int):
    """The rows per thread of each K2 layout that holds bands of ``rows`` x
    ``w`` at ``s`` sweeps per exchange: each of ``RESIDENT_BLOCKED_LAYOUTS``
    whose threads and shared memory (that of the largest launch the card
    was asked about, ``resident_max_cluster``) hold the extended band's
    ``rows + 2(s-1)`` rows, and at s = 1 the one-row layout too; none at an
    ``s`` past the band's rows (the ghost rows come from the neighbouring
    bands) or ``RESIDENT_MAX_S``."""
    if not 1 <= s <= min(rows, RESIDENT_MAX_S):
        return []
    ext = rows + 2 * (s - 1)
    bx = -(-w // 32) * 32
    limit = resident_smem(RESIDENT_ROWS, RESIDENT_MAX_W, 1)
    fits = [r for r, threads in RESIDENT_BLOCKED_LAYOUTS
            if bx * -(-ext // r) <= threads and resident_smem(-(-ext // r) * r, w, s) <= limit]
    return fits + [RESIDENT_ROWS] if s == 1 else fits


def resident_plan(h: int, w: int, cluster: int, n: int):
    """``(s, rows_per_thread)`` of a K2 launch of ``n`` sweeps on an (h, w)
    level held by ``cluster`` CTAs: in the first blocked layout with room
    for ghost rows, the most sweeps per exchange it holds (at most ``n``);
    else one exchange a sweep in one thread row. Measured on the H100
    (PERF.md): fewer rows a thread beat more sweeps per exchange, and more
    sweeps per exchange beat fewer or tied (the 192 and 256 windows: s = 4
    and 5 within 2 %); with no ghost rows the one-row layout was the
    fastest."""
    rows = -(-h // cluster)
    for r, _ in RESIDENT_BLOCKED_LAYOUTS:
        s = max((s for s in range(2, min(n, RESIDENT_MAX_S) + 1)
                 if r in resident_layouts(rows, w, s)), default=0)
        if s:
            return s, r
    return 1, RESIDENT_ROWS


_max_cluster = {}


def resident_max_cluster(device: torch.device) -> int:
    """The largest K2 cluster the card ``device`` names runs at K2's largest
    band, asked of the card once (``cudaOccupancyMaxActiveClusters``); the
    H100's for the CPU. Raises where the card runs not even one CTA."""
    if device.type != "cuda":
        return H100_MAX_CLUSTER
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _max_cluster:
        lib = build.load_library()
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            build.check("jc_resident_max_cluster", lib.jc_resident_max_cluster(ctypes.byref(out)))
        if out.value < 1:
            raise RuntimeError(f"K2: card {index} runs not even one CTA of it")
        _max_cluster[index] = out.value
    return _max_cluster[index]


def strip_route(h: int, w: int, l2_bytes: int, max_cluster: int) -> str:
    """The kernel of an (h, w) Jacobi level on a card with an L2 cache of
    ``l2_bytes`` that runs K2 clusters of up to ``max_cluster`` CTAs: "K2"
    when such a cluster holds the level; else "K6" when K1's weight planes
    would not stay in L2, so that K6 derives the weights in the kernel
    instead; else "K1". It is the Hopper reading of the reference's
    resident/arena/uarena choice (``solve_level_pallas``, ``_plan_strips``,
    ``pallas_sweep.py:902-917``), with a cluster's shared memory and L2 in
    place of VMEM."""
    if resident_cluster(h, w, max_cluster):
        return "K2"
    if WEIGHT_PLANE_BYTES_PER_PX * h * w > l2_bytes:
        return "K6"
    return "K1"


def jc_sweep_resident(u, p, bh, bv, inv, mask_u8, abc_dev, base: int, n: int,
                      cluster: int, stop=None, plan=None) -> None:
    """K2: sweeps base .. base+n-1 of the (iters, 3) device table
    ``abc_dev`` on the level (u, prev) = (``u``, ``p``), in place, on a
    cluster of ``cluster`` CTAs; none where the device flag ``stop`` is
    set. ``plan`` overrides ``resident_plan``'s (s, rows_per_thread)."""
    h, w = u.shape
    for name, t in (("u", u), ("p", p), ("bh", bh), ("bv", bv), ("inv", inv)):
        _check(name, t, torch.float32, (h, w))
    _check("mask", mask_u8, torch.uint8, (h, w))
    _check_table("abc", abc_dev, 3)
    _same_device("jc_sweep_resident", u=u, p=p, bh=bh, bv=bv, inv=inv, mask=mask_u8, abc=abc_dev)
    if n < 1 or base < 0 or base + n > abc_dev.shape[0]:
        raise ValueError(f"sweeps {base}..{base + n - 1} do not fit a table of {abc_dev.shape[0]}")
    if cluster not in CLUSTER_SIZES or cluster > resident_max_cluster(u.device):
        raise ValueError(f"a cluster of {cluster} does not run on {u.device}")
    if w > RESIDENT_MAX_W or -(-h // cluster) > RESIDENT_ROWS:
        raise ValueError(f"a {h}x{w} level does not fit a cluster of {cluster} CTAs")
    s, rows_per_thread = plan or resident_plan(h, w, cluster, n)
    if rows_per_thread not in resident_layouts(-(-h // cluster), w, s):
        raise ValueError(f"K2 holds no band of {-(-h // cluster)}x{w} at {s} sweeps per "
                         f"exchange on thread rows of {rows_per_thread}")
    stop_ptr = check_stop("jc_sweep_resident", stop, u.device)
    lib = build.load_library()
    with torch.cuda.device(u.device):
        err = lib.jc_sweep_resident(
            u.data_ptr(), p.data_ptr(), bh.data_ptr(), bv.data_ptr(), inv.data_ptr(),
            mask_u8.data_ptr(), abc_dev.data_ptr(), h, w, base, n, cluster, s,
            rows_per_thread, stop_ptr, _stream(u),
        )
    build.check("jc_sweep_resident", err)
    jc_sweep_resident.launches += 1


jc_sweep_resident.launches = 0


def solve_level_cuda(depth: torch.Tensor, mask: torch.Tensor, wts, abc: np.ndarray,
                     k: int = TILE_SWEEPS) -> torch.Tensor:
    """All sweeps of one level on the card: one K2 launch when a cluster
    holds the level, else ceil(iters/k) launches of K1."""
    state, run, u_of = chunks_cuda(depth, mask, wts, abc, k)
    return u_of(run(state, 0, abc.shape[0])) if abc.shape[0] else u_of(state)


def _solve_tiles(u, bh, bv, inv, m8, abc_dev, k):
    """Every sweep of the table with K1, from a zero Chebyshev history."""
    return _tiles_chunk(u, torch.zeros_like(u), bh, bv, inv, m8, abc_dev, 0,
                        abc_dev.shape[0], k)[0]


def ping_pong(u, prev, launch, base, n, k, stop=None):
    """Sweeps base .. base+n-1 in ceil(n/k) calls of ``launch(u_in, p_in,
    u_out, p_out, b, n_active, stop)``, a kernel of up to k sweeps; (u,
    prev) ping-pong between the given pair and a new one, and the last
    launch runs the remaining sweeps. Returns the pair that holds the
    result. Every launch takes the flag ``stop``: a stopped one copies its
    input to its output, so the pair returned holds the state either way."""
    us = [u, torch.empty_like(u)]
    ps = [prev, torch.empty_like(u)]
    n_blocks = -(-n // k)
    for blk in range(n_blocks):
        src, dst = blk % 2, 1 - blk % 2
        b = base + blk * k
        launch(us[src], ps[src], us[dst], ps[dst], b, min(k, base + n - b), stop)
    return us[n_blocks % 2], ps[n_blocks % 2]


def _tiles_chunk(u, prev, bh, bv, inv, m8, abc_dev, base, n, k, stop=None):
    """Sweeps base .. base+n-1 on K1 (``ping_pong``)."""
    def launch(u_in, p_in, u_out, p_out, b, n_active, stop):
        jc_sweep_tiles(u_in, p_in, u_out, p_out, bh, bv, inv, m8, abc_dev, b, n_active, k,
                       stop=stop)

    return ping_pong(u, prev, launch, base, n, k, stop)


def chunks_cuda(depth: torch.Tensor, mask: torch.Tensor, wts, abc: np.ndarray,
                k: int = TILE_SWEEPS):
    """``chunks_plain`` on the card: each chunk is one K2 launch from its
    ``base`` when a cluster holds the level, else ceil(n/k) launches of K1,
    each handed the flag ``stop``."""
    u = depth.to(torch.float32).contiguous().clone()
    abc_dev = device_table(abc, u.device)
    planes = (wts.wr.contiguous(), wts.wd.contiguous(), wts.inv_count.contiguous(),
              mask.to(torch.uint8).contiguous())
    cluster = resident_cluster(*u.shape, resident_max_cluster(u.device))

    if cluster:
        def run(state, base, n, stop=None):
            jc_sweep_resident(*state, *planes, abc_dev, base, n, cluster, stop)
            return state
    else:
        def run(state, base, n, stop=None):
            return _tiles_chunk(*state, *planes, abc_dev, base, n, k, stop)

    return (u, torch.zeros_like(u)), run, _first


def table_rows(table):
    """The rows of an iteration table (numpy or a tensor), each item a 0-d
    tensor: what a plain version iterates without reading a device table
    back to the host (the values, float32, give the bits Python floats
    would)."""
    return torch.as_tensor(table).unbind(0)


def halo_block_sweeps_plain(u_e, p_e, bh_e, bv_e, inv_e, m_e, abc, stop=None):
    """Plain version of ``halo_block_sweeps``: ``sweep_plain`` once per row
    of ``abc``, on each block alone; where the flag ``stop`` is set, the
    blocks as they came (``unless_stopped``)."""
    wl, wu = left_up_weights(bh_e, bv_e)
    mask = m_e.to(torch.bool)
    u, prev = u_e, p_e
    for a, b, c in table_rows(abc):
        u, prev = sweep_plain(u, prev, wl, bh_e, wu, bv_e, inv_e, mask, a, b, c)
    return unless_stopped(stop, (u_e, p_e), (u, prev))


def halo_block_sweeps(u_e, p_e, bh_e, bv_e, inv_e, m_e, abc, stop=None):
    """The (n, 3) schedule ``abc`` on a halo-extended (h, w) block of the
    sharded step, or on an (nb, h, w) stack of them; returns (u, prev).
    Plain torch for CPU tensors, one K1 launch over the whole stack with
    n_active = k = n for CUDA tensors, handed the early exit's flag
    ``stop`` (``check_stop``): a stopped launch copies the blocks across,
    which leaves the interiors as they were.

    K1 reads zeros past each block where the TPU kernel's rolls wrap around;
    either way only the outer n rings are wrong, and the caller, whose halo
    is at least n wide, crops them."""
    if u_e.device.type == "cpu":
        return halo_block_sweeps_plain(u_e, p_e, bh_e, bv_e, inv_e, m_e, abc, stop)
    if not u_e.is_cuda:
        raise ValueError(f"halo_block_sweeps: unsupported device {u_e.device}")
    n = abc.shape[0]
    u_out, p_out = torch.empty_like(u_e), torch.empty_like(u_e)
    jc_sweep_tiles(u_e, p_e, u_out, p_out, bh_e, bv_e, inv_e, m_e.to(torch.uint8),
                   abc, 0, n, n, stop=stop)
    return u_out, p_out
