"""The spatially sharded multi-device step (port of ``realtimedepthdiffusion_tpu/parallel/sharded.py``).

Each image is cut into a dy x dx grid of blocks, one per slot of a
``SlotMesh`` (``parallel/mesh.py``). Every k sweeps the slots exchange a
k-wide halo (``parallel/halo.py``) and run k sweeps on their extended
blocks: one launch per device over a stack of every block the device
holds, K1 for Jacobi-Chebyshev and K4 for red-black, with each block's
checkerboard parity (2k-wide halo, since an iteration reads two rings),
and one K3 launch per block for the defocus, behind a ring of
max_half + 1. The 'batch' axis splits a batch of images over the slots.
Levels whose blocks would be thinner than the exchange run replicated,
through the single-device ``core/solver.py:solve_level`` per image, on the
home device.

One process drives every slot, as one JAX program drives its mesh. The
residual early exit is decided on the device, as JAX's ``lax.while_loop``
over a residual gathered by ``psum``/``pmax``: the slots' partial sums
reach the home device by device-to-device copies, where one probe per
chunk sets a flag that every later launch of the level takes, so every
slot stops at the same iteration and the host reads nothing inside a step
(``_ShardedLevel.solve``). ``batched_step`` keeps the whole step as a CUDA
graph per argument signature where one card holds every slot, as JAX
compiles ``jax.jit(step)`` once per shape. The kernels and the plain
versions compute the same bits as the single-device path, so a sharded
level equals the single-device level exactly; only the early exit's
residual is summed in another order.
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DiffusionConfig
from ..core import effects as fx
from ..core import solver as core_solver
from ..core.annotation import annotation_pyr_down, seed_depth
from ..core.color import rgb_to_gray
from ..core.multigrid import (build_gray_pyramid, initial_depth_state, vcycle_polish,
                              vcycle_warm_config)
from ..core.pyramid import pyr_up
from ..core.solver import (abc_schedule, rb_omegas, read_exit_log, residual_metric_fn,
                           solve_level)
from ..core.weights import edge_weights
from ..ops.defocus import block_ring, defocus_block, defocus_block_sat, defocus_half_widths
from ..ops.dispatch import check_supported
from ..ops.rb_sweep import halo_block_rb_sweeps, halo_block_rb_sweeps_plain
from ..ops.sweep import (device_table, halo_block_sweeps, halo_block_sweeps_plain, left_up_weights,
                         relax_plain)
from ..utils.program import Program, leaves, signature
from .halo import extend_into, extend_with_halo
from .mesh import SlotMesh

# Halo width == sweeps between exchanges.
DEFAULT_HALO = 8

_SHARDED_SOLVERS = ("jacobi_chebyshev", "red_black")

# Blocks run by each route since the last reset (one per block and image):
# what shows, on the CPU, that the step went through the block functions.
block_calls = collections.Counter()

# The functions a sharded step runs on its blocks (and, for the defocus, on
# whole images whose blocks are thinner than the ring): the kernels, which
# take their plain versions on CPU tensors, or the plain versions on every
# device, which ``batched_step(plain=True)`` runs to hold the kernels to them.
_Blocks = collections.namedtuple("_Blocks", "plain jc rb defocus whole_defocus")
_KERNELS = _Blocks(False, halo_block_sweeps, halo_block_rb_sweeps, defocus_block, fx.defocus)
_PLAIN = _Blocks(True, halo_block_sweeps_plain, halo_block_rb_sweeps_plain, defocus_block_sat,
                 fx.defocus_sat)


def _pad_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def _check_solver(cfg: DiffusionConfig) -> None:
    check_supported(cfg)
    if cfg.solver not in _SHARDED_SOLVERS:
        raise NotImplementedError(
            f"multi-chip path implements solvers {_SHARDED_SOLVERS}, got "
            f"{cfg.solver!r}; use the single-chip pipeline for 'jacobi'"
        )


def _foreach_image(batched: bool, fn, *arrays):
    """``fn`` over the leading image axis of batched arrays, stacked (a
    tuple of stacks where ``fn`` returns a tuple); ``fn`` itself otherwise."""
    if not batched:
        return fn(*arrays)
    outs = [fn(*parts) for parts in zip(*arrays)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(p) for p in zip(*outs))
    return torch.stack(outs)


def exchange_width(solver: str, halo: int = DEFAULT_HALO) -> int:
    """The halo a level's blocks exchange: k for Jacobi-Chebyshev, 2k for
    red-black, whose iteration spoils two rings."""
    return 2 * halo if solver == "red_black" else halo


def level_is_sharded(mesh: SlotMesh, h: int, w: int, solver: str,
                     halo: int = DEFAULT_HALO) -> bool:
    """Whether an (h, w) level runs sharded: the mesh splits the image, and
    every block is at least as tall and as wide as the exchange. (JAX asks
    for ``halo`` on both solvers; a red-black block thinner than 2k cannot
    take its exchange there either.)"""
    dy, dx = mesh.shape["dy"], mesh.shape["dx"]
    width = exchange_width(solver, halo)
    return dy * dx > 1 and h // dy >= width and w // dx >= width


def _residual_reduce(mesh: SlotMesh, d, m, cfg: DiffusionConfig) -> torch.Tensor:
    """The one residual every slot agrees on, from each slot's per-pixel
    |relax(u) - u| blocks ``d`` and its mask blocks ``m`` ((n, h, w) each):
    a 0-d float32 tensor on the home device, where each slot's partial
    result arrives by a device-to-device copy. max: the largest off-mask
    value over all slots. rms: each image's sum of squares and off-mask
    count added over its slots, then the largest per-image rms (the exit
    waits for every image of the batch)."""
    home = mesh.home
    if cfg.residual_metric == "max":
        per_slot = [torch.where(m[s], 0.0, d[s]).amax().to(home) for s in mesh.slots]
        return torch.stack(per_slot).max()
    sq, cnt = {}, {}
    for s in mesh.slots:
        sq[s] = torch.where(m[s], 0.0, d[s] * d[s]).sum(dim=(-2, -1)).to(home)
        cnt[s] = torch.where(m[s], 0.0, 1.0).sum(dim=(-2, -1)).to(home)
    rows = [[s for s in mesh.slots if s[0] == p] for p in range(mesh.shape["batch"])]
    sq_img = torch.stack([torch.stack([sq[s] for s in row]).sum(0) for row in rows])
    cnt_img = torch.stack([torch.stack([cnt[s] for s in row]).sum(0) for row in rows])
    return torch.sqrt(sq_img / torch.clamp(cnt_img, min=1.0)).max()


class _ShardedLevel:
    """One level's padded planes scattered over the mesh and extended once
    by the exchange width, the probe of the early exit, and the loop that
    runs chunks of iterations until the probe or the budget says stop. The
    solvers below supply ``state``, ``run`` and ``u_of``.

    The extended blocks of every slot on a device lie in one (N, h+2w,
    w+2w) stack per device, slot after slot (``at``), so one kernel launch
    serves all of a device's blocks; ``bh_e``, ``bv_e`` and ``inv_e`` are
    per-slot views of the weight stacks."""

    def __init__(self, mesh, u, planes, m, width, plain):
        self.mesh, self.width, self.plain = mesh, width, plain
        self.hb, self.wb = u.shape[-2] // mesh.shape["dy"], u.shape[-1] // mesh.shape["dx"]
        self.m = {s: b.to(torch.bool) for s, b in mesh.scatter(m).items()}
        self.u0 = mesh.scatter(u)
        self.nb = self.u0[mesh.home_slot].shape[0]
        self.n_blocks = self.nb * len(mesh.slots)
        self.at, self.stack_len = {}, collections.Counter()
        for s, d in mesh.devices.items():
            self.at[s] = (d, self.stack_len[d])
            self.stack_len[d] += self.nb
        self.canvas = None
        self.stacks = [self.stack(mesh.scatter(p)) for p in (*planes, m)]
        self.bh_e, self.bv_e, self.inv_e = (self.views(st) for st in self.stacks[:3])
        # The planes extended by one ring, for the probe.
        c = width - 1
        ring1 = (lambda a: a[..., c:-c, c:-c]) if c else (lambda a: a)  # noqa: E731
        self.probe_planes = {
            s: (*left_up_weights(ring1(self.bh_e[s]), ring1(self.bv_e[s])), ring1(self.bh_e[s]),
                ring1(self.bv_e[s]), ring1(self.inv_e[s]))
            for s in mesh.slots}

    def views(self, stacks):
        """Each slot's blocks in the per-device ``stacks``."""
        return {s: stacks[d][i:i + self.nb] for s, (d, i) in self.at.items()}

    def stack(self, blocks, stacks=None):
        """The per-slot ``blocks`` extended by the exchange width, written
        into per-device ``stacks`` (new zeroed ones if None); returns them."""
        if stacks is None:
            like = blocks[self.mesh.home_slot]
            e = 2 * self.width
            stacks = {d: torch.zeros((n, self.hb + e, self.wb + e), dtype=like.dtype, device=d)
                      for d, n in self.stack_len.items()}
        extend_into(self.mesh, blocks, self.width, self.views(stacks))
        return stacks

    def crop(self, stacks):
        """Each slot's blocks in the per-device ``stacks``, less the ring."""
        k = self.width
        return {s: v[..., k:-k, k:-k] for s, v in self.views(stacks).items()}

    def refill(self, src, dst):
        """One exchange: the interiors of the per-device stacks ``src``
        extended by their neighbours' data into the stacks ``dst``. Where
        one device holds every slot, the interiors go into a zero-ringed
        canvas of the whole padded images, and the extended blocks are its
        overlapping windows: two copies whatever the mesh, where
        ``extend_into`` makes up to nine per slot."""
        if not _one_device(self.mesh):
            extend_into(self.mesh, self.crop(src), self.width, self.views(dst))
            return
        (dev, s_in), = src.items()
        b, dy, dx = (self.mesh.shape[a] for a in ("batch", "dy", "dx"))
        k, hb, wb, nb = self.width, self.hb, self.wb, self.nb
        he, we = hb + 2 * k, wb + 2 * k
        if self.canvas is None:
            self.canvas = s_in.new_zeros((b * nb, dy * hb + 2 * k, dx * wb + 2 * k))
        c = self.canvas
        c[:, k:-k, k:-k].view(b, nb, dy, hb, dx, wb).copy_(
            s_in.view(b, dy, dx, nb, he, we)[..., k:-k, k:-k].permute(0, 3, 1, 4, 2, 5))
        windows = c.unfold(1, he, hb).unfold(2, we, wb).view(b, nb, dy, dx, he, we)
        dst[dev].view(b, dy, dx, nb, he, we).copy_(windows.permute(0, 2, 3, 1, 4, 5))

    def tables(self, table: np.ndarray):
        """``table`` on each device (on the CPU for the plain runs)."""
        if self.plain:
            host = torch.from_numpy(np.ascontiguousarray(table, np.float32))
            return {d: host for d in self.stack_len}
        return {d: device_table(table, d) for d in self.stack_len}

    def residual(self, us, cfg) -> torch.Tensor:
        u1 = extend_with_halo(self.mesh, us, 1)
        d = {}
        for s in self.mesh.slots:
            wl, wu, bh, bv, inv = self.probe_planes[s]
            d[s] = torch.stack([
                (relax_plain(u1[s][n], wl[n], bh[n], wu[n], bv[n], inv[n])[1:-1, 1:-1]
                 - us[s][n]).abs()
                for n in range(us[s].shape[0])])
        return _residual_reduce(self.mesh, d, self.m, cfg)

    def solve(self, state, run, u_of, iters, cfg, exit_log, shape):
        """``state = run(state, base, n, stop)`` for a fixed count, or the
        early exit under JAX's contract (``lax.while_loop`` then
        ``lax.cond``): full chunks of ``residual_check_every`` while they
        fit the budget and the last probe is >= tolerance*255, then the
        truncated tail if the probe still says go, which counts as the
        whole budget.

        The loop is decided on the device, as the single-device one
        (``core/solver.py:_chunked_early_exit``): its iters // chunk full
        chunks and the tail are all issued, each handed ``stop``, a 0-d
        int32 flag per device that holds slots (the home device's, copied
        to the others after each probe), which a probe after a full chunk
        sets where the residual is below the threshold or NaN; a stopped
        chunk leaves the state as it is. Device counts of the iterations
        and probes advance while the flag is clear, and each probe's
        residual goes to a slot of its own. On the CPU the loop reads the
        flag (no wait there) and stops issuing chunks, handing them none.

        Under the early exit, appends to a list given as ``exit_log`` the
        single-device entry: the level's shape, its cap, the threshold, the
        probe's route (``"plain"``: this probe is torch ops on every device)
        and the device counts, which ``read_exit_log`` turns into ``iters``
        and ``probes`` (on the CPU at once)."""
        if not cfg.early_exit:
            return run(state, 0, iters, None)
        tol = float(np.float32(cfg.tolerance) * np.float32(255.0))
        chunk = max(int(cfg.residual_check_every), 1)
        n_full, rem = divmod(iters, chunk)
        home = self.mesh.home
        on_host = core_solver._host_loop(home)
        stop = torch.zeros((), dtype=torch.int32, device=home)
        flags = {d: stop if d == home else torch.zeros_like(stop, device=d)
                 for d in self.stack_len}
        handed = None if on_host else flags
        done = torch.zeros(2, dtype=torch.int32, device=home)  # iterations run, probes run
        probes = torch.full((n_full,), math.nan, dtype=torch.float32, device=home)
        for c in range(n_full):
            if on_host and bool(stop):
                break
            state = run(state, c * chunk, chunk, handed)
            res = self.residual(u_of(state), cfg)
            live = 1 - stop
            done[0].add_(live, alpha=chunk)
            done[1].add_(live)
            probes[c] = res
            stop.bitwise_or_(res.ge(tol).logical_not())  # NaN stops, as in JAX
            for f in flags.values():
                if f is not stop:
                    f.copy_(stop)
        if rem and not (on_host and bool(stop)):
            state = run(state, n_full * chunk, rem, handed)
            done[0].add_(1 - stop, alpha=rem)
        if exit_log is not None:
            exit_log.append({"shape": shape, "cap": iters, "tol": tol, "probe": "plain",
                             "_device": (done, probes)})
            if on_host:
                read_exit_log(exit_log)
        return state


def _one_device(mesh) -> bool:
    return len(set(mesh.devices.values())) == 1


def _flag(stop, device) -> dict:
    """The keyword that hands ``device``'s early-exit flag to a block
    function; none without flags."""
    return {} if stop is None else {"stop": stop[device]}


def _jc_level(mesh, u, planes, m, iters, cfg, k, blocks, exit_log, shape):
    lv = _ShardedLevel(mesh, u, planes, m, k, blocks.plain)
    tables = lv.tables(abc_schedule(iters, cfg))
    weights = {d: tuple(st[d] for st in lv.stacks) for d in lv.stack_len}
    u_e, p_e = lv.stack(lv.u0), lv.stack(lv.u0)

    def exchange(state, base, n, stop):
        """One halo exchange of (u, prev) into each device's stacks, then
        n <= k sweeps over each stack in one call, given each device's
        early-exit flag. The state is each device's (u, prev) stacks with a
        ring, which only the interiors of matter. A call writes new
        tensors, so no stack is both its input and its output."""
        lv.refill(state[0], u_e)
        lv.refill(state[1], p_e)
        block_calls["jacobi_chebyshev"] += lv.n_blocks
        out = {d: blocks.jc(u_e[d], p_e[d], *weights[d], tables[d][base:base + n],
                            **_flag(stop, d))
               for d in weights}
        return tuple({d: o[t] for d, o in out.items()} for t in (0, 1))

    def run(state, base, n, stop):
        for b0 in range(base, base + n, k):
            state = exchange(state, b0, min(k, base + n - b0), stop)
        return state

    state = (lv.stack(lv.u0), lv.stack({s: torch.zeros_like(b) for s, b in lv.u0.items()}))
    state = lv.solve(state, run, lambda st: lv.crop(st[0]), iters, cfg, exit_log, shape)
    return lv.crop(state[0])


def _rb_level(mesh, u, planes, m, iters, cfg, k, blocks, exit_log, shape):
    ew = exchange_width("red_black", k)
    lv = _ShardedLevel(mesh, u, planes, m, ew, blocks.plain)
    tables = lv.tables(rb_omegas(iters, cfg))
    weights = {d: tuple(st[d] for st in lv.stacks) for d in lv.stack_len}
    # The checkerboard parity of each block's global origin, in the order of
    # its device's stack; the extended block's origin is ew rows up and ew
    # columns left, which keeps it.
    parity = {d: [] for d in lv.stack_len}
    for (_, i, j), (d, _) in lv.at.items():
        parity[d] += [(i * lv.hb + j * lv.wb) & 1] * lv.nb
    u_e = lv.stack(lv.u0)

    def exchange(state, base, n, stop):
        """One 2k-halo exchange of u into each device's stack, then n <= k
        iterations over each stack in one call, given each device's
        early-exit flag. The state is each device's stack of u with a ring,
        which only the interiors of matter. A call writes a new tensor, so
        no stack is both its input and its output."""
        lv.refill(state, u_e)
        block_calls["red_black"] += lv.n_blocks
        return {d: blocks.rb(u_e[d], *weights[d], parity[d], tables[d][base:base + n],
                             **_flag(stop, d))
                for d in weights}

    def run(state, base, n, stop):
        for b0 in range(base, base + n, k):
            state = exchange(state, b0, min(k, base + n - b0), stop)
        return state

    state = lv.solve(lv.stack(lv.u0), run, lv.crop, iters, cfg, exit_log, shape)
    return lv.crop(state)


def solve_level_sharded(depth, mask, gray, level: int, max_level: int, iters: int,
                        mesh: SlotMesh, cfg: DiffusionConfig = DiffusionConfig(),
                        halo: int = DEFAULT_HALO, return_info: bool = False, *,
                        exit_log=None):
    """The sharded ``core/solver.py:solve_level``: weights from the incoming
    depth, globally; pad to the mesh grid (pad pixels are scribbled at 0 and
    carry zero weights); iterate on the slots with halo exchanges; gather
    and crop. Takes (H, W) arrays, which run on the mesh's batch row 0 (JAX
    replicates them over the batch axis, to the same result), or (B, H, W)
    batches, whose B divides by the batch axis.

    ``return_info=True`` returns ``(out, iters_done, residual)`` as Python
    numbers, read from the device once after the level: ``iters_done <
    iters`` exactly when the early exit fired, ``iters_done == iters`` when
    the whole budget ran (the truncated tail included), and ``residual`` is
    the last full chunk's probe (+inf with no probe). Under the early exit,
    a list given as ``exit_log`` receives the level's entry
    (``_ShardedLevel.solve``), read here once."""
    entries = []
    out = _level_sharded(depth, mask, gray, level, max_level, iters, mesh, cfg, halo, _KERNELS,
                         entries)
    read_exit_log(entries)
    if exit_log is not None:
        exit_log.extend(entries)
    if not return_info:
        return out
    if not entries:
        return out, max(iters, 0), math.inf
    e, = entries
    return out, e["iters"], e["probes"][-1] if e["probes"] else math.inf


def _level_sharded(depth, mask, gray, level, max_level, iters, mesh, cfg, halo, blocks,
                   exit_log):
    """``solve_level_sharded``'s level on ``blocks``; an early-exit entry goes
    to ``exit_log`` unread."""
    _check_solver(cfg)
    residual_metric_fn(cfg)  # refuse an unknown metric before any work
    batched = depth.dim() == 3
    if not batched:
        depth, mask, gray = depth[None], mask[None], gray[None]
        mesh = mesh.batch_row(0)
    h, w = depth.shape[-2:]
    if iters <= 0:
        out = depth.to(torch.float32)
        return out if batched else out[0]
    dy, dx = mesh.shape["dy"], mesh.shape["dx"]
    wts = [edge_weights(g, d, level, max_level, cfg) for g, d in zip(gray, depth)]
    pad = (0, _pad_up(w, dx) - w, 0, _pad_up(h, dy) - h)
    u = F.pad(depth.to(torch.float32), pad)
    m = F.pad(mask.to(torch.uint8), pad, value=1)
    # The packed symmetric planes: bh = the pair weight (x, x+1) = wr, bv = wd.
    planes = [F.pad(torch.stack([getattr(wt, name) for wt in wts]), pad)
              for name in ("wr", "wd", "inv_count")]
    run = _rb_level if cfg.solver == "red_black" else _jc_level
    us = run(mesh, u, planes, m, iters, cfg, halo, blocks, exit_log, (h, w))
    out = mesh.gather(us)[..., :h, :w]
    return out if batched else out[0]


def solve_cascade_sharded(gray_pyr, mask0, value0, depth_state, mesh: SlotMesh,
                          cfg: DiffusionConfig = DiffusionConfig(), halo: int = DEFAULT_HALO,
                          *, exit_log=None):
    """The coarse-to-fine solve with a shard-or-replicate choice per level
    (``level_is_sharded``); single images or batches (a leading axis).
    Replicated levels run ``solve_level`` per image on the home device, so
    on a card they take K1, K2 or K6 as a single image would. A list given
    as ``exit_log`` receives every level's early exit, read once after the
    solve."""
    out = _cascade_sharded(gray_pyr, mask0, value0, depth_state, mesh, cfg, halo, _KERNELS,
                           exit_log)
    if exit_log is not None:
        read_exit_log(exit_log)
    return out


def _cascade_sharded(gray_pyr, mask0, value0, depth_state, mesh, cfg, halo, blocks, exit_log):
    _check_solver(cfg)
    batched = mask0.dim() == 3
    levels = len(gray_pyr)
    L = levels - 1
    sizes = [tuple(g.shape[-2:]) for g in gray_pyr]
    masks, values = [mask0], [value0]
    for lv in range(1, levels):
        m, v = _foreach_image(batched, lambda mi, vi: annotation_pyr_down(mi, vi, sizes[lv]),
                              masks[-1], values[-1])
        masks.append(m)
        values.append(v)

    state = list(depth_state)
    state[L] = seed_depth(state[L], masks[L], values[L])
    for level in range(L, -1, -1):
        iters = cfg.level_iterations(levels, level)
        if level_is_sharded(mesh, *sizes[level], cfg.solver, halo):
            state[level] = _level_sharded(
                state[level], masks[level], gray_pyr[level], level, L, iters, mesh, cfg, halo,
                blocks, exit_log)
        elif blocks.plain:
            raise ValueError(f"plain=True holds only sharded levels, and the {sizes[level]} level "
                             f"runs replicated on mesh {mesh.shape}, on the kernels")
        else:
            state[level] = _foreach_image(
                batched, lambda d, m, g: solve_level(d, m, g, level, L, iters, cfg, exit_log),
                state[level], masks[level], gray_pyr[level])
        if level > 0:
            up = _foreach_image(batched, lambda d: pyr_up(d, sizes[level - 1]), state[level])
            state[level - 1] = seed_depth(up, masks[level - 1], values[level - 1])
    return state[0], tuple(state)


def solve_vcycle_sharded(gray_pyr, mask0, value0, depth_state, mesh: SlotMesh,
                         cfg: DiffusionConfig = DiffusionConfig(), halo: int = DEFAULT_HALO,
                         *, exit_log=None):
    """The V-cycle over a mesh: the sharded cascadic warm start
    (``vcycle_warm_config``; the halo-block kernels on a card), then the
    error-correction cycles per image on the home device. The polish is
    plain torch ops and launches no kernel of the port (the reference leaves
    it to XLA's partitioner), so it has nothing to shard. Single images or
    batches (a leading axis). ``exit_log`` as ``solve_cascade_sharded``
    fills it."""
    out = _vcycle_sharded(gray_pyr, mask0, value0, depth_state, mesh, cfg, halo, _KERNELS,
                          exit_log)
    if exit_log is not None:
        read_exit_log(exit_log)
    return out


def _vcycle_sharded(gray_pyr, mask0, value0, depth_state, mesh, cfg, halo, blocks, exit_log):
    _, state = _cascade_sharded(gray_pyr, mask0, value0, depth_state, mesh,
                                vcycle_warm_config(cfg), halo, blocks, exit_log)
    u = _foreach_image(mask0.dim() == 3,
                       lambda m, v, u0, *gp: vcycle_polish(gp, m, v, u0, cfg),
                       mask0, value0, state[0], *gray_pyr)
    return u, (u,) + tuple(state[1:])


def sharded_defocus(mesh: SlotMesh, full_h: int, full_w: int,
                    cfg: DiffusionConfig = DiffusionConfig()):
    """The sharded defocus: the rgb blocks exchange a ring of max_half + 1
    (all a window can reach), then each block runs K3 with its global origin
    and the whole image's size, so the count clips as on the whole image.
    The half-widths come from the whole image's depth, before the split;
    depth needs no exchange. Blocks thinner than the ring run K3 on each
    whole image instead, JAX's route for them.

    Returns apply(rgb (B, H, W, 3) uint8, depth (B, H, W) float32, clipped)
    -> (B, H, W, 3) uint8."""
    return _defocus_sharded(mesh, full_h, full_w, cfg, _KERNELS)


def _defocus_sharded(mesh, full_h, full_w, cfg, blocks):
    ew = block_ring(full_h, full_w, cfg)
    dy, dx = mesh.shape["dy"], mesh.shape["dx"]

    def apply(rgb, depth):
        b, h, w = depth.shape
        hp, wp = _pad_up(h, dy), _pad_up(w, dx)
        if hp // dy < ew or wp // dx < ew:
            return torch.stack([blocks.whole_defocus(r, d, cfg) for r, d in zip(rgb, depth)])
        half = defocus_half_widths(depth, full_h, full_w, cfg)
        pad = (0, wp - w, 0, hp - h)
        chw_e = extend_with_halo(mesh, mesh.scatter(F.pad(rgb[..., :3].permute(0, 3, 1, 2), pad)),
                                 ew)
        halves = mesh.scatter(F.pad(half, pad))
        hb, wb = hp // dy, wp // dx
        out = {}
        for s, c in chw_e.items():
            _, i, j = s
            block_calls["defocus"] += c.shape[0]
            out[s] = torch.stack([blocks.defocus(c[n], halves[s][n], i * hb, j * wb, full_h,
                                                 full_w, cfg) for n in range(c.shape[0])])
        return mesh.gather(out, y_axis=-3)[:, :h, :w]

    return apply


def step_captures(device_type: str, one_device: bool, plain: bool) -> bool:
    """Whether ``batched_step`` keeps its step as CUDA graphs: on a card,
    where one device holds every slot (one ``torch.cuda.graph`` captures
    one device's stream), on the kernels (the plain versions are the
    kernels' yardstick, run eagerly). Elsewhere the step runs eagerly."""
    return device_type == "cuda" and one_device and not plain


def batched_step(mesh: SlotMesh, rows: int, cols: int, cfg: DiffusionConfig = DiffusionConfig(),
                 effect: int = fx.EFFECT_HAZE, halo: int = DEFAULT_HALO, *, plain: bool = False):
    """The full multi-device step: data parallel over a batch of images (the
    'batch' axis), each image sharded over ('dy', 'dx'); the counterpart of
    JAX's ``jax.jit(step)``.

    Returns (fn, make_example_args): fn(rgb (B, H, W, 3) uint8, mask, value
    (B, H, W), depth_state (a (B, h_l, w_l) tensor per level), exit_log=None)
    -> (depth (B, H, W), new_state, effect (B, H, W, 3) uint8), with B a
    multiple of the batch axis. The glue (gray pyramid, annotation
    pyramids, pyrUp, the pointwise effects) runs per image on the home
    device; the defocus runs sharded; the early exit is decided on the
    device (``_ShardedLevel.solve``), and a list given as ``exit_log``
    receives every level's entry, read once after the step.

    Where ``step_captures`` says so (a mesh on one card, on the kernels),
    ``fn`` keeps a program per argument signature (``utils/program.py``),
    as JAX's jit compiles per shape: the first call with a signature whose
    tensors lie on the mesh's home device runs eagerly and captures the
    step into a CUDA graph at its end; later calls replay it, copying the
    arguments into the graph's static tensors and returning copies of its
    outputs, with the capture's kernel launches and ``block_calls`` added
    to the counts. A capture that fails raises. The graphs share a memory
    pool of their own. Eager, and said so here: ``plain=True`` (the blocks'
    plain versions even on a card, to hold the kernels to them; it raises
    where a level would run replicated, which only the kernels' routes
    solve), CPU meshes, and a mesh whose slots span several cards, which
    still runs on the kernels with the loop decided on the devices.
    ``fn.eager`` is the step itself (it leaves ``exit_log`` unread) and
    ``fn.programs`` its programs by signature."""
    _check_solver(cfg)
    blocks = _PLAIN if plain else _KERNELS
    scheme = _vcycle_sharded if cfg.multigrid == "vcycle" else _cascade_sharded
    if effect == fx.EFFECT_DEFOCUS:
        defocus_apply = _defocus_sharded(mesh, rows, cols, cfg, blocks)
        render = lambda rgb, gray0, depth0: defocus_apply(rgb, depth0)  # noqa: E731
    else:
        render = lambda rgb, gray0, depth0: torch.stack([  # noqa: E731
            fx.apply_effect(effect, r, g, d, cfg) for r, g, d in zip(rgb, gray0, depth0)])

    def step(rgb, mask, value, depth_state, exit_log=None):
        b = rgb.shape[0]
        if tuple(rgb.shape[1:3]) != (rows, cols):
            raise ValueError(f"batched_step for {rows}x{cols} got images {tuple(rgb.shape)}")
        if b % mesh.shape["batch"]:
            raise ValueError(f"a batch of {b} does not split over the mesh's batch axis "
                             f"of {mesh.shape['batch']}")
        gray0 = rgb_to_gray(rgb)
        gpyr = tuple(torch.stack(lv) for lv in zip(*(build_gray_pyramid(g, cfg) for g in gray0)))
        depth0, new_state = scheme(gpyr, mask, value, depth_state, mesh, cfg, halo, blocks,
                                   exit_log)
        out = render(rgb, gray0, torch.clamp(depth0, 0.0, 255.0))
        return depth0, new_state, out

    captures = step_captures(mesh.home.type, _one_device(mesh), plain)
    programs = {}
    pool = []  # the graphs' memory pool and capture stream, made at the first capture

    def fn(rgb, mask, value, depth_state, exit_log=None):
        args = (rgb, mask, value, tuple(depth_state))
        sig = signature(args)
        prog = programs.get(sig)
        if prog is not None:
            return prog(args, exit_log)
        out = step(*args, exit_log)
        if exit_log is not None:
            read_exit_log(exit_log)
        if captures and sig is not None and all(t.device == mesh.home for t in leaves(args)):
            if not pool:
                pool.extend((torch.cuda.graph_pool_handle(), torch.cuda.Stream(mesh.home)))
            programs[sig] = Program(step, args, mesh.home, *pool, counter=block_calls)
        return out

    fn.eager, fn.programs = step, programs

    def make_example_args(batch: int | None = None):
        """JAX's example inputs, on the home device: a seeded random image
        and two scribbles per image."""
        b = batch or mesh.shape["batch"]
        rng = np.random.default_rng(0)
        rgb = rng.integers(0, 256, (b, rows, cols, 3), dtype=np.uint8)
        mask = np.zeros((b, rows, cols), bool)
        value = np.zeros((b, rows, cols), np.uint8)
        mask[:, rows // 4, cols // 4] = True
        value[:, rows // 4, cols // 4] = 254
        mask[:, 3 * rows // 4, 3 * cols // 4] = True
        home = mesh.home
        state = tuple(torch.stack([s] * b) for s in initial_depth_state(rows, cols, cfg, home))
        return (torch.from_numpy(rgb).to(home), torch.from_numpy(mask).to(home),
                torch.from_numpy(value).to(home), state)

    return fn, make_example_args
