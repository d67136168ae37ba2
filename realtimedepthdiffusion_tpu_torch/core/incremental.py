"""The windowed incremental re-solve of the live loop (port of ``realtimedepthdiffusion_tpu/core/incremental.py``).

After a brush stroke only a fixed-size window centred on the edit is
re-solved at the fine pyramid levels, with the window's one-pixel border
ring frozen (Dirichlet) at the current depth. The coarse levels, which the
level-scaled window would cover whole, take a full warm re-solve at the
cascade's budget; nothing is overwritten by a pyrUp, so the converged fine
state away from the edit stays.

A new scribble changes the depth everywhere (diffusion has no finite
support), so a window solve alone would leave a seam at its border. The
coarse levels capture the global change cheaply; each finer level receives
it as a pyrUp'd correction (new minus old coarse state) added across the
whole level before its window solve. The frozen ring then carries the far
field into the window, and the rest of the level moves with the coarse
solution. The operator is linear off the scribbles and the clip, which
makes the correction exact to first order; the tests bound the RMSE
against a full re-solve.

The window's size is fixed by the config (``incremental_window``, halved
per level); its place follows the edit and is clamped to keep the window
inside the level. The centre is a (2,) int32 tensor on the solve's
device, as the reference's is a traced array: each windowed level computes
its window's origin there, crops by index tensors built from it and writes
the window back by ``index_put_``, so nothing is read to the host, the
shapes are fixed, and a CUDA graph captured at one centre replays at any
other. Each level solve runs through ``core/solver.py:solve_level``, so on
a card a window runs the same kernels as a level of its shape.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..config import DiffusionConfig
from .annotation import seed_depth
from .multigrid import build_annotation_pyramids
from .pyramid import pyr_up
from .solver import solve_level


def _ring(win: int, device=None) -> torch.Tensor:
    """Boolean border ring of a win x win window, made on the device (no
    host value is copied in, so a CUDA graph can capture it)."""
    idx = torch.arange(win, device=device)
    edge = (idx == 0) | (idx == win - 1)
    return edge[:, None] | edge[None, :]


def host_yx(name: str, yx) -> Tuple[int, int]:
    """``yx`` (a pair, a numpy array or a tensor on any device) as two
    Python ints; a tensor on a card is read back, which waits for it."""
    if isinstance(yx, torch.Tensor):
        yx = yx.tolist()
    y, x = (int(v) for v in yx)
    return y, x


def _card(device: torch.device):
    """(type, index) of a device, a card named without an index as the
    current one."""
    if device.type == "cuda" and device.index is None:
        return "cuda", torch.cuda.current_device()
    return device.type, device.index


def device_yx(name: str, yx, device) -> torch.Tensor:
    """``yx`` as a (2,) int32 tensor on ``device``: a tensor there is used
    as it is; host integers, a numpy array or a CPU tensor are uploaded, as
    ``jnp.asarray`` puts them on the device. A tensor on another device is
    refused: the solve would read it across devices."""
    device = torch.device(device)
    if isinstance(yx, torch.Tensor):
        if yx.device.type != "cpu" and _card(yx.device) != _card(device):
            raise ValueError(f"{name} must be host integers or a tensor on the CPU or on "
                             f"{device}, got a tensor on {yx.device}")
        out = yx.to(device=device, dtype=torch.int32)
    else:
        out = torch.tensor([int(v) for v in yx], dtype=torch.int32, device=device)
    if tuple(out.shape) != (2,):
        raise ValueError(f"{name} must be a (y, x) pair, got shape {tuple(out.shape)}")
    return out


def clamp_origin(oy: int, ox: int, win_h: int, win_w: int, h: int, w: int) -> Tuple[int, int]:
    """The origin of a (win_h, win_w) window moved to lie inside an (h, w)
    plane: the nearest place that holds it. Past the far edges that is what
    ``lax.dynamic_slice`` and ``lax.dynamic_update_slice`` do in the
    reference. A negative start they wrap first (they add the axis length,
    then clamp), which puts the window of an edit near the top or left edge
    at the far side of the image; here it goes to 0, next to the edit."""
    return min(max(oy, 0), h - win_h), min(max(ox, 0), w - win_w)


def window_indices(center: torch.Tensor, level: int, win: int, h: int, w: int):
    """The rows and columns (int64, on the centre's device) of level
    ``level``'s win x win window around the level-0 ``center``: from
    ``(center >> level) - win // 2``, clamped into [0, h - win] x [0, w -
    win] (``clamp_origin``'s rule), computed on the device."""
    ar = torch.arange(win, device=center.device)
    oy = ((center[0] >> level) - win // 2).clamp(0, h - win)
    ox = ((center[1] >> level) - win // 2).clamp(0, w - win)
    return oy + ar, ox + ar


def _crop(plane: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """``plane[rows][:, cols]``, gathered on the device."""
    return plane.index_select(0, rows).index_select(1, cols)


def solve_incremental(
    gray_pyr: Sequence[torch.Tensor],
    mask0: torch.Tensor,
    value0: torch.Tensor,
    depth_state: Sequence[torch.Tensor],
    center_yx,
    cfg: DiffusionConfig = DiffusionConfig(),
    exit_log=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Warm, windowed re-solve of an edit at ``center_yx`` (level-0
    coordinates). The windowed fine levels get ``incremental_iterations``
    (``max_iterations`` when 0) at level 0, halved per coarser windowed
    level; the coarse levels keep the cascade's schedule. Returns (depth0,
    new_state); ``depth_state`` is left as it was.

    ``center_yx`` is a (2,) int32 tensor on the planes' device, or what
    ``device_yx`` uploads there (a pair of ints, a numpy array, a CPU
    tensor; an upload cannot happen while a CUDA graph is captured). Each
    windowed level places its window on the device: its origin is
    ``(centre >> level) - win // 2``, clamped into the level. Under the
    early exit, ``exit_log`` receives every level solve in the order run."""
    center = device_yx("center_yx", center_yx, mask0.device)
    levels = len(gray_pyr)
    L = levels - 1
    inc = cfg.incremental_iterations if cfg.incremental_iterations > 0 else cfg.max_iterations

    masks, values = build_annotation_pyramids(mask0, value0, cfg)
    state = list(depth_state)

    delta = None  # the coarser level's correction (new - old), pyrUp'd downward
    for level in range(L, -1, -1):
        h, w = gray_pyr[level].shape
        win = cfg.incremental_window >> level
        old = state[level]

        # Inject the coarser level's correction, then pin the scribbles
        # again. A level's sweeps carry information only about as many
        # pixels as there are sweeps, so an edit's far field must arrive in
        # the initial state.
        u = old if delta is None else old + pyr_up(delta, (h, w))
        u = seed_depth(u, masks[level], values[level])

        # Only the fine levels are windowed (window and level halve
        # together, so a size ratio would choose alike everywhere); the
        # coarser ones carry the edit's whole far field at little cost and
        # take a full warm re-solve at the cascade's budget.
        windowed = level < cfg.incremental_window_levels and win < min(h, w)
        if not windowed:
            iters = cfg.level_iterations(levels, level)
            state[level] = solve_level(u, masks[level], gray_pyr[level], level, L, iters, cfg,
                                       exit_log)
            delta = state[level] - old
            continue

        iters = max(inc >> level, 1)
        # A few sweeps over the whole level refine the smooth injected
        # correction along this level's image edges.
        n_glob = min(int(cfg.incremental_global_smooth), iters)
        if n_glob > 0:
            u = solve_level(u, masks[level], gray_pyr[level], level, L, n_glob, cfg, exit_log)

        rows, cols = window_indices(center, level, win, h, w)
        # The frozen ring carries the far field into the window solve. The
        # weights come from the window's own crop, so those at its edge are
        # a border's.
        m_solve = _crop(masks[level], rows, cols) | _ring(win, u.device)
        u_w = solve_level(_crop(u, rows, cols), m_solve, _crop(gray_pyr[level], rows, cols),
                          level, L, iters, cfg, exit_log)
        new = u.clone()
        new.index_put_((rows[:, None], cols[None, :]), u_w)
        state[level] = new
        delta = new - old

    return state[0], tuple(state)
