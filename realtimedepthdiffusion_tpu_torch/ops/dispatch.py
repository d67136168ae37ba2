"""Routing of the per-level sweeps (counterpart of ``realtimedepthdiffusion_tpu/ops/dispatch.py``).

The device of the tensors decides: a CPU tensor runs the plain torch
versions, a CUDA tensor runs the hand-written kernels. There is no
fallback between the two. The solver decides the kernels: the Jacobi
sweeps (``jacobi_chebyshev`` and ``jacobi``) run K1 and the cluster kernel
K2 (``ops/sweep.py``), and K6 (``ops/fused_sweep.py``) on levels whose weight
planes outgrow the card's L2 cache (``fused_level``); red-black runs K4 and
K5 (``ops/rb_sweep.py``). Both multigrid schemes solve their levels
through these routes. The V-cycle's polish (``core/multigrid.py``) smooths
its error equations through ``smooth_error``: one launch of
``vc_smooth_resident`` or ``vc_smooth_tiles`` a pass (``ops/vc_smooth.py``)
on a card, plain torch ops on the CPU; the rest of the polish is plain
torch ops on every device. The early exit's probe, after each chunk of
every solver, is the kernel ``residual_probe`` (``ops/probe.py``).
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..config import DiffusionConfig
from . import fused_sweep, probe, rb_sweep, sweep, vc_smooth

VALID_BACKENDS = ("auto", "xla", "pallas", "pallas_interpret")
VALID_SOLVERS = ("jacobi", "jacobi_chebyshev", "red_black")
VALID_MULTIGRIDS = ("cascadic", "vcycle")

# (plain version, kernels) of each solver: every iteration of a level ...
_FIXED = {
    "jacobi_chebyshev": (sweep.solve_level_plain, sweep.solve_level_cuda),
    "red_black": (rb_sweep.solve_level_rb_plain, rb_sweep.solve_level_rb_cuda),
}
# ... and the same in chunks, for the residual early exit.
_CHUNKS = {
    "jacobi_chebyshev": (sweep.chunks_plain, sweep.chunks_cuda),
    "red_black": (rb_sweep.chunks_plain, rb_sweep.chunks_cuda),
}
_FIXED["jacobi"] = _FIXED["jacobi_chebyshev"]
_CHUNKS["jacobi"] = _CHUNKS["jacobi_chebyshev"]
# The Jacobi sweeps with the weights derived in the kernel (K6).
_FUSED = (fused_sweep.solve_level_fused_plain, fused_sweep.solve_level_fused_cuda)
_FUSED_CHUNKS = (fused_sweep.fused_chunks_plain, fused_sweep.fused_chunks_cuda)
# The early exit's probe of a level, for every solver.
_PROBE = (probe.level_probe_plain, probe.level_probe_cuda)
# A smoothing pass of the V-cycle's polish.
_SMOOTH = (vc_smooth.smooth_plain, vc_smooth.smooth_cuda)
# The smoothing passes ``smooth_error`` issued, by route ("kernel" or
# "plain"). A pass is counted where it is issued, eagerly or into a capture;
# a replayed graph adds its capture's passes again (``utils/program.py``).
smooth_passes = collections.Counter()
# The L2 cache the CPU routes by: the H100's, so that the plain versions
# take the routes the card takes.
H100_L2_BYTES = 50 * 1024 * 1024


def check_supported(cfg: DiffusionConfig) -> None:
    """Raise for a config the port cannot solve, on every device."""
    if cfg.backend not in VALID_BACKENDS:
        raise ValueError(
            f"unknown backend {cfg.backend!r}; expected one of {VALID_BACKENDS}"
        )
    if cfg.solver not in VALID_SOLVERS:
        raise ValueError(
            f"unknown solver {cfg.solver!r}; expected one of {list(VALID_SOLVERS)}"
        )
    if cfg.multigrid not in VALID_MULTIGRIDS:
        raise ValueError(
            f"unknown multigrid {cfg.multigrid!r}; expected one of {VALID_MULTIGRIDS}"
        )


def _pick(pair, depth: torch.Tensor):
    if depth.is_cuda:
        return pair[1]
    if depth.device.type == "cpu":
        return pair[0]
    raise ValueError(f"unsupported device {depth.device}")


def l2_bytes(device: torch.device) -> int:
    """The L2 cache of the card ``device`` names; the H100's for the CPU."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).L2_cache_size
    return H100_L2_BYTES


def fused_route(h: int, w: int, device: torch.device, solver: str) -> bool:
    """Whether an (h, w) level on ``device`` runs K6 (its plain version on
    the CPU): a Jacobi solver on a level that ``sweep.strip_route`` sends to
    K6. Red-black keeps K4/K5. Decided from the shape alone, on the host."""
    if solver == "red_black":
        return False
    return sweep.strip_route(h, w, l2_bytes(device), sweep.resident_max_cluster(device)) == "K6"


def resident_work(h: int, w: int, device: torch.device, solver: str, sweeps: int,
                  chunk: int = 0):
    """``(sweeps, exchanges)`` of K2 on an (h, w) level on ``device`` that
    ran ``sweeps`` sweeps: in one launch, or in launches of ``chunk`` sweeps
    (the early exit's, the last one short); (0, 0) off K2's route (a
    red-black solver, or a level that ``sweep.strip_route`` sends
    elsewhere). Each launch reads its band edges once per
    ``sweep.resident_plan`` block. From the shapes alone, on the host."""
    cluster = sweep.resident_cluster(h, w, sweep.resident_max_cluster(device))
    if solver == "red_black" or cluster is None or sweeps <= 0:
        return 0, 0
    step = chunk if chunk > 0 else sweeps
    launches = [min(step, sweeps - b) for b in range(0, sweeps, step)]
    return sweeps, sum(-(-n // sweep.resident_plan(h, w, cluster, n)[0]) for n in launches)


def fused_level(depth: torch.Tensor, solver: str) -> bool:
    """``fused_route`` for the level ``depth``."""
    h, w = depth.shape
    return fused_route(h, w, depth.device, solver)


def run_sweeps(depth: torch.Tensor, mask: torch.Tensor, wts, table: np.ndarray,
               solver: str = "jacobi_chebyshev") -> torch.Tensor:
    """Every iteration of one level's table (``core/solver.py:_SCHEDULES``):
    the kernels for a CUDA tensor, the plain version for a CPU tensor."""
    return _pick(_FIXED[solver], depth)(depth, mask, wts, table)


def level_chunks(depth: torch.Tensor, mask: torch.Tensor, wts, table: np.ndarray,
                 solver: str = "jacobi_chebyshev"):
    """``(state, run, u_of)`` of one level for the residual early exit, on
    the kernels or the plain version as ``run_sweeps`` routes:
    ``run(state, base, n, stop=None)`` runs iterations base .. base+n-1,
    or leaves the state as it is where the early exit's 0-d int32 device
    flag ``stop`` is set, which every kernel launch of the chunk reads."""
    return _pick(_CHUNKS[solver], depth)(depth, mask, wts, table)


def run_fused(depth: torch.Tensor, mask: torch.Tensor, gray: torch.Tensor, table: np.ndarray,
              level: int, max_level: int, cfg: DiffusionConfig) -> torch.Tensor:
    """Every iteration of a ``fused_level`` level: K6 for a CUDA tensor, the
    plain version for a CPU tensor. The weights come from ``gray`` and the
    incoming depth, inside the kernel."""
    return _pick(_FUSED, depth)(depth, mask, gray, table, level, max_level, cfg)


def fused_chunks(depth: torch.Tensor, mask: torch.Tensor, gray: torch.Tensor,
                 table: np.ndarray, level: int, max_level: int, cfg: DiffusionConfig):
    """``(state, run, u_of)`` of a ``fused_level`` level for the residual
    early exit, routed as ``run_fused``; its ``run`` takes ``stop`` as
    ``level_chunks``' does."""
    return _pick(_FUSED_CHUNKS, depth)(depth, mask, gray, table, level, max_level, cfg)


def level_probe(mask: torch.Tensor, wts, metric: str, tol: float):
    """``(probe, route)``: the early exit's probe of one level,
    ``probe(u, c, n, stop, done, probes)`` after chunk ``c`` of ``n``
    iterations (``ops/probe.py:probe_plain``), on the kernel for a CUDA
    tensor (route ``"kernel"``) or in torch ops for a CPU tensor
    (``"plain"``)."""
    return _pick(_PROBE, mask)(mask, wts, metric, tol)


def smooth_error(e: torch.Tensor, rhs: torch.Tensor, mask: torch.Tensor, wts,
                 sweeps: int) -> torch.Tensor:
    """One smoothing pass of the V-cycle: ``sweeps`` Jacobi sweeps of the
    error equation (I - M) e = rhs from ``e``, e = 0 on the scribbles of the
    bool ``mask``. On the kernels for a CUDA tensor (``vc_smooth.smooth_plan``
    picks the route and launches), the plain version for a CPU tensor; the
    pass is counted in ``smooth_passes`` under its route."""
    fn = _pick(_SMOOTH, e)
    if sweeps > 0:
        smooth_passes["kernel" if fn is vc_smooth.smooth_cuda else "plain"] += 1
    return fn(e, rhs, mask, wts, sweeps)
