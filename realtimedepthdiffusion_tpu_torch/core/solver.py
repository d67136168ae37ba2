"""The per-level solvers (port of ``realtimedepthdiffusion_tpu/core/solver.py``).

``cfg.solver`` picks one of three, as in the reference:

- ``jacobi_chebyshev``: the reference algorithm, in the (a, b, c) form of the
  Pallas kernels (``ops/pallas_sweep.py:_sweep_full``), ``a*r + b*u +
  c*prev``, not the reference's XLA form ``omega*(gamma*(r-u)+u-prev)+prev``:
  the two are equal in exact arithmetic and differ in rounding.
- ``jacobi``: the table (1, 0, 0) through the same sweep path. Since
  ``1*r + 0*u + 0*prev == r`` exactly for finite u and prev, it computes
  what the reference's ``solve_jacobi`` computes.
- ``red_black``: projected SOR over the red and then the black cells, with
  the cyclic-Chebyshev omegas of ``rb_omegas`` (``ops/rb_sweep.py``).

Every solver honours the residual early exit (``cfg.early_exit``): the
level runs in chunks of ``cfg.residual_check_every`` iterations and stops
once the residual drops below ``tolerance * 255``. The loop is decided on
the device, as the reference's ``lax.while_loop``: every chunk is issued,
and a device flag that the probes set turns the chunks after the exit
into no-ops (``_chunked_early_exit``). Nothing is read back to the host
inside a solve, so a CUDA graph holds the whole loop. Each chunk runs on
the kernels or on the plain versions by the tensors' device
(``ops/dispatch.py``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import DiffusionConfig
from ..ops import dispatch
from ..ops.probe import residual_plain
from ..ops.rb_sweep import red_black_parity  # noqa: F401 (the solver's API, as in JAX)
from ..ops.sweep import average_plain, relax_plain
from .weights import EdgeWeights, edge_weights


def chebyshev_omegas(iters: int, cfg: DiffusionConfig = DiffusionConfig()) -> np.ndarray:
    """Per-iteration omega schedule: 1 for the first S sweeps, then
    2/(2-rho^2), then the recurrence 4/(4-rho^2*omega), stored in float32
    with float64 update arithmetic (C semantics of the original CUDA code)."""
    s = cfg.chebyshev_s
    rho2 = np.float32(cfg.chebyshev_rho) * np.float32(cfg.chebyshev_rho)
    out = np.empty(max(iters, 1), dtype=np.float32)
    omega = np.float32(0.0)
    for i in range(max(iters, 1)):
        if i < s:
            omega = np.float32(1.0)
        elif i == s:
            omega = np.float32(2.0 / (2.0 - np.float64(rho2)))
        else:
            omega = np.float32(4.0 / (4.0 - np.float64(rho2 * omega)))
        out[i] = omega
    return out[:iters]


def abc_schedule(iters: int, cfg: DiffusionConfig = DiffusionConfig()) -> np.ndarray:
    """(iters, 3) float32 rows (a, b, c) = (omega*gamma, omega - a, 1 - omega)."""
    om = chebyshev_omegas(iters, cfg).astype(np.float32)
    g = np.float32(cfg.chebyshev_gamma)
    a = om * g
    return np.stack([a, om - a, np.float32(1.0) - om], axis=1)


def jacobi_schedule(iters: int, cfg: DiffusionConfig = DiffusionConfig()) -> np.ndarray:
    """(iters, 3) float32 rows (1, 0, 0): plain Jacobi in the (a, b, c) form."""
    out = np.zeros((iters, 3), np.float32)
    out[:, 0] = 1.0
    return out


def rb_omegas(iters: int, cfg: DiffusionConfig = DiffusionConfig()) -> np.ndarray:
    """Per-half-sweep SOR omegas of red-black Gauss-Seidel, the cyclic
    Chebyshev method (Golub & Varga 1961): 1 for the first S half-sweeps,
    then 1/(1 - rho^2/2), then 1/(1 - rho^2*omega/4), in float64 with each
    entry stored as float32. An (iters, 2) table: [:, 0] is the red
    half-sweep's omega, [:, 1] the black one's; all ones when
    ``cfg.rb_chebyshev`` is off (plain Gauss-Seidel)."""
    n = max(iters, 1)
    out = np.ones((n, 2), dtype=np.float32)
    if cfg.rb_chebyshev:
        rho2 = float(np.float32(cfg.rb_rho)) ** 2
        s = cfg.chebyshev_s
        omega = 1.0
        for half in range(2 * n):
            if half < s:
                omega = 1.0
            elif half == s:
                omega = 1.0 / (1.0 - rho2 / 2.0)
            else:
                omega = 1.0 / (1.0 - rho2 * omega / 4.0)
            out[half // 2, half % 2] = np.float32(omega)
    return out[:iters]


# The iteration table of each solver: (iters, 3) (a, b, c) rows for the
# Jacobi sweeps, (iters, 2) omegas for red-black.
_SCHEDULES = {
    "jacobi_chebyshev": abc_schedule,
    "jacobi": jacobi_schedule,
    "red_black": rb_omegas,
}


@functools.lru_cache(maxsize=None)
def level_schedule(iters: int, cfg: DiffusionConfig) -> np.ndarray:
    """The iteration table of ``cfg.solver`` for ``iters`` iterations, made
    once per (iters, cfg) and read-only: every solve of a level reads the
    same array, which its kernels find on the card by its contents
    (``ops/sweep.py:device_table``), so that no frame makes or copies it
    again."""
    table = _SCHEDULES[cfg.solver](iters, cfg)
    table.setflags(write=False)
    return table


def jacobi_sweep(u: torch.Tensor, wts: EdgeWeights) -> torch.Tensor:
    """One weighted 5-point relaxation, clip((wl*ul + wr*ur + wu*uu +
    wd*ud) * inv_count, 0, 255), in the reference's XLA op order."""
    return relax_plain(u, wts.wl, wts.wr, wts.wu, wts.wd, wts.inv_count)


def jacobi_sweep_raw(u: torch.Tensor, wts: EdgeWeights) -> torch.Tensor:
    """The unclipped weighted average (wl*ul + wr*ur + wu*uu + wd*ud) *
    inv_count: the linear operator M = D^-1 W that the V-cycle's error
    equations smooth with (``core/multigrid.py``). Only the primal variable
    is clipped."""
    return average_plain(u, wts.wl, wts.wr, wts.wu, wts.wd, wts.inv_count)


def residual_norm(u: torch.Tensor, mask: torch.Tensor, wts: EdgeWeights) -> torch.Tensor:
    """Max-norm residual |relax(u) - u| over the pixels that are not scribbled."""
    return residual_plain(u, mask, wts, "max")


def residual_rms(u: torch.Tensor, mask: torch.Tensor, wts: EdgeWeights) -> torch.Tensor:
    """RMS residual sqrt(mean |relax(u) - u|^2) over the pixels that are not
    scribbled (the count is at least 1)."""
    return residual_plain(u, mask, wts, "rms")


def residual_metric_fn(cfg: DiffusionConfig):
    """The residual functional selected by ``cfg.residual_metric``."""
    try:
        return {"max": residual_norm, "rms": residual_rms}[cfg.residual_metric]
    except KeyError:
        raise ValueError(
            f"unknown residual_metric {cfg.residual_metric!r}; "
            "expected 'rms' or 'max'"
        ) from None


def _host_loop(device: torch.device) -> bool:
    """Whether the early exit reads its flag on the host: on the CPU only,
    where that costs no wait. The tests turn it off there to run the
    card's loop on the plain versions."""
    return device.type == "cpu"


def _chunked_early_exit(state, run, u_of, mask, wts, iters: int, cfg: DiffusionConfig,
                        exit_log=None):
    """Run iterations 0, 1, ... of a level in chunks, ``state =
    run(state, i, n, stop)``, while ``i < iters`` and the residual of
    ``u_of(state)``, probed after each chunk, is ``>= tolerance*255``: the
    reference's ``lax.while_loop`` condition. A chunk is
    ``min(residual_check_every, iters - i)`` iterations, so the loop never
    passes the cap, and with an unreachable tolerance it visits exactly
    the iterates of the fixed-count loop.

    The loop is unrolled into its ceil(iters / residual_check_every) chunks
    and decided on the device: a 0-d int32 flag ``stop``, which every
    chunk's launches take, is set once a probe falls below the threshold;
    from then on the chunks leave the state as it is. The probe
    (``ops/dispatch.py:level_probe``: the kernel ``residual_probe`` on a
    card, torch ops on the CPU) keeps a device count of the iterations and
    probes run and each probe's residual in a slot of its own, while
    ``stop`` is clear; on a card a probe after the exit returns at once. On
    a card nothing is read back, so a CUDA graph holds every chunk; on the
    CPU the loop reads the flag (no wait there) and stops issuing chunks
    once it is set, so its chunks never see it set.

    A list given as ``exit_log`` receives a dict of the level's shape, its
    cap of iterations (``cap``: its chunks are all issued), the iterations
    run, each probe's residual, the threshold and the probe's route
    (``probe``: ``"kernel"`` or ``"plain"``). The counts are read from the
    device once per solve, by ``read_exit_log``: on a card they are filled
    in there, on the CPU at once."""
    tol = float(np.float32(cfg.tolerance) * np.float32(255.0))
    chunk = max(int(cfg.residual_check_every), 1)
    probe, route = dispatch.level_probe(mask, wts, cfg.residual_metric, tol)
    dev = mask.device
    on_host = _host_loop(dev)
    n_chunks = -(-iters // chunk)
    stop = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros(2, dtype=torch.int32, device=dev)  # iterations run, probes run
    probes = torch.full((n_chunks,), math.nan, dtype=torch.float32, device=dev)
    for c in range(n_chunks):
        if on_host and bool(stop):
            break
        base = c * chunk
        n = min(chunk, iters - base)
        state = run(state, base, n, None if on_host else stop)
        probe(u_of(state), c, n, stop, done, probes)
    if exit_log is not None:
        exit_log.append({"shape": tuple(mask.shape), "cap": iters, "tol": tol, "probe": route,
                         "_device": (done, probes)})
        if on_host:
            read_exit_log(exit_log)
    return state


def read_exit_log(exit_log, wait: bool = True):
    """Fill in the iterations and probes of every entry of ``exit_log``
    that ``_chunked_early_exit`` left on the device; returns ``exit_log``.
    A probe after the exit is not reported. The pipeline calls it after a
    solve (eager or replayed) that was given a list; a caller of
    ``solve_level`` or ``solve_cascade`` on a card calls it itself, after
    the solve.

    The read is copies alone, no kernel: each entry's counts and probes go
    to the host as they are, on a card into pinned memory without waiting,
    in stream order (so a later replay that writes them again does not
    reach the copies). ``wait=False`` stops there; a later call waits for
    the copies, once per device, and fills the entries in."""
    events = {}
    for e in exit_log:
        dev = e.pop("_device", None)
        if dev is not None:
            e["_host"] = tuple(t.to("cpu", non_blocking=True) for t in dev)
            if dev[1].device.type == "cuda":
                e["_event"] = events.setdefault(dev[1].device, torch.cuda.Event())
    for device, event in events.items():
        event.record(torch.cuda.current_stream(device))
    if not wait:
        return exit_log
    for e in exit_log:
        host = e.pop("_host", None)
        if host is None:
            continue
        event = e.pop("_event", None)
        if event is not None:
            event.synchronize()
        done, probes = host
        e["iters"] = int(done[0])
        e["probes"] = probes[:int(done[1])].tolist()
    return exit_log


def solve_level(
    depth: torch.Tensor,
    mask: torch.Tensor,
    gray: torch.Tensor,
    level: int,
    max_level: int,
    iters: int,
    cfg: DiffusionConfig = DiffusionConfig(),
    exit_log=None,
) -> torch.Tensor:
    """Weights from the incoming (seeded) depth, then ``iters`` iterations
    of ``cfg.solver`` on the device the tensors live on, or fewer under the
    early exit, which reports to ``exit_log`` (``_chunked_early_exit``).
    On a ``dispatch.fused_level`` level the sweeps derive the weights
    themselves (K6), and the f32 planes are built only for the early exit's
    probe. On a card, the entries of ``exit_log`` are complete once
    ``read_exit_log`` has read them."""
    dispatch.check_supported(cfg)
    if iters <= 0:
        return depth.to(torch.float32)
    table = level_schedule(iters, cfg)
    fused = dispatch.fused_level(depth, cfg.solver)
    if fused and not cfg.early_exit:
        return dispatch.run_fused(depth, mask, gray, table, level, max_level, cfg)
    wts = edge_weights(gray, depth, level, max_level, cfg)
    if not cfg.early_exit:
        return dispatch.run_sweeps(depth, mask, wts, table, cfg.solver)
    if fused:
        state, run, u_of = dispatch.fused_chunks(depth, mask, gray, table, level, max_level, cfg)
    else:
        state, run, u_of = dispatch.level_chunks(depth, mask, wts, table, cfg.solver)
    return u_of(_chunked_early_exit(state, run, u_of, mask, wts, iters, cfg, exit_log))
