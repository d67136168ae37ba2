"""The residual early exit's probe: kernel ``residual_probe`` (``csrc/probe.cu``) and its plain version.

The probe runs after every chunk of a level under the early exit
(``core/solver.py:_chunked_early_exit``): it takes the residual of the
state, counts the chunk's iterations and the probe while the device flag
``stop`` is clear, keeps the residual in the chunk's slot, and sets
``stop`` once the residual falls below the threshold (or is NaN).

- ``residual_plain`` is the residual functional in torch ops, ``rms`` or
  ``max`` (``core/solver.py:residual_rms`` and ``residual_norm`` are it).
- ``probe_plain`` is one whole probe in torch ops, the loop's bookkeeping
  included. The CPU runs it; on the card the kernel is held to it.
- ``residual_probe`` is the kernel: the whole probe in one launch, which
  returns at once where ``stop`` is set. It replaces no Pallas kernel (the
  JAX package leaves the probe to XLA); it takes the place of about 35
  torch launches a chunk.
- ``level_probe_plain`` / ``level_probe_cuda`` make a level's probe once,
  before its chunk loop (the mask's u8 copy, the kernel's scratch), as
  ``probe(u, c, n, stop, done, probes)`` with the name of its route;
  ``ops/dispatch.py:level_probe`` picks one by the tensors' device.

``residual_probe.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch

from . import build
from .sweep import _check, _same_device, _stream, relax_plain

METRICS = ("rms", "max")
# The kernel's threads per block and most blocks: 4 blocks of 256 threads
# on each of an H100's 132 SMs are resident at once, so a launch after the
# exit, whose blocks read ``stop`` and return, is one wave.
PROBE_THREADS = 256
PROBE_MAX_BLOCKS = 528


def _check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"unknown residual_metric {metric!r}; expected 'rms' or 'max'")


def residual_plain(u: torch.Tensor, mask: torch.Tensor, wts, metric: str) -> torch.Tensor:
    """The residual of u over the pixels that are not scribbled, r =
    relax(u) - u: ``max``, the largest |r|; ``rms``, sqrt(mean r^2) with the
    count at least 1. A 0-d float32 tensor."""
    _check_metric(metric)
    r = torch.where(mask, 0.0, relax_plain(u, wts.wl, wts.wr, wts.wu, wts.wd, wts.inv_count) - u)
    if metric == "max":
        return r.abs().max()
    cnt = torch.clamp(torch.where(mask, 0.0, 1.0).sum(), min=1.0)
    return torch.sqrt((r * r).sum() / cnt)


def probe_plain(u, mask, wts, metric: str, n: int, c: int, tol: float, stop, done,
                probes) -> None:
    """One probe after a chunk of ``n`` iterations, in torch ops: while the
    0-d int32 flag ``stop`` is clear, ``done`` (iterations run, probes run)
    gains (n, 1); ``probes[c]`` takes the residual; ``stop`` is set where
    the residual is below ``tol`` or NaN."""
    res = residual_plain(u, mask, wts, metric)
    live = 1 - stop
    done[0].add_(live, alpha=n)
    done[1].add_(live)
    probes[c] = res
    stop.bitwise_or_(res.ge(tol).logical_not())  # NaN stops, as in the reference


def probe_blocks(h: int, w: int) -> int:
    """The kernel's grid for an (h, w) level: a block per 256 pixels, at
    most ``PROBE_MAX_BLOCKS``."""
    return max(1, min(-(-h * w // PROBE_THREADS), PROBE_MAX_BLOCKS))


def probe_scratch(h: int, w: int, device):
    """The kernel's scratch for an (h, w) level: (partials, ticket), a
    (sum or max, count) slot of float64 per block and the ticket, at 0."""
    partials = torch.empty(2 * probe_blocks(h, w), dtype=torch.float64, device=device)
    return partials, torch.zeros(1, dtype=torch.int32, device=device)


def residual_probe(u, wl, wr, wu, wd, inv, mask_u8, n: int, c: int, tol: float, metric: str,
                   stop, done, probes, partials, ticket) -> None:
    """The kernel: ``probe_plain`` of the (h, w) level ``u`` in one launch,
    on the weight planes as ``EdgeWeights`` holds them and the u8 mask,
    with the scratch of ``probe_scratch``; nothing where ``stop`` is set.
    The residual equals the plain version's but for the order and
    precision of the sum of squares (float64 here, float32 in torch)."""
    _check_metric(metric)
    if u.dim() != 2:
        raise ValueError(f"u: expected (h, w), got {tuple(u.shape)}")
    h, w = u.shape
    if h * w >= 2 ** 31:
        raise ValueError(f"a {h}x{w} level is too large for the probe")
    for name, t in (("u", u), ("wl", wl), ("wr", wr), ("wu", wu), ("wd", wd), ("inv", inv)):
        _check(name, t, torch.float32, (h, w))
    _check("mask", mask_u8, torch.uint8, (h, w))
    _check("stop", stop, torch.int32, ())
    _check("done", done, torch.int32, (2,))
    if probes.dim() != 1 or not 0 <= c < probes.shape[0]:
        raise ValueError(f"probe {c} has no slot in probes of shape {tuple(probes.shape)}")
    _check("probes", probes, torch.float32, probes.shape)
    blocks = probe_blocks(h, w)
    _check("partials", partials, torch.float64, (2 * blocks,))
    _check("ticket", ticket, torch.int32, (1,))
    _same_device("residual_probe", u=u, wl=wl, wr=wr, wu=wu, wd=wd, inv=inv, mask=mask_u8,
                 stop=stop, done=done, probes=probes, partials=partials, ticket=ticket)
    lib = build.load_library()
    # The launch goes to the current device: make it the tensors' one.
    with torch.cuda.device(u.device):
        err = lib.residual_probe(
            u.data_ptr(), wl.data_ptr(), wr.data_ptr(), wu.data_ptr(), wd.data_ptr(),
            inv.data_ptr(), mask_u8.data_ptr(), h, w, n, c, tol, metric == "max",
            stop.data_ptr(), done.data_ptr(), probes.data_ptr(), partials.data_ptr(),
            ticket.data_ptr(), blocks, _stream(u),
        )
    build.check("residual_probe", err)
    residual_probe.launches += 1


residual_probe.launches = 0


def level_probe_plain(mask: torch.Tensor, wts, metric: str, tol: float):
    """A level's probe in torch ops: ``(probe, "plain")`` with
    ``probe(u, c, n, stop, done, probes)`` as ``probe_plain``."""
    _check_metric(metric)
    mask = mask.to(torch.bool)

    def probe(u, c, n, stop, done, probes):
        probe_plain(u, mask, wts, metric, n, c, tol, stop, done, probes)

    return probe, "plain"


def level_probe_cuda(mask: torch.Tensor, wts, metric: str, tol: float):
    """``level_probe_plain`` on the kernel: ``(probe, "kernel")``, one
    launch a probe. The planes' contiguous copies, the u8 mask and the
    scratch are made here, once per level."""
    _check_metric(metric)
    planes = tuple(t.contiguous() for t in (wts.wl, wts.wr, wts.wu, wts.wd, wts.inv_count))
    m8 = mask.to(torch.uint8).contiguous()
    scratch = probe_scratch(*mask.shape, mask.device)

    def probe(u, c, n, stop, done, probes):
        residual_probe(u, *planes, m8, n, c, tol, metric, stop, done, probes, *scratch)

    return probe, "kernel"
