"""The level solve with weights derived in the kernel: K6 (``csrc/fused_sweep.cu``) and its plain version.

Counterpart of ``_strip_mega_kernel_uarena``
(``realtimedepthdiffusion_tpu/ops/pallas_sweep.py:394``) and of the
``uarena`` branches of ``solve_level_strips`` and
``solve_level_strips_early_exit``:

- ``jc_sweep_fused`` (K6) runs up to k Jacobi-Chebyshev sweeps over the
  whole level, as K1 does and in K1's CTA shapes (``ops/sweep.py:
  tile_config``), but takes u8 gray, mask and d8 planes and the 256-entry
  table of ``weight_exp_table`` in place of K1's f32 weight planes: each
  thread derives the weights of its own pixels into registers, once per
  launch.
- ``derive_weights_plain`` is that derivation in torch; with
  ``ops/sweep.py:chunks_plain`` it makes ``fused_chunks_plain`` and
  ``solve_level_fused_plain``, which the CPU runs and K6 is held to on the
  card, bit for bit.
- ``fused_chunks_cuda`` / ``solve_level_fused_cuda`` run a level on K6,
  whole or in chunks that carry (u, prev) for the residual early exit.

``ops/dispatch.py`` sends a level here where ``ops/sweep.py:strip_route``
says K6. ``jc_sweep_fused.launches`` counts K6's launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import DiffusionConfig
from ..core.weights import _TINY, EdgeWeights, depth_threshold, level_d8, weights_from_base
from . import build
from .sweep import (MAX_TILE_SWEEPS, _check, _check_table, _first, _same_device, _stream,
                    check_stop, chunks_plain, device_table, ping_pong, tile_config)

# Sweeps per K6 launch: the ring of halo each tile carries and over which
# one derivation of the tile's weights is spent. k = 8 beat 12 and 16 at 4K
# L0 in every run on an NVIDIA H100 80GB HBM3 at its 700 W limit (1.29
# against 1.51-1.53 and 1.88-1.89 ms of device time): the deeper ring's
# halo costs more than the derivations it saves.
FUSED_SWEEPS = 8
# K6's shared memory per pixel of the extended tile and its one-pixel ring:
# the two f32 buffers of u. The weights live in registers.
FUSED_BYTES_PER_PX = 8


def fused_smem_bytes(k: int) -> int:
    """K6's shared memory at ring k, in K1's CTA shape for that ring."""
    bx, by, rows = tile_config(k)
    return (by * rows + 2) * (bx + 2) * FUSED_BYTES_PER_PX


def weight_exp_table(cfg: DiffusionConfig, device) -> torch.Tensor:
    """exp(-beta * g) for g = 0..255 as float32, 0 below f32 tiny: the base
    weight of every gray difference, computed as ``edge_weights`` computes
    it, so a lookup gives its bits."""
    nbeta = -float(np.float32(cfg.beta))
    e = torch.exp(nbeta * torch.arange(256, dtype=torch.float32, device=device))
    return torch.where(e >= _TINY, e, torch.zeros((), dtype=torch.float32, device=device))


def derive_weights_plain(gray: torch.Tensor, d8: torch.Tensor, level: int, max_level: int,
                         cfg: DiffusionConfig = DiffusionConfig()) -> EdgeWeights:
    """The weights K6 derives, from u8 ``gray`` and ``d8`` (``level_d8`` of
    the level-entry depth): ``edge_weights`` with exp looked up in
    ``weight_exp_table``."""
    etab = weight_exp_table(cfg, gray.device)
    g = gray.to(torch.int64)
    return weights_from_base(etab[(g[:, 1:] - g[:, :-1]).abs()],
                             etab[(g[1:, :] - g[:-1, :]).abs()], d8, level, max_level, cfg)


def fused_chunks_plain(depth: torch.Tensor, mask: torch.Tensor, gray: torch.Tensor,
                       abc: np.ndarray, level: int, max_level: int,
                       cfg: DiffusionConfig = DiffusionConfig()):
    """``chunks_plain`` of a level whose weights are derived as K6 derives
    them, from ``gray`` and the d8 of the incoming ``depth``."""
    wts = derive_weights_plain(gray, level_d8(depth), level, max_level, cfg)
    return chunks_plain(depth, mask, wts, abc)


def solve_level_fused_plain(depth, mask, gray, abc: np.ndarray, level: int, max_level: int,
                            cfg: DiffusionConfig = DiffusionConfig()) -> torch.Tensor:
    """All sweeps of the (iters, 3) schedule ``abc`` on one level, plain torch."""
    state, run, u_of = fused_chunks_plain(depth, mask, gray, abc, level, max_level, cfg)
    return u_of(run(state, 0, abc.shape[0]))


def jc_sweep_fused(u_in, p_in, u_out, p_out, gray, mask_u8, d8, abc_dev, etab,
                   base: int, n_active: int, thr: int, use_depth_rule: bool,
                   k: int = FUSED_SWEEPS, stop=None) -> None:
    """K6: sweeps base .. base+n_active-1 of the (iters, 3) device table
    ``abc_dev``, reading (u_in, p_in) and writing (u_out, p_out), with the
    weights derived from ``gray``, ``d8`` and the table ``etab``. Where the
    device flag ``stop`` (``ops/sweep.py:check_stop``) is set, the launch
    copies (u_in, p_in) to (u_out, p_out) instead."""
    h, w = u_in.shape
    for name, t in (("u_in", u_in), ("p_in", p_in), ("u_out", u_out), ("p_out", p_out)):
        _check(name, t, torch.float32, (h, w))
    for name, t in (("gray", gray), ("mask", mask_u8), ("d8", d8)):
        _check(name, t, torch.uint8, (h, w))
    _check_table("abc", abc_dev, 3)
    _check("etab", etab, torch.float32, (256,))
    _same_device("jc_sweep_fused", u_in=u_in, p_in=p_in, u_out=u_out, p_out=p_out, gray=gray,
                 mask=mask_u8, d8=d8, abc=abc_dev, etab=etab)
    if not 1 <= k <= MAX_TILE_SWEEPS:
        raise ValueError(f"k={k}: K6's tiles carry a ring of 1..{MAX_TILE_SWEEPS}")
    if not 1 <= n_active <= k or base < 0 or base + n_active > abc_dev.shape[0]:
        raise ValueError(
            f"sweeps {base}..{base + n_active - 1} with k={k} do not fit a "
            f"table of {abc_dev.shape[0]}"
        )
    bx, by, rows = tile_config(k)
    stop_ptr = check_stop("jc_sweep_fused", stop, u_in.device)
    lib = build.load_library()
    # The launch goes to the current device: make it the tensors' one.
    with torch.cuda.device(u_in.device):
        err = lib.jc_sweep_fused(
            u_in.data_ptr(), p_in.data_ptr(), u_out.data_ptr(), p_out.data_ptr(),
            gray.data_ptr(), mask_u8.data_ptr(), d8.data_ptr(), abc_dev.data_ptr(),
            etab.data_ptr(), h, w, base, n_active, k, thr, int(use_depth_rule), bx, by, rows,
            stop_ptr, _stream(u_in),
        )
    build.check("jc_sweep_fused", err)
    jc_sweep_fused.launches += 1


jc_sweep_fused.launches = 0


def fused_chunks_cuda(depth: torch.Tensor, mask: torch.Tensor, gray: torch.Tensor,
                      abc: np.ndarray, level: int, max_level: int,
                      cfg: DiffusionConfig = DiffusionConfig(), k: int = FUSED_SWEEPS):
    """``fused_chunks_plain`` on the card: each chunk is ceil(n/k) launches
    of K6, each handed the flag ``stop``. d8 is taken once, from the
    level-entry depth."""
    u = depth.to(torch.float32).contiguous().clone()
    abc_dev = device_table(abc, u.device)
    thr = depth_threshold(level, max_level, cfg)
    planes = (gray.contiguous(), mask.to(torch.uint8).contiguous(),
              level_d8(depth).contiguous(), abc_dev, weight_exp_table(cfg, u.device))

    def launch(u_in, p_in, u_out, p_out, b, n_active, stop):
        jc_sweep_fused(u_in, p_in, u_out, p_out, *planes, b, n_active, thr or 0,
                       thr is not None, k, stop)

    def run(state, base, n, stop=None):
        return ping_pong(*state, launch, base, n, k, stop)

    return (u, torch.zeros_like(u)), run, _first


def solve_level_fused_cuda(depth, mask, gray, abc: np.ndarray, level: int, max_level: int,
                           cfg: DiffusionConfig = DiffusionConfig(),
                           k: int = FUSED_SWEEPS) -> torch.Tensor:
    """All sweeps of one level on K6, from a zero Chebyshev history."""
    state, run, u_of = fused_chunks_cuda(depth, mask, gray, abc, level, max_level, cfg, k)
    return u_of(run(state, 0, abc.shape[0]))
