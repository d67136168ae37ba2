#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits non-zero:

1. Requires a CUDA device and prints the card's name and power limit.
2. Builds the port's CUDA kernels from ``realtimedepthdiffusion_tpu_torch/csrc``.
3. Prints the largest K2 cluster the card runs, then holds each kernel
   against its plain torch version on the card, at the shapes the 1080p
   main paths give it, with inputs from a numpy seed: K1 on L0 and L1 (and
   timed there under four CTA shapes) and at k=1 against its default k; K2
   on 1080p L4, L3 and L2 and 4K L3, each timed beside K1 on the same
   level; K3 exact and approx on the route the aperture takes (tiles, each
   with its table in shared memory) and on the other one (a table of the
   whole image), and at an aperture past the tile route's limit, beside the
   two ``torch.cumsum`` calls that give the table alone; K4 on L0 and L1
   (and timed there under its CTA shapes at k = 2, 4 and 8) and K5 on L4
   with the red-black omegas, whole and in split runs from a base, beside
   K4 on the same level.
   Every comparison must be exact (max abs difference 0).
4. Drives the default path: ``DepthPipeline(1080, 1920, device="cuda")`` and
   three ``solve_and_effect(EFFECT_DEFOCUS, ...)`` updates with a scribble
   added before the second. Checks finite depth, exact scribbles, the
   output's shape and type, that the frames launched exactly what the
   routes give (K2 once per level a cluster holds, ceil(iters/8) K1 per
   other level: 3 and 24 a frame; K3 once), that a frame equals the same frame computed by the plain
   versions on the card, and that a small solve on the card agrees with the
   CPU's.
5. Drives the ``--profile fast`` path (red-black SOR with the rms early
   exit, resolved by the port's ``flags.py``) the same way: three frames
   through K4, K5 and K3, the iterations and residual probes of every
   level, from which the frames' K4 and K5 launches are asserted (one per
   k iterations of each chunk between two probes), a kernel frame against
   the plain frame, and a small solve against
   the CPU's. Then one ``solver="jacobi"`` frame and one Jacobi-Chebyshev
   early-exit frame, each exact against the plain frame.
6. Drives the 4K path at 2160x3840: K6 against its plain version (and K1)
   at L0 and at the L1 shape, at k = 1, 8, 12 and 16, with K6, K1 and plain
   times; three ``solve_and_effect(EFFECT_DEFOCUS, ...)`` frames that must
   launch exactly K2 x3, K1 x24, K6 x4 and K3 each, with ``auto`` resolved to
   approx; a kernel frame and a Jacobi-Chebyshev early-exit frame against
   the plain frames; K3 at 2160x3840 approx on both routes, by max_half
   on every route that holds it, and on all-blurred input; K3 at DCI 4K
   (2160x4096), where a whole image's summed-area table passes 2^31 - 1,
   on both routes; and the TPU-only variants the
   port maps onto K1 and K3 (state prefetch, stacked and coldiff defocus),
   each equal to the default output.
7. Drives the multi-device step (``parallel/``) on a slot mesh whose slots
   all live on the card: K1 on a halo block and on a stack of 16, K4 with
   parity 0 and 1 and on a stack of 4 blocks of mixed parities, and K3 on
   blocks with an origin, at the 1080p blocks'
   shapes, each exact against its plain version with both times; three
   ``batched_step(make_mesh(8), 1080, 1920, ..., EFFECT_DEFOCUS)`` steps on
   a batch of 4 (mesh (2, 2, 2)), which must launch exactly 244 K1 (one per
   exchange over the card's 16 blocks) and 16 K3-block per step and give the
   single-device depth and defocus per image bit for bit; one sharded
   ``--profile fast`` step on mesh (1, 2, 2), which must launch K4 once per
   exchange and card, within RMSE 1e-3 of the single-device fast solve; a 270x480 step equal to the same step on the
   plain versions; and ``dryrun_multichip(8)``. The last 1080p step runs
   once more under ``torch.profiler``: its device time by kernel, over the
   same step's unprofiled time, is the step's device busy share; so do the
   timed default, fast and 4K frames of phases 4-6.

8. Takes the device time alone of K1, K3, K4, K5 and K6 at the shapes
   above and of phase 9's windows: the launches of a level or an effect are
   captured once into a CUDA graph and replayed, so that the host paces
   nothing between them. It runs last, after phases 9, 10 and 11.
9. Drives the paths that run the kernels at other shapes or beside plain
   torch ops. The windows of the incremental re-solve: K1 on a 384x384
   level-0 window and K2 on a 192x192 level-1 window (K4 on both under
   red-black, which one CTA of K5 cannot hold), each with the frozen ring in
   its mask and the weights of its own crop, cut from the 1080p scene at an
   inside origin and at clamped corner origins, exact against plain. The
   incremental path: ``DepthPipeline(1080, 1920,
   DiffusionConfig(incremental_iterations=120))`` on a photograph-like
   image under a dense annotation, full frames until the depth stands
   still, then three ``solve_incremental_and_effect`` frames, each after a scribble
   uploaded with ``update_annotation_window``: at an inside centre, at
   (5, 5) and at the far corner, where the window clamps. Each must launch
   exactly K2 x4, K1 x15, K3 x1, pin its scribbles, move level 0 outside
   its window by the injected coarse correction alone, equal the same frame
   on the plain versions bit for bit, and lie within RMSE 3e-2 of a full
   re-solve; one frame at the default config must launch K2 x4, K1 x125,
   K3 x1. The V-cycle path: two ``DiffusionConfig(multigrid="vcycle")``
   frames, whose warm cascade must launch what a default frame launches,
   with depth in [0, 255] and a fine residual no larger than 1.05 x the
   cascade's under the cascade's weights; the polish's time, device time
   and count of device launches; a 270x480 V-cycle against the CPU's and a
   sharded V-cycle step against the single-device one (RMSE <= 1e-3). A
   96x128 solve against the NumPy oracle run on the host (RMSE <= 1e-3),
   the model facade at 540x960, and a 16-bit gray and an RGB PNG through
   the port's own codec.
10. Drives the live editing path (``live/``), after phase 9 and before
   phase 8. The native host runtime is built by g++ and must be native
   (not its Python fallback); its planner, brush and codec equal the
   fallback's, and ``core.annotation.paint`` on the card equals its brush.
   The CLI runs headless at 1080x1920 on PNG files (``--solve --effect b
   --depth16 --time --device cuda``): its DepthMap, DepthMap16 and
   ArtisticEffect equal ``DepthPipeline.solve_and_effect`` on the same
   inputs. Then ``DepthSession`` on a photograph-like image under a dense
   annotation, at ``incremental_iterations=120``, at the default config and
   under ``--profile fast``: a first solve with the defocus, a drag inside
   one rect, two distant rects, more rects than ``incremental_max_rects``,
   an annotation load and an idle solve. Each update must launch what the
   routes give (K2 x3, K1 x24, K3 x1 first; K2 x4, K1 x15, K3 x1 for one
   rect; twice that for two; under the fast profile K4 and K5 by the exit
   log), upload what its path needs, and equal the same update on the plain
   versions on the card bit for bit. Timed updates of each kind (strokes,
   then ``solve()`` returning the u8 map: CUDA events and the host's clock,
   the upload/solve split of the session's ``StageTimer``), ``save()``, a
   checkpoint with two rects pending resumed into a new session (its next
   solve equal to the original's), and ``run_gui --live`` for a few ticks
   through a scripted stand-in for cv2 (the drag drained and painted
   before its tick's solve). One JSON line of the phase's numbers.
11. Drives the directory server (``serve.py``), after phase 10 and before
   phase 8, on eight seeded 1080x1920 pairs (``photo_like`` under
   ``dense_scribbles``) written as PNGs by the port's ``io``:
   ``solve_pairs`` as ``--effect b --depth16 --png-level 1`` runs it,
   asynchronous and strictly sequential (exactly a default frame's launches
   per pair; every PNG equal to ``DepthPipeline.solve_and_effect`` on the
   same inputs), ``--profile fast`` on two pairs (launches by the exit
   log), ``solve_pairs_multichip`` with a batch of 4 on phase 7's 8-slot
   mesh (six pairs: the second step padded; two steps' launches; every PNG
   equal to the single-device frame), ``main(["--watch", ...])`` on a
   thread over three pairs and a broken JPEG sharing a solved pair's stem,
   one annotation touched mid-run (``--idle-exit``, ``--report``, the
   shared stem's outputs kept), ``warmup.main`` at 1080p and 4K with the
   defocus and the incremental path, and each example once on the card.
   One ``{"serve": ...}`` JSON line: images/s, solve seconds, the
   multichip batches' ms and the warmup's seconds per path.

Each phase prints its seconds. The line before the last is a JSON object
of the kernels, each with its launches on its main path, its largest
difference from its plain version, its time, its plain version's time,
its bound (the least time the card could take for the same work, from
the bytes it must move and the operations it must do, at the card's
published peaks) and the time of a PyTorch call computing the same
function (null: none exists). The last line is ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np

H, W = 1080, 1920
H4, W4 = 2160, 3840  # 4K UHD
SEED = 0
# What argparse gives every CLI surface for ``--profile fast``.
FAST_ARGS = argparse.Namespace(backend="auto", solver=None, tolerance=None,
                               residual_metric=None, rb_rho=None, rb_plain=False,
                               defocus_quality=None, defocus_stride=None, profile="fast")
TPU_SWEEP = "realtimedepthdiffusion_tpu/ops/pallas_sweep.py"
TPU_DEFOCUS = "realtimedepthdiffusion_tpu/ops/pallas_defocus.py"
# One H100 SXM's published peaks at 700 W: device memory 3.35 TB/s; the
# SMs issue 132 x 128 lanes x 1.98 GHz = 33.5 T instructions/s, which the
# FP32 pipes can take in full (the 67 TFLOP/s of the data sheet counts an
# FMA as two, and the kernels use none, to keep the plain version's
# roundings); the INT32 pipes take half of that.
PEAK_BYTES_S = 3.35e12
FP32_OPS_S = 33.5e12
INT32_OPS_S = 16.75e12
# Operations per pixel and sweep or iteration, counted from the sources:
# jc_point 8 multiplies, 5 adds, 2 min/max, 1 select (csrc/jc_sweep.cuh);
# rb_point 6 multiplies, 5 adds or subtracts, 4 min/max (csrc/rb_sweep.cuh)
# and the mask's select (csrc/rb_sweep.cu); K6 derives each pixel's weights
# once per level for 20 more (csrc/fused_sweep.cu: the pairs toward the
# right and the lower neighbour, each 2 subtracts, 2 abs, a compare, a
# lookup and a select, then 3 adds, a compare, a divide and a select).
JC_OPS, RB_OPS, K6_DERIVE_OPS = 16, 16, 20
# K3's (floating-point, integer) operations, counted from csrc/defocus.cu:
# per pixel, the half-width (a max, a multiply, a divide and a convert; a
# halving and a min), which defocus_block is handed instead; per pixel of
# the image the SAT is taken over, a row and a column add per channel; per
# output pixel, the window (4 adds, 4 clips), the count (4 adds, 4 clips, 2
# subtracts, a multiply, a convert), and per channel 3 adds, 2 converts and
# a divide. The bound counts the table once per pixel of the image, as the
# function needs it; that the tile route scans a tile's neighbourhood again
# in every tile is its design's cost. So counted, K3 is bound by bytes.
K3_HALF, K3_SAT, K3_GATHER = (4, 2), (0, 6), (10, 28)


def seeded_image(rng, h, w):
    """Smooth regions with edges between them, plus fine noise."""
    coarse = rng.integers(0, 256, (h // 24 + 1, w // 24 + 1, 3)).astype(np.int32)
    img = np.kron(coarse, np.ones((24, 24, 1), np.int32))[:h, :w]
    img = img + rng.integers(-8, 9, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def photo_like(rng, h, w):
    """Smooth shading, a few soft-edged discs and fine noise: neighbouring
    pixels differ by a few gray levels but at the discs' edges, as in a
    photograph. A cascade settles on it within two or three solves; on the
    noisy blocks of ``seeded_image``, whose every cell is all but insulated
    from the next, it keeps moving for dozens."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.full((h, w, 3), 128.0, np.float32)
    for c in range(3):
        for _ in range(4):
            fx, fy, ph = rng.uniform(0.5, 3.0), rng.uniform(0.5, 3.0), rng.uniform(0.0, 6.28)
            img[..., c] += 25.0 * np.sin(6.2832 * (fx * xx / w + fy * yy / h) + ph)
    for _ in range(8):
        cy, cx, rad = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(80, 300)
        off = rng.uniform(-70, 70, 3).astype(np.float32)
        inside = 1.0 / (1.0 + np.exp(np.clip((np.hypot(yy - cy, xx - cx) - rad) / 2.0, -60, 60)))
        img += inside[..., None] * off
    img += rng.integers(-4, 5, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def bench_scribbles(h, w, scale=1):
    """The scribble layout of bench.py: five 40x60 blocks at depths 0..254,
    coordinates and sizes times ``scale``."""
    mask = np.zeros((h, w), bool)
    value = np.zeros((h, w), np.uint8)
    for i, d in enumerate((0, 64, 128, 192, 254)):
        y, x = scale * (120 + 180 * i), scale * (200 + 320 * i)
        mask[y : y + 40 * scale, x : x + 60 * scale] = True
        value[y : y + 40 * scale, x : x + 60 * scale] = d
    return mask, value


def dense_scribbles(h, w):
    """A dense annotation, as a user leaves it after many strokes: a 4 x 6
    grid of 30x40 blocks whose depths cycle through 0..254."""
    mask = np.zeros((h, w), bool)
    value = np.zeros((h, w), np.uint8)
    depths = (0, 64, 128, 192, 254)
    for gy in range(4):
        for gx in range(6):
            y, x = h // 11 + gy * (h // 4), w // 16 + gx * (w // 6)
            mask[y:y + 30, x:x + 40] = True
            value[y:y + 30, x:x + 40] = depths[(gy + 2 * gx) % 5]
    return mask, value


def add_scribble(mask, value, scale=1):
    """The scribble added before the second frame."""
    mask[900 * scale : 940 * scale, 1500 * scale : 1560 * scale] = True
    value[900 * scale : 940 * scale, 1500 * scale : 1560 * scale] = 96


def time_ms(torch, fn, reps):
    """Median ms of ``fn`` over ``reps`` runs, by CUDA events, after a warm-up."""
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def graph_ms(torch, fn, reps):
    """Median ms of the device work of ``fn`` alone: its launches are
    captured once into a CUDA graph and the graph replayed, so the host
    paces nothing between them. ``fn`` may allocate but must copy nothing
    from the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(torch, graph.replay, reps)


def bound(n_bytes, n_ops, n_int=0):
    """(ms, resource): the least time of a kernel that must move
    ``n_bytes`` (each input read once, each output written once) and issue
    ``n_ops`` operations, ``n_int`` of them on the INT32 pipes."""
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = max(n_ops / FP32_OPS_S, n_int / INT32_OPS_S) * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k3_ops(px_sat, px_out, with_half):
    """(all, integer) operations of K3 over a SAT of ``px_sat`` pixels with
    ``px_out`` outputs, and their half-widths if ``with_half``."""
    parts = [(K3_SAT, px_sat), (K3_GATHER, px_out)] + [(K3_HALF, px_out)] * with_half
    return sum((f + i) * n for (f, i), n in parts), sum(i * n for (_, i), n in parts)


def traced(name, fn, unprofiled_ms):
    """``fn`` run once more under ``torch.profiler``: prints and returns its
    device ms (by kernel too, templates merged under their bare names), the
    count of its launches on the device, and its device time over
    ``unprofiled_ms``, the same work's time without the profiler, as its
    busy share. Kernels run on one stream, so they never overlap."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel = collections.Counter()
    n_device = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n_device += 1
            bare = re.split(r"[<(]", e.name.replace("(anonymous namespace)::", ""))[0]
            by_kernel[bare.split("::")[-1].removeprefix("void ").strip()] += e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_kernel.values())
    if device_ms <= 0:
        raise AssertionError(f"the profiler saw no device time in the traced {name}")
    print(f"{name} traced again: {device_ms:.3f} ms of device time in {n_device} device "
          f"launches over {unprofiled_ms:.3f} ms unprofiled, busy share "
          f"{device_ms / unprofiled_ms:.4f}; device ms by kernel "
          f"{json.dumps({k: round(v, 3) for k, v in by_kernel.most_common(8)})}")
    return {"device_ms": device_ms, "device_launches": n_device,
            "busy": device_ms / unprofiled_ms}


def max_abs(torch, a, b):
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max().item())


def require_equal(torch, name, got, want):
    err = max_abs(torch, got, want)
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs diff {err})")
    return err


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this needs a GPU")

    from realtimedepthdiffusion_tpu_torch import DepthPipeline, DiffusionConfig, flags, ops
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.core.annotation import seed_depth
    from realtimedepthdiffusion_tpu_torch.core.color import rgb_to_gray
    from realtimedepthdiffusion_tpu_torch.core.multigrid import (
        build_annotation_pyramids, build_gray_pyramid)
    from realtimedepthdiffusion_tpu_torch.core.pyramid import pyr_up
    from realtimedepthdiffusion_tpu_torch.core import solver
    from realtimedepthdiffusion_tpu_torch.core.solver import abc_schedule, rb_omegas
    from realtimedepthdiffusion_tpu_torch.core.weights import edge_weights
    from realtimedepthdiffusion_tpu_torch.ops import (build, defocus, dispatch, fused_sweep,
                                                      rb_sweep, sweep)

    mark = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - mark[0]:.2f} s")
        mark[0] = now

    # Work whose device time alone is taken at the very end (phase 8), by
    # graph replay: a process that has captured graphs ran the later frames
    # slower, so no capture comes before the frames and steps are timed.
    device_only = {}

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    phase_done("1 (the card)")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds} s) "
          f"-> {build.library_path().name}")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())
    phase_done("2 (build)")

    # -- 3. kernels against their plain versions --------------------------------
    cfg = DiffusionConfig()
    rng = np.random.default_rng(SEED)
    rgb_np = seeded_image(rng, H, W)
    gray_pyr = build_gray_pyramid(rgb_to_gray(torch.from_numpy(rgb_np).to(dev)), cfg)
    n_levels = len(gray_pyr)
    L = n_levels - 1

    def level_case(gp, level):
        h, w = gp[level].shape
        field = rng.random((h // 8 + 2, w // 8 + 2)) * 255.0
        depth = np.kron(field, np.ones((8, 8)))[:h, :w].astype(np.float32)
        mask = rng.random((h, w)) < 0.02
        value = rng.integers(0, 255, (h, w)).astype(np.uint8)
        depth_t = seed_depth(torch.from_numpy(depth).to(dev), torch.from_numpy(mask).to(dev),
                             torch.from_numpy(value).to(dev))
        mask_t = torch.from_numpy(mask).to(dev)
        wts = edge_weights(gp[level], depth_t, level, len(gp) - 1, cfg)
        abc = abc_schedule(cfg.level_iterations(len(gp), level), cfg)
        return depth_t, mask_t, wts, abc

    def check_level(name, level, kernel_name, timed=False, gp=gray_pyr):
        depth_t, mask_t, wts, abc = level_case(gp, level)
        before = ops.launch_counts()[kernel_name]
        got = sweep.solve_level_cuda(depth_t, mask_t, wts, abc)
        if ops.launch_counts()[kernel_name] == before:
            raise AssertionError(f"{name}: {kernel_name} did not launch")
        want = sweep.solve_level_plain(depth_t, mask_t, wts, abc)
        torch.cuda.synchronize()
        err = require_equal(torch, name, got, want)
        if not torch.equal(got[mask_t], depth_t[mask_t]):
            raise AssertionError(f"{name}: scribble pixels moved")
        line = {"shape": list(depth_t.shape), "sweeps": len(abc), "max_abs_err": err}
        if timed:
            line["ms"] = time_ms(torch, lambda: sweep.solve_level_cuda(depth_t, mask_t, wts, abc), 10)
            if kernel_name == "jc_sweep_tiles":  # K2 is one launch: nothing to pace
                state, run, _ = sweep.chunks_cuda(depth_t, mask_t, wts, abc)
                device_only[name] = lambda: run(state, 0, len(abc))
            line["plain_ms"] = time_ms(torch, lambda: sweep.solve_level_plain(depth_t, mask_t, wts, abc), 3)
        print(f"{name}: {json.dumps(line)}")
        line["case"] = (depth_t, mask_t, wts, abc)
        return line

    max_cluster = sweep.resident_max_cluster(dev)
    print(f"K2 cluster: the card runs clusters of up to {max_cluster} CTAs of K2's largest band "
          f"({sweep.RESIDENT_ROWS}x{sweep.RESIDENT_MAX_W}; cudaOccupancyMaxActiveClusters)")
    k1_l0 = check_level("K1 L0", 0, "jc_sweep_tiles", timed=True)
    k1_l1 = check_level("K1 L1", 1, "jc_sweep_tiles", timed=True)

    def k1_tile_ms(level, tile):
        """K1 over a level's sweeps with the CTA shape ``tile``, checked
        against the default shape; its median ms."""
        depth_t, mask_t, wts, abc = level_case(gray_pyr, level)
        planes = (wts.wr.contiguous(), wts.wd.contiguous(), wts.inv_count.contiguous(),
                  mask_t.to(torch.uint8))
        abc_d = torch.from_numpy(abc).to(dev)
        k = sweep.TILE_SWEEPS

        def run():
            def launch(u_in, p_in, u_out, p_out, b, n_active):
                sweep.jc_sweep_tiles(u_in, p_in, u_out, p_out, *planes, abc_d, b, n_active, k,
                                     tile)
            return sweep.ping_pong(depth_t.clone(), torch.zeros_like(depth_t), launch, 0,
                                   len(abc), k)[0]

        require_equal(torch, f"K1 L{level} tile {tile}", run(),
                      sweep.solve_level_cuda(depth_t, mask_t, wts, abc))
        return time_ms(torch, run, 10)

    # The CTA shape (threads across, down, rows per thread) of K1 at k = 8.
    k1_tiles = {str(t): {f"L{lv}_ms": k1_tile_ms(lv, t) for lv in (0, 1)}
                for t in (sweep.TILE_SHALLOW, (64, 8, 8), (128, 4, 8), (128, 8, 6), (64, 16, 6))}
    print(f"K1 by CTA shape at k={sweep.TILE_SWEEPS}: {json.dumps(k1_tiles)}")
    # Jacobi gives the same result whatever the blocking: k=1 against the
    # default k checks the halo logic.
    depth_t, mask_t, wts, abc = level_case(gray_pyr, 1)
    one = sweep.solve_level_cuda(depth_t, mask_t, wts, abc, k=1)
    dflt = sweep.solve_level_cuda(depth_t, mask_t, wts, abc)
    torch.cuda.synchronize()
    k1_k = require_equal(torch, "K1 k=1 vs default k", one, dflt)
    print(f"K1 L1 k=1 vs k={sweep.TILE_SWEEPS}: max_abs_err {k1_k}")
    # K2 on every level a cluster holds at 1080p (L4, L3, L2) and at 4K L3,
    # each beside K1 on the same level.
    rgb4_np = seeded_image(np.random.default_rng(SEED + 4), H4, W4)
    gray4 = build_gray_pyramid(rgb_to_gray(torch.from_numpy(rgb4_np).to(dev)), cfg)
    k2 = {}
    for name, gp, level in (("L4", gray_pyr, L), ("L3", gray_pyr, L - 1), ("L2", gray_pyr, L - 2),
                            ("4K L3", gray4, 3)):
        cluster = sweep.resident_cluster(*gp[level].shape, max_cluster)
        if cluster is None:
            raise AssertionError(f"K2 {name} {tuple(gp[level].shape)}: no cluster holds it")
        line = check_level(f"K2 {name} (cluster {cluster})", level, "jc_sweep_resident",
                           timed=True, gp=gp)
        depth_t, mask_t, wts, abc = line.pop("case")
        planes = (wts.wr.contiguous(), wts.wd.contiguous(), wts.inv_count.contiguous(),
                  mask_t.to(torch.uint8))
        abc_d = torch.from_numpy(abc).to(dev)
        k1_run = lambda: sweep._solve_tiles(depth_t.clone(), *planes, abc_d,  # noqa: E731
                                            sweep.TILE_SWEEPS)
        require_equal(torch, f"K1 on K2's {name}", k1_run(), sweep.solve_level_plain(
            depth_t, mask_t, wts, abc))
        px = int(gp[level].numel())
        line.update(cluster=cluster, k1_ms=time_ms(torch, k1_run, 10),
                    bound_ms=bound(px * 29, px * line["sweeps"] * JC_OPS)[0])
        # K2 on every cluster the card runs that holds the level: why the
        # route takes the largest.
        line["by_cluster_ms"] = {}
        for c in sweep.CLUSTER_SIZES:
            if c > max_cluster or -(-depth_t.shape[0] // c) > sweep.RESIDENT_ROWS:
                continue
            state = (depth_t.clone(), torch.zeros_like(depth_t))
            run_c = lambda: sweep.jc_sweep_resident(*state, *planes, abc_d, 0, len(abc), c)  # noqa: E731
            line["by_cluster_ms"][c] = time_ms(torch, run_c, 5)
        k2[name] = line
        print(f"K2 {name} {tuple(gp[level].shape)}: {line['ms']:.3f} ms on a cluster of {cluster}, "
              f"K1 {line['k1_ms']:.3f} ms; K2 by cluster size {json.dumps(line['by_cluster_ms'])}")

    # K4 and K5 at the same levels, with the fast profile's omegas (the fixed
    # count of each level, as when no probe fires).
    fast_cfg = DiffusionConfig(**flags.resolve_solver_flags(FAST_ARGS, None))

    def check_rb_level(name, level, kernel_name):
        depth_t, mask_t, wts, _ = level_case(gray_pyr, level)
        om = rb_omegas(fast_cfg.level_iterations(n_levels, level), fast_cfg)
        before = ops.launch_counts()[kernel_name]
        got = rb_sweep.solve_level_rb_cuda(depth_t, mask_t, wts, om)
        if ops.launch_counts()[kernel_name] == before:
            raise AssertionError(f"{name}: {kernel_name} did not launch")
        want = rb_sweep.solve_level_rb_plain(depth_t, mask_t, wts, om)
        torch.cuda.synchronize()
        err = require_equal(torch, name, got, want)
        if not torch.equal(got[mask_t], depth_t[mask_t]):
            raise AssertionError(f"{name}: scribble pixels moved")
        u0, run, _ = rb_sweep.chunks_cuda(depth_t, mask_t, wts, om)
        line = {"shape": list(depth_t.shape), "iterations": len(om), "max_abs_err": err,
                "ms": time_ms(torch, lambda: rb_sweep.solve_level_rb_cuda(
                    depth_t, mask_t, wts, om), 10),
                "plain_ms": time_ms(torch, lambda: rb_sweep.solve_level_rb_plain(
                    depth_t, mask_t, wts, om), 3)}
        device_only[name] = lambda: run(u0, 0, len(om))
        print(f"{name}: {json.dumps(line)}")
        line["case"] = (depth_t, mask_t, wts, om)
        return line

    k4_l0 = check_rb_level("K4 L0", 0, "rb_sweep_tiles")
    k4_l1 = check_rb_level("K4 L1", 1, "rb_sweep_tiles")
    del k4_l0["case"], k4_l1["case"]

    def k4_tile_ms(level):
        """K4 over a level's iterations under each CTA shape (threads
        across, down, rows, columns a thread) at k = 2, 4 and 8, each
        checked against the plain version; median ms by shape and k."""
        depth_t, mask_t, wts, _ = level_case(gray_pyr, level)
        om = rb_omegas(fast_cfg.level_iterations(n_levels, level), fast_cfg)
        om_d = torch.from_numpy(om).to(dev)
        planes = (wts.wr.contiguous(), wts.wd.contiguous(), wts.inv_count.contiguous(),
                  mask_t.to(torch.uint8))
        want = rb_sweep.solve_level_rb_plain(depth_t, mask_t, wts, om)
        out = {}
        for tile in ((32, 16, 4, 2), (64, 8, 8, 1), (64, 8, 8, 2), (32, 16, 8, 2), (64, 8, 4, 2)):
            for k in (2, 4, 8):
                if min(rb_sweep.rb_tile_extent(tile)) <= 4 * k:
                    continue
                run = lambda k=k, tile=tile: rb_sweep._tiles_chunk(  # noqa: E731
                    depth_t.clone(), *planes, om_d, 0, len(om), k, tile)
                require_equal(torch, f"K4 L{level} tile {tile} k={k}", run(), want)
                out[f"{tile} k={k}"] = time_ms(torch, run, 5)
                device_only[f"K4 L{level} tile {tile} k={k}"] = run
        return out

    k4_tiles = {f"L{lv}_ms": k4_tile_ms(lv) for lv in (0, 1)}
    print(f"K4 by CTA shape and k (route: {rb_sweep.rb_tile_config(rb_sweep.RB_TILE_ITERS)} at "
          f"k={rb_sweep.RB_TILE_ITERS}): {json.dumps(k4_tiles)}")
    if not rb_sweep.rb_resident_fits(*gray_pyr[L].shape):
        raise AssertionError(f"L4 {tuple(gray_pyr[L].shape)} does not fit K5")
    k5 = check_rb_level("K5 L4", L, "rb_sweep_resident")
    # K5 in the split runs from a base that the early exit makes of it, and
    # K4 on the same level beside it.
    k5_depth, mask_t, wts, om = k5.pop("case")
    k5_args = (wts.wr.contiguous(), wts.wd.contiguous(), wts.inv_count.contiguous(),
               mask_t.to(torch.uint8), torch.from_numpy(om).to(dev))
    want = rb_sweep.solve_level_rb_plain(k5_depth, mask_t, wts, om)
    every = fast_cfg.residual_check_every
    k5_u = k5_depth.clone()
    for base in range(0, len(om), every):
        rb_sweep.rb_sweep_resident(k5_u, *k5_args, base, min(every, len(om) - base))
    torch.cuda.synchronize()
    k5["cta"] = list(rb_sweep.rb_resident_config(*k5_depth.shape))
    k5["split_max_abs_err"] = require_equal(torch, f"K5 L4 in chunks of {every}", k5_u, want)
    # In place on the solved level: the same work whatever the values.
    device_only[f"K5 L4 chunk of {every}"] = lambda: rb_sweep.rb_sweep_resident(
        k5_u, *k5_args, 0, every)
    k4_on_l4 = lambda n=len(om): rb_sweep._tiles_chunk(k5_depth.clone(), *k5_args, 0, n,  # noqa: E731
                                                       rb_sweep.RB_TILE_ITERS)
    require_equal(torch, "K4 on K5's L4", k4_on_l4(), want)
    k5["k4_ms"] = time_ms(torch, k4_on_l4, 5)
    device_only["K4 on K5's L4"] = k4_on_l4
    print(f"K5 L4 {tuple(k5_depth.shape)}, {len(om)} iterations: CTA {k5['cta']} (threads "
          f"across, down, rows, columns), in chunks of {every} max_abs_err "
          f"{k5['split_max_abs_err']}; K4 on the same level {k5['k4_ms']:.3f} ms")

    ramp = np.linspace(0.0, 255.0, W, dtype=np.float32)[None, :].repeat(H, 0)
    ramp = np.clip(ramp + rng.normal(0.0, 6.0, (H, W)).astype(np.float32), 0.0, 255.0)
    depth_fx = torch.from_numpy(ramp).to(dev)
    rgb_t = torch.from_numpy(rgb_np).to(dev)
    halves = torch.unique(defocus.defocus_half_widths(depth_fx, H, W, cfg)).tolist()
    max_half = cfg.defocus_kernel_size(H, W) // 2
    if halves != list(range(max_half + 1)):
        raise AssertionError(f"K3 depth covers halves {halves}, not 0..{max_half}")
    def other_route(m):
        """The route K3 does not take at max_half ``m``, forced."""
        return defocus.defocus_route(m, "table" if defocus.defocus_route(m)[0] == "tile"
                                     else "tile")

    def check_k3(name, img, depth, c, routes, reps=20):
        """K3 on each of ``routes`` (None: the one the wrapper picks) against
        ``defocus_sat``; ms as launched by route, and the plain ms."""
        want = defocus.defocus_sat(img, depth, c)
        line = {"max_abs_err": 0.0, "ms": {}}
        for r in routes:
            run = lambda r=r: defocus.defocus_box(img, depth, c, route=r)  # noqa: E731
            got = run()
            torch.cuda.synchronize()
            line["max_abs_err"] = max(line["max_abs_err"],
                                      require_equal(torch, f"{name} route {r}", got, want))
            line["ms"][str(r)] = time_ms(torch, run, reps)
            device_only[f"{name} route {r}"] = run
        line["plain_ms"] = time_ms(torch, lambda: defocus.defocus_sat(img, depth, c), 5)
        print(f"{name}: {json.dumps(line)}")
        return line

    k3_route = defocus.defocus_route(max_half)
    if k3_route[0] != "tile":
        raise AssertionError(f"K3 at max_half {max_half} takes {k3_route}, not the tile route")
    k3 = {}
    for quality in ("exact", "approx"):
        qcfg = DiffusionConfig(pallas_defocus_quality=quality)
        k3[quality] = check_k3(f"K3 {quality} {H}x{W} max_half {max_half}", rgb_t, depth_fx, qcfg,
                               (None, other_route(max_half)))
    # The tile route keeps no table of the whole image (25 MB here) in
    # device memory: a call allocates its output and nothing of that size.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    defocus.defocus_box(rgb_t, depth_fx, cfg)
    torch.cuda.synchronize()
    k3_peak = torch.cuda.max_memory_allocated() - before
    print(f"K3 {H}x{W} on {k3_route}: peak allocation {k3_peak} bytes over its inputs "
          f"(output {H * W * 3}, a table would be {3 * (H + 1) * (W + 1) * 4})")
    if k3_peak > 2 * H * W * 3:
        raise AssertionError(f"K3's tile route allocated {k3_peak} bytes")
    # The two torch.cumsum calls that give the table alone, in int32 (which
    # holds 255*h*w at 1080p): a yardstick for the scan stage only.
    chw_t = rgb_t.permute(2, 0, 1).contiguous()
    k3_sat_library_ms = time_ms(torch, lambda: torch.cumsum(torch.cumsum(
        chw_t, dim=1, dtype=torch.int32), dim=2, dtype=torch.int32), 10)
    print(f"torch.cumsum twice over (3, {H}, {W}) u8 -> int32, the table alone: "
          f"{k3_sat_library_ms:.3f} ms")
    # An aperture past the tile route's limit takes the table route.
    wide_half = 100
    wide_cfg = DiffusionConfig(defocus_aperture=(2 * wide_half + 0.5) / float(np.hypot(H, W)),
                               pallas_defocus_quality="exact")
    if (wide_cfg.defocus_kernel_size(H, W) // 2 != wide_half
            or defocus.defocus_route(wide_half) != ("table", None)):
        raise AssertionError(f"max_half {wide_half} routes to {defocus.defocus_route(wide_half)}")
    k3_wide = check_k3(f"K3 exact {H}x{W} max_half {wide_half} (past the tile route's "
                       f"{defocus.DEFOCUS_TILE_MAX_HALF})", rgb_t, depth_fx, wide_cfg, (None,), 10)
    phase_done("3 (kernels against plain)")

    # -- 4. the main path ------------------------------------------------------
    pipe = DepthPipeline(H, W, cfg, device="cuda")
    mask_np, value_np = bench_scribbles(H, W)
    rgb_d, gpyr = pipe.prepare_image(rgb_np)
    state = pipe.initial_state()
    frames = []
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(3):
        if i == 1:
            add_scribble(mask_np, value_np)
        mask_d = torch.from_numpy(mask_np).to(dev)
        value_d = torch.from_numpy(value_np).to(dev)
        depth0, state, out = pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, mask_d,
                                                   value_d, state)
        frames.append((depth0, out, mask_d, value_d))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    print(f"main path: 3 frames in {wall:.3f} s, launches {json.dumps(launches)}")
    def frame_launches(gp, c=cfg):
        """The launches of one default frame by the routes: one K2 launch
        per level a cluster holds, ceil(iters/k) of K1 or K6 per other
        level, one K3."""
        want = collections.Counter(defocus_box=1)
        l2 = dispatch.l2_bytes(dev)
        for level, g in enumerate(gp):
            route = sweep.strip_route(*g.shape, l2, max_cluster)
            blocks = -(-c.level_iterations(len(gp), level) // sweep.TILE_SWEEPS)
            want.update({"K2": {"jc_sweep_resident": 1}, "K1": {"jc_sweep_tiles": blocks},
                         "K6": {"jc_sweep_fused": blocks}}[route])
        return want

    want_frame = frame_launches(gray_pyr)
    print(f"default frame: launches per frame {json.dumps(want_frame)}")
    if {k: v for k, v in launches.items() if v} != {k: 3 * v for k, v in want_frame.items()}:
        raise AssertionError(f"3 main-path frames launched {launches}, not 3 x {dict(want_frame)}")
    if want_frame["jc_sweep_tiles"] > 24 or want_frame["jc_sweep_resident"] != 3:
        raise AssertionError(f"a 1080p frame launches {dict(want_frame)}: not K2 x3 and K1 <= 24")
    for i, (depth0, out, mask_d, value_d) in enumerate(frames):
        if not bool(torch.isfinite(depth0).all()):
            raise AssertionError(f"frame {i}: depth is not finite")
        if not torch.equal(depth0[mask_d], value_d[mask_d].to(torch.float32)):
            raise AssertionError(f"frame {i}: scribble pixels are not pinned")
        if tuple(out.shape) != (H, W, 3) or out.dtype != torch.uint8:
            raise AssertionError(f"frame {i}: effect is {tuple(out.shape)} {out.dtype}")
        u8 = pipe.depth_u8(depth0)
        print(f"frame {i}: depth [{float(depth0.min()):.4f}, {float(depth0.max()):.4f}] "
              f"u8 mean {float(u8.float().mean()):.4f} effect mean {float(out.float().mean()):.4f}")

    # The same update by the plain versions on the card must equal the
    # kernel path's bit for bit: same glue and routes, kernels equal to
    # their twins.
    def plain_level(c, depth, mask, gray, level, max_level, iters):
        table = solver._SCHEDULES[c.solver](iters, c)
        wts = edge_weights(gray, depth, level, max_level, c)
        if dispatch.fused_level(depth, c.solver):
            st, run, u_of = fused_sweep.fused_chunks_plain(depth, mask, gray, table, level,
                                                           max_level, c)
        else:
            chunks = rb_sweep.chunks_plain if c.solver == "red_black" else sweep.chunks_plain
            st, run, u_of = chunks(depth, mask, wts, table)
        if c.early_exit:
            return u_of(solver._chunked_early_exit(st, run, u_of, mask, wts, iters, c))
        return u_of(run(st, 0, iters))

    def plain_frame(c, gp, st, scene):
        _, rgb_dev, mask, value = scene
        top = len(gp) - 1
        masks, values = build_annotation_pyramids(mask, value, c)
        st = list(st)
        st[top] = seed_depth(st[top], masks[top], values[top])
        for level in range(top, -1, -1):
            st[level] = plain_level(c, st[level], masks[level], gp[level], level, top,
                                    c.level_iterations(len(gp), level))
            if level > 0:
                up = pyr_up(st[level], tuple(gp[level - 1].shape))
                st[level - 1] = seed_depth(up, masks[level - 1], values[level - 1])
        out = defocus.defocus_sat(rgb_dev, torch.clamp(st[0], 0.0, 255.0), c)
        return st[0], tuple(st), out

    def compare_frames(name, p, st, scene, timed, exit_log=None):
        """A kernel frame of pipeline ``p`` against the plain frame, from
        the depth state ``st`` on ``scene`` (rgb as numpy and on the card,
        mask, value); with ``timed``, both times."""
        rgb_host, rgb_dev, mask, value = scene
        _, gp = p.prepare_image(rgb_host)
        ops.reset_launch_counts()
        k_depth, _, k_out = p.solve_and_effect(fx.EFFECT_DEFOCUS, gp, rgb_dev, mask, value, st,
                                               exit_log)
        counts = ops.launch_counts()
        p_depth, _, p_out = plain_frame(p.cfg, gp, st, scene)
        torch.cuda.synchronize()
        err = max(require_equal(torch, f"{name} frame depth", k_depth, p_depth),
                  require_equal(torch, f"{name} frame effect", k_out, p_out))
        line = {"max_abs_err": err, "launches": {k: v for k, v in counts.items() if v}}
        if timed:
            line["ms"] = time_ms(torch, lambda: p.solve_and_effect(
                fx.EFFECT_DEFOCUS, gp, rgb_dev, mask, value, st), 10)
            line["plain_ms"] = time_ms(torch, lambda: plain_frame(p.cfg, gp, st, scene), 3)
        print(f"{name} frame {p.rows}x{p.cols} solve+defocus, kernels against plain on the "
              f"card (CUDA events, median): {json.dumps(line)}")
        if timed:
            traced(f"{name} frame", lambda: p.solve_and_effect(
                fx.EFFECT_DEFOCUS, gp, rgb_dev, mask, value, st), line["ms"])
        return line

    frame = compare_frames("default", pipe, state, (rgb_np, rgb_d, *frames[2][2:]), timed=True)

    # A small solve on the card against the CPU's plain path, which the CPU
    # tests hold against the JAX package. exp differs between the two
    # devices in the last bits, so the bar is the repo's RMSE <= 1e-3.
    hs, ws = 181, 243
    srgb = seeded_image(rng, hs, ws)
    smask, svalue = bench_scribbles(hs * 8, ws * 8)
    smask, svalue = smask[::8, ::8].copy(), svalue[::8, ::8].copy()

    def small_solve(c, name):
        depths, iters = [], []
        for device in ("cuda", "cpu"):
            sp = DepthPipeline(hs, ws, c, device=device)
            _, sg = sp.prepare_image(srgb)
            log = []
            d, _ = sp.solve(sg, torch.from_numpy(smask).to(device),
                            torch.from_numpy(svalue).to(device), sp.initial_state(), log)
            depths.append(d.cpu().numpy())
            iters.append([e["iters"] for e in log])
        rmse = float(np.sqrt(np.mean(((depths[0] - depths[1]) / 255.0) ** 2)))
        print(f"{name} small solve {hs}x{ws}: card vs CPU depth RMSE {rmse:.3e} (bar 1e-3); "
              f"early-exit iterations by level, card {iters[0]}, CPU {iters[1]}")
        if not rmse <= 1e-3:
            raise AssertionError(f"{name} small solve: card vs CPU RMSE {rmse} > 1e-3")

    small_solve(cfg, "default")
    phase_done("4 (the default path)")

    # -- 5. the --profile fast path ----------------------------------------------
    print(f"fast profile: {json.dumps(flags.resolve_solver_flags(FAST_ARGS, None))}")
    fpipe = DepthPipeline(H, W, fast_cfg, device="cuda")
    _, fgpyr = fpipe.prepare_image(rgb_np)
    fmask, fvalue = bench_scribbles(H, W)
    fstate = fpipe.initial_state()
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fast_frames = []
    for i in range(3):
        if i == 1:
            add_scribble(fmask, fvalue)
        m_d = torch.from_numpy(fmask).to(dev)
        v_d = torch.from_numpy(fvalue).to(dev)
        log = []
        depth0, fstate, out = fpipe.solve_and_effect(fx.EFFECT_DEFOCUS, fgpyr, rgb_d, m_d,
                                                     v_d, fstate, log)
        fast_frames.append((depth0, out, m_d, v_d, log))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fast_launches = ops.launch_counts()
    print(f"fast path: 3 frames in {wall:.3f} s, launches {json.dumps(fast_launches)}")
    for name in ("rb_sweep_tiles", "rb_sweep_resident", "defocus_box"):
        if fast_launches[name] == 0:
            raise AssertionError(f"fast path never launched {name}")
    if fast_launches["jc_sweep_fused"] or fast_launches["jc_sweep_tiles"]:
        raise AssertionError("the fast path launched a Jacobi kernel")

    def exit_chunks(e, every):
        """The iterations of each chunk a level ran: full chunks of
        ``every`` between two probes, then what was left of its cap."""
        full, rest = divmod(e["iters"], every)
        return [every] * full + [rest] * (rest > 0)

    # The routes' launches: per chunk of a level, one K5 launch where the
    # level fits one CTA, else one K4 launch per k iterations; K3 once.
    want_fast = collections.Counter(defocus_box=len(fast_frames))
    for *_, log in fast_frames:
        for e in log:
            chunks = exit_chunks(e, fast_cfg.residual_check_every)
            if rb_sweep.rb_resident_fits(*e["shape"]):
                want_fast["rb_sweep_resident"] += len(chunks)
            else:
                want_fast["rb_sweep_tiles"] += sum(-(-n // rb_sweep.RB_TILE_ITERS)
                                                   for n in chunks)
    print(f"fast path: launches by the routes and the exit log {json.dumps(want_fast)}")
    if {k: v for k, v in fast_launches.items() if v} != dict(want_fast):
        raise AssertionError(f"3 fast frames launched {fast_launches}, not {dict(want_fast)}")
    for i, (depth0, out, m_d, v_d, log) in enumerate(fast_frames):
        if not bool(torch.isfinite(depth0).all()):
            raise AssertionError(f"fast frame {i}: depth is not finite")
        if float(depth0.min()) < 0.0 or float(depth0.max()) > 255.0:
            raise AssertionError(f"fast frame {i}: projected SOR left [0, 255]")
        if not torch.equal(depth0[m_d], v_d[m_d].to(torch.float32)):
            raise AssertionError(f"fast frame {i}: scribble pixels are not pinned")
        if tuple(out.shape) != (H, W, 3) or out.dtype != torch.uint8:
            raise AssertionError(f"fast frame {i}: effect is {tuple(out.shape)} {out.dtype}")
        if [e["shape"] for e in log] != [tuple(g.shape) for g in fgpyr[::-1]]:
            raise AssertionError(f"fast frame {i}: a level skipped the early exit")
        levels = [{"level": L - j, "shape": list(e["shape"]), "iterations": e["iters"],
                   "cap": fast_cfg.level_iterations(n_levels, L - j),
                   "probes": [round(p, 6) for p in e["probes"]]} for j, e in enumerate(log)]
        print(f"fast frame {i}: tol {log[0]['tol']:.6f}; {json.dumps(levels)}")
    res = fpipe.residuals(fgpyr, fast_frames[2][2], fast_frames[2][3], fstate)
    print(f"fast frame 2 residuals (max; rms) by level: {json.dumps(res.tolist())}")
    if tuple(res.shape) != (2, n_levels) or not bool(torch.isfinite(res).all()):
        raise AssertionError(f"residuals: {tuple(res.shape)}")
    u16 = fpipe.depth_u16(fast_frames[2][0])
    if u16.dtype != torch.uint16 or tuple(u16.shape) != (H, W):
        raise AssertionError(f"depth_u16: {u16.dtype} {tuple(u16.shape)}")

    fast_scene = (rgb_np, rgb_d, *fast_frames[2][2:4])
    fast_frame = compare_frames("fast", fpipe, fstate, fast_scene, timed=True)
    small_solve(fast_cfg, "fast")
    for name, c in (("jacobi", DiffusionConfig(solver="jacobi")),
                    ("jacobi_chebyshev early exit",
                     DiffusionConfig(early_exit=True, tolerance=1e-3))):
        line = compare_frames(name, DepthPipeline(H, W, c, device="cuda"), fstate, fast_scene,
                              timed=False)
        want = {"jc_sweep_tiles", "jc_sweep_resident", "defocus_box"}
        if set(line["launches"]) != want:
            raise AssertionError(f"{name} frame launched {line['launches']}, not {want}")
    phase_done("5 (the fast path)")

    # -- 6. the 4K path ------------------------------------------------------------
    top4 = len(gray4) - 1
    l2 = dispatch.l2_bytes(dev)
    routes = [sweep.strip_route(*g.shape, l2, max_cluster) for g in gray4]
    print(f"4K routes by level (L2 {l2} bytes, clusters of up to {max_cluster}): {routes}")
    if routes != ["K6", "K1", "K1", "K2", "K2", "K2"]:
        raise AssertionError(f"4K routes {routes}")

    def check_fused(name, level, ks, timed):
        """K6 at each k of ``ks`` against its plain version and against K1
        on the same level; with ``timed``, K6, K1 and plain ms."""
        depth_t, mask_t, wts, abc = level_case(gray4, level)
        g = gray4[level]
        want = fused_sweep.solve_level_fused_plain(depth_t, mask_t, g, abc, level, top4, cfg)
        k1 = sweep.solve_level_cuda(depth_t, mask_t, wts, abc)
        line = {"shape": list(depth_t.shape), "sweeps": len(abc), "max_abs_err": 0.0}
        for k in ks:
            before = fused_sweep.jc_sweep_fused.launches
            got = fused_sweep.solve_level_fused_cuda(depth_t, mask_t, g, abc, level, top4, cfg, k)
            if fused_sweep.jc_sweep_fused.launches - before != -(-len(abc) // k):
                raise AssertionError(f"{name} k={k}: K6 launched "
                                     f"{fused_sweep.jc_sweep_fused.launches - before} times")
            torch.cuda.synchronize()
            line["max_abs_err"] = max(line["max_abs_err"],
                                      require_equal(torch, f"{name} k={k}", got, want),
                                      require_equal(torch, f"{name} k={k} vs K1", got, k1))
            if timed and k > 1:
                line[f"ms_k{k}"] = time_ms(torch, lambda: fused_sweep.solve_level_fused_cuda(
                    depth_t, mask_t, g, abc, level, top4, cfg, k), 10)
                state, run, _ = fused_sweep.fused_chunks_cuda(depth_t, mask_t, g, abc, level,
                                                              top4, cfg, k)
                device_only[f"{name} k={k}"] = lambda run=run, state=state: run(state, 0, len(abc))
        if timed:
            line["k1_ms"] = time_ms(torch, lambda: sweep.solve_level_cuda(
                depth_t, mask_t, wts, abc), 10)
            k1_state, k1_run, _ = sweep.chunks_cuda(depth_t, mask_t, wts, abc)
            device_only[f"K1 on {name}"] = lambda: k1_run(k1_state, 0, len(abc))
            line["k1_with_weights_ms"] = time_ms(torch, lambda: sweep.solve_level_cuda(
                depth_t, mask_t, edge_weights(g, depth_t, level, top4, cfg), abc), 10)
            line["plain_ms"] = time_ms(torch, lambda: fused_sweep.solve_level_fused_plain(
                depth_t, mask_t, g, abc, level, top4, cfg), 3)
        print(f"{name}: {json.dumps(line)}")
        return line

    fused_ks = sorted({1, 8, 12, 16, fused_sweep.FUSED_SWEEPS})
    k6_l0 = check_fused("K6 4K L0", 0, fused_ks, timed=True)
    k6_l1 = check_fused("K6 4K L1 shape", 1, fused_ks, timed=True)
    k6_ms = k6_l0[f"ms_k{fused_sweep.FUSED_SWEEPS}"]
    print(f"4K L0 ({H4}x{W4}, 31 sweeps): K6 {k6_ms:.3f} ms, K1 {k6_l0['k1_ms']:.3f} ms "
          f"(planes given) / {k6_l0['k1_with_weights_ms']:.3f} ms (with edge_weights), "
          f"plain {k6_l0['plain_ms']:.3f} ms on {smi.stdout.strip().splitlines()[0]}")

    pipe4 = DepthPipeline(H4, W4, cfg, device="cuda")
    mask4, value4 = bench_scribbles(H4, W4, scale=2)
    rgb4_d, gpyr4 = pipe4.prepare_image(rgb4_np)
    state4 = pipe4.initial_state()
    frames4 = []
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i in range(3):
            if i == 1:
                add_scribble(mask4, value4, scale=2)
            m_d = torch.from_numpy(mask4).to(dev)
            v_d = torch.from_numpy(value4).to(dev)
            depth0, state4, out = pipe4.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr4, rgb4_d, m_d,
                                                         v_d, state4)
            frames4.append((depth0, out, m_d, v_d))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches4 = ops.launch_counts()
    print(f"4K path: 3 frames in {wall:.3f} s, launches {json.dumps(launches4)}")
    want4 = frame_launches(gray4)
    print(f"4K frame: launches per frame {json.dumps(want4)}")
    if {k: v for k, v in launches4.items() if v} != {k: 3 * v for k, v in want4.items()}:
        raise AssertionError(f"3 4K frames launched {launches4}, not 3 x {dict(want4)}")
    if dict(want4) != {"jc_sweep_resident": 3, "jc_sweep_tiles": 24, "jc_sweep_fused": 4,
                       "defocus_box": 1}:
        raise AssertionError(f"a 4K frame launches {dict(want4)}")
    max_half4 = cfg.defocus_kernel_size(H4, W4) // 2
    approx = [w for w in caught if issubclass(w.category, RuntimeWarning)
              and f"max_half {max_half4}" in str(w.message) and "approx" in str(w.message)]
    if not approx:
        raise AssertionError(f"4K defocus 'auto' did not resolve to approx with its warning: "
                             f"{[str(w.message) for w in caught]}")
    print(f"4K defocus: max_half {max_half4}, 'auto' resolved to approx: {approx[0].message}")
    for i, (depth0, out, m_d, v_d) in enumerate(frames4):
        if not bool(torch.isfinite(depth0).all()):
            raise AssertionError(f"4K frame {i}: depth is not finite")
        if not torch.equal(depth0[m_d], v_d[m_d].to(torch.float32)):
            raise AssertionError(f"4K frame {i}: scribble pixels are not pinned")
        if tuple(out.shape) != (H4, W4, 3) or out.dtype != torch.uint8:
            raise AssertionError(f"4K frame {i}: effect is {tuple(out.shape)} {out.dtype}")
        print(f"4K frame {i}: depth [{float(depth0.min()):.4f}, {float(depth0.max()):.4f}] "
              f"effect mean {float(out.float().mean()):.4f}")

    scene4 = (rgb4_np, rgb4_d, *frames4[2][2:4])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        frame4 = compare_frames("4K default", pipe4, state4, scene4, timed=True)
        log4 = []
        ee_cfg = DiffusionConfig(early_exit=True, tolerance=1e-3)
        ee4 = compare_frames("4K jacobi_chebyshev early exit",
                             DepthPipeline(H4, W4, ee_cfg, device="cuda"), state4, scene4,
                             timed=False, exit_log=log4)
    if set(ee4["launches"]) != {"jc_sweep_resident", "jc_sweep_tiles", "jc_sweep_fused",
                                "defocus_box"}:
        raise AssertionError(f"4K early-exit frame launched {ee4['launches']}")
    print(f"4K early-exit frame: tol {log4[0]['tol']:.6f}; " + json.dumps(
        [{"shape": list(e["shape"]), "iterations": e["iters"],
          "probes": [round(p, 6) for p in e["probes"]]} for e in log4]))

    def ramp_depth(h, w, noise=rng):
        """Depth rising from 0 to 255 across the image, with noise."""
        return torch.from_numpy(np.clip(
            np.linspace(0.0, 255.0, w, dtype=np.float32)[None, :].repeat(h, 0)
            + noise.normal(0.0, 6.0, (h, w)).astype(np.float32), 0.0, 255.0)).to(dev)

    # K3 at the 4K frame's aperture, approx as 'auto' resolves it, on the
    # route it takes and on the other one.
    k3_uhd_route = defocus.defocus_route(max_half4)
    if k3_uhd_route[0] != "tile":
        raise AssertionError(f"K3 at max_half {max_half4} takes {k3_uhd_route}")
    k3_uhd = check_k3(f"K3 approx {H4}x{W4} max_half {max_half4}", rgb4_d,
                      ramp_depth(H4, W4, np.random.default_rng(SEED + 6)),
                      DiffusionConfig(pallas_defocus_quality="approx"),
                      (None, other_route(max_half4)), 10)

    # What defocus_route's thresholds rest on: K3 at this size by max_half,
    # on every route that holds it (device times in phase 8), and the two
    # frames' apertures on an all-blurred input (depth 255: every tile scans
    # its whole neighbourhood).
    sweep_depth = ramp_depth(H4, W4, np.random.default_rng(SEED + 7))
    for m in (27, 52, 55, 72, 88):
        c = DiffusionConfig(defocus_aperture=(2 * m + 0.5) / float(np.hypot(H4, W4)),
                            pallas_defocus_quality="exact")
        want = defocus.defocus_sat(rgb4_d, sweep_depth, c)
        for r in (("tile", 64), ("tile", 96), ("table", None)):
            if r[0] == "tile" and defocus.defocus_tile_smem(r[1], m) > sweep.SMEM_PER_CTA:
                continue
            run = lambda c=c, r=r: defocus.defocus_box(rgb4_d, sweep_depth, c, route=r)  # noqa: E731
            require_equal(torch, f"K3 {H4}x{W4} max_half {m} route {r}", run(), want)
            device_only[f"K3 sweep max_half {m} route {r}"] = run
    for name, img, c in (("1080p exact", rgb_t, DiffusionConfig(pallas_defocus_quality="exact")),
                         ("4K approx", rgb4_d, DiffusionConfig(pallas_defocus_quality="approx"))):
        far = torch.full(img.shape[:2], 255.0, device=dev)
        run = lambda img=img, far=far, c=c: defocus.defocus_box(img, far, c)  # noqa: E731
        require_equal(torch, f"K3 {name} all-blurred", run(), defocus.defocus_sat(img, far, c))
        device_only[f"K3 all-blurred {name}"] = run
    print("K3 by max_half and route, and on all-blurred input: exact against plain")

    # K3 at DCI 4K, where 255*h*w passes 2^31 - 1: the table route's sums
    # wrap, a tile's stay below 2^24.
    hd, wd = 2160, 4096
    depth_d = ramp_depth(hd, wd)
    max_half_d = cfg.defocus_kernel_size(hd, wd) // 2
    k3_dci = 0.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        for label, img in (("seeded", seeded_image(rng, hd, wd)),
                           ("all-255", np.full((hd, wd, 3), 255, np.uint8))):
            img_d = torch.from_numpy(img).to(dev)
            want = defocus.defocus_sat(img_d, depth_d, cfg)
            for r in (None, other_route(max_half_d)):
                got = defocus.defocus_box(img_d, depth_d, cfg, route=r)
                torch.cuda.synchronize()
                k3_dci = max(k3_dci, require_equal(torch, f"K3 {hd}x{wd} {label} route {r}",
                                                   got, want))
                if label == "all-255" and not bool((got == 255).all()):
                    raise AssertionError("K3 at DCI 4K: an all-255 image did not stay 255")
            print(f"K3 {hd}x{wd} {label}, max_half {max_half_d}, on "
                  f"{defocus.defocus_route(max_half_d)} and {other_route(max_half_d)}: "
                  f"max_abs_err {k3_dci}")

    # TPU kernels that are config variants of one output: the port runs K1
    # and K3 under their config values and must give the default output.
    depth_t, mask_t, _, abc = level_case(gray_pyr, 1)
    variant = {}
    for name, c in (("default", cfg), ("pallas_state_prefetch", DiffusionConfig(
            pallas_state_prefetch=True))):
        before = sweep.jc_sweep_tiles.launches
        variant[name] = solver.solve_level(depth_t, mask_t, gray_pyr[1], 1, L, len(abc), c)
        if sweep.jc_sweep_tiles.launches == before:
            raise AssertionError(f"{name} level did not run K1")
    torch.cuda.synchronize()
    require_equal(torch, "K1 under pallas_state_prefetch", variant["pallas_state_prefetch"],
                  variant["default"])
    d_out = defocus.defocus_box(rgb_t, depth_fx, cfg)
    for name, c in (("stacked", DiffusionConfig(pallas_defocus_variant="stacked")),
                    ("coldiff", DiffusionConfig(pallas_defocus_variant="coldiff",
                                                backend="pallas_interpret"))):
        require_equal(torch, f"K3 under {name}", defocus.defocus_box(rgb_t, depth_fx, c), d_out)
    print("config variants equal to the default output: K1 under pallas_state_prefetch, "
          "K3 under stacked and under coldiff")
    phase_done("6 (the 4K path)")

    # -- 7. the multi-device step -----------------------------------------------------
    from realtimedepthdiffusion_tpu_torch.parallel import dryrun, sharded
    from realtimedepthdiffusion_tpu_torch.parallel import mesh as pmesh

    card = smi.stdout.strip().splitlines()[0]
    halo = sharded.DEFAULT_HALO
    hb, wb = H // 2, W // 2  # the L0 blocks of mesh (2, 2, 2)

    def extended(plane, oy, ox, ring):
        """The block of ``plane`` (..., H, W) at (oy, ox), hb x wb, with the
        ring the halo exchange gives it: neighbours, zeros past the image."""
        padded = torch.nn.functional.pad(plane, (ring, ring, ring, ring))
        return padded[..., oy:oy + hb + 2 * ring, ox:ox + wb + 2 * ring].contiguous()

    def check_block(name, run, plain, crop, whole, n_bytes, n_ops, n_int=0):
        """A block route against its plain version (every output), its
        cropped interior against the same pixels of the whole-image route,
        and the times of both with the bound of the block's work."""
        got, want = run(), plain()
        torch.cuda.synchronize()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = max(require_equal(torch, name, g, w) for g, w in zip(got, want))
        require_equal(torch, f"{name} interior vs the whole image", crop(got[0]), whole)
        t_bound, by = bound(n_bytes, n_ops, n_int)
        line = {"block": list(got[0].shape), "max_abs_err": err,
                "ms": time_ms(torch, run, 20), "plain_ms": time_ms(torch, plain, 3),
                "bound_ms": t_bound, "bound_by": by}
        print(f"{name}: {json.dumps(line)}")
        return line

    depth_t, mask_t, wts, abc = level_case(gray_pyr, 0)
    prev_t = torch.from_numpy(rng.random((H, W)).astype(np.float32) * 255.0).to(dev)
    m8 = mask_t.to(torch.uint8)
    planes = (wts.wr.contiguous(), wts.wd.contiguous(), wts.inv_count.contiguous(), m8)
    abc_k = abc[:halo]
    abc_k_d = torch.from_numpy(abc_k).to(dev)
    whole_u = sweep._tiles_chunk(depth_t.clone(), prev_t, *planes, abc_k_d, 0, halo, halo)[0]
    oy, ox = hb, wb
    blk = [extended(t, oy, ox, halo) for t in (depth_t, prev_t, *planes)]
    px_e = (hb + 2 * halo) * (wb + 2 * halo)
    b_k1 = check_block(
        f"K1 halo block ({oy}, {ox}), k={halo}", lambda: sweep.halo_block_sweeps(*blk, abc_k_d),
        lambda: sweep.halo_block_sweeps_plain(*blk, abc_k),
        lambda u: u[halo:-halo, halo:-halo], whole_u[oy:oy + hb, ox:ox + wb],
        px_e * 29, px_e * halo * JC_OPS)
    # The sharded step's launch: every block of the card in one stack (16
    # blocks of this shape at L0 of a step of 4 on mesh (2, 2, 2)).
    stk = [torch.stack([t] * 16) for t in blk]
    got_stk, one = sweep.halo_block_sweeps(*stk, abc_k_d), sweep.halo_block_sweeps(*blk, abc_k_d)
    torch.cuda.synchronize()
    for t in range(2):
        require_equal(torch, "K1 stack of 16 halo blocks", got_stk[t], torch.stack([one[t]] * 16))
    b_k1["stack16_ms"] = time_ms(torch, lambda: sweep.halo_block_sweeps(*stk, abc_k_d), 10)
    b_k1["stack16_bound_ms"] = bound(16 * px_e * 29, 16 * px_e * halo * JC_OPS)[0]
    print(f"K1 over a stack of 16 such blocks in one launch: {b_k1['stack16_ms']:.3f} ms "
          f"(bound {b_k1['stack16_bound_ms']:.4f}), 16 x one block {16 * b_k1['ms']:.3f} ms")
    del stk, got_stk

    om_k = rb_omegas(fast_cfg.level_iterations(n_levels, 0), fast_cfg)[:halo]
    om_k_d = torch.from_numpy(om_k).to(dev)
    ew_rb = sharded.exchange_width("red_black", halo)
    whole_rb = rb_sweep._tiles_chunk(depth_t.clone(), *planes, om_k_d, 0, halo, halo)
    b_k4 = {}
    for oy, ox in ((hb, wb), (hb - 1, wb)):
        par = (oy + ox) & 1
        blk = [extended(t, oy, ox, ew_rb) for t in (depth_t, *planes)]
        px_e = (hb + 2 * ew_rb) * (wb + 2 * ew_rb)
        b_k4[par] = check_block(
            f"K4 halo block ({oy}, {ox}), parity {par}, k={halo}",
            lambda: rb_sweep.halo_block_rb_sweeps(*blk, par, om_k_d),
            lambda: rb_sweep.halo_block_rb_sweeps_plain(*blk, par, om_k),
            lambda u: u[ew_rb:-ew_rb, ew_rb:-ew_rb], whole_rb[oy:oy + hb, ox:ox + wb],
            px_e * 21, px_e * halo * RB_OPS)

    # The sharded fast step's launch: the blocks of a card in one stack,
    # each with the parity of its origin (4 blocks on mesh (1, 2, 2)).
    origins = ((hb, wb), (hb - 1, wb), (0, 0), (hb, wb - 1))
    pars = [(oy + ox) & 1 for oy, ox in origins]
    stk = [torch.stack([extended(t, oy, ox, ew_rb) for oy, ox in origins])
           for t in (depth_t, *planes)]
    got_stk = rb_sweep.halo_block_rb_sweeps(*stk, pars, om_k_d)
    want_stk = rb_sweep.halo_block_rb_sweeps_plain(*stk, pars, om_k)
    torch.cuda.synchronize()
    k4_stack_err = require_equal(torch, "K4 stack of 4 halo blocks", got_stk, want_stk)
    for i, par in enumerate(pars):
        require_equal(torch, f"K4 stack of 4, block {i} alone", got_stk[i],
                      rb_sweep.halo_block_rb_sweeps(*(t[i] for t in stk), par, om_k_d))
    k4_stack_ms = time_ms(torch, lambda: rb_sweep.halo_block_rb_sweeps(*stk, pars, om_k_d), 10)
    k4_stack_bound = bound(4 * px_e * 21, 4 * px_e * halo * RB_OPS)[0]
    print(f"K4 over a stack of 4 such blocks, parities {pars}, in one launch: "
          f"{k4_stack_ms:.3f} ms (bound {k4_stack_bound:.4f}), max_abs_err {k4_stack_err}")
    del stk, got_stk, want_stk

    ew = defocus.block_ring(H, W, cfg)
    half_fx = defocus.defocus_half_widths(depth_fx, H, W, cfg)
    whole_fx = defocus.defocus_box(rgb_t, depth_fx, cfg)
    b_k3 = {}
    for oy, ox in ((hb, wb), (0, 0)):
        chw_e = extended(chw_t, oy, ox, ew)
        half_b = half_fx[oy:oy + hb, ox:ox + wb].contiguous()
        for r in (None, other_route(ew - 1)):
            run = lambda r=r, a=(chw_e, half_b, oy, ox): defocus.defocus_block(  # noqa: E731
                *a, H, W, cfg, route=r)
            b_k3[(oy, ox, r)] = check_block(
                f"K3 block ({oy}, {ox}) of {H}x{W}, k={cfg.defocus_kernel_size(H, W)}, ring {ew}, "
                f"route {r or defocus.defocus_route(ew - 1)}", run,
                lambda: defocus.defocus_block_sat(chw_e, half_b, oy, ox, H, W, cfg),
                lambda o: o, whole_fx[oy:oy + hb, ox:ox + wb],
                3 * chw_e[0].numel() + hb * wb * 4, *k3_ops(chw_e[0].numel(), hb * wb, False))
            device_only[f"K3 block ({oy}, {ox}) route {r}"] = run

    # The step at full width: the README's --multichip --batch 4 --effect b
    # on the 8-slot mesh (2, 2, 2), every slot on this card.
    mesh8 = pmesh.make_mesh(8, device="cuda")
    lv_routes = [(list(g.shape), sharded.level_is_sharded(mesh8, *g.shape, cfg.solver))
                 for g in gray_pyr]
    print(f"mesh {mesh8}; levels (shape, sharded): {json.dumps(lv_routes)}")
    if not all(r for _, r in lv_routes):
        raise AssertionError(f"a 1080p level runs replicated on {mesh8.shape}")
    n_img = 4
    # One K1 launch per exchange on each card that holds slots.
    want_k1 = len(set(mesh8.devices.values())) * sum(
        -(-cfg.level_iterations(n_levels, lv) // halo) for lv in range(n_levels))
    if len(set(mesh8.devices.values())) == 1 and want_k1 != 244:
        raise AssertionError(f"a sharded 1080p step on one card would launch K1 {want_k1} times")
    want_step = {"jc_sweep_tiles": want_k1, "defocus_block": n_img * mesh8.shape["dy"]
                 * mesh8.shape["dx"]}
    imgs = [seeded_image(rng, H, W) for _ in range(n_img)]
    gps = [pipe.prepare_image(img)[1] for img in imgs]
    rgb_b = torch.from_numpy(np.stack(imgs)).to(dev)
    step_fn, _ = sharded.batched_step(mesh8, H, W, cfg, fx.EFFECT_DEFOCUS)
    smask, svalue = bench_scribbles(H, W)
    st = tuple(torch.stack([s] * n_img) for s in pipe.initial_state())
    step_ms, step_launches = [], {}
    for i in range(3):
        if i == 1:
            add_scribble(smask, svalue)
        m_b = torch.from_numpy(np.stack([smask] * n_img)).to(dev)
        v_b = torch.from_numpy(np.stack([svalue] * n_img)).to(dev)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        depth_b, new_st, out_b = step_fn(rgb_b, m_b, v_b, st)
        end.record()
        end.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        step_ms.append(start.elapsed_time(end))
        if counts != want_step:
            raise AssertionError(f"sharded step {i} launched {counts}, not {want_step}")
        for k, v in counts.items():
            step_launches[k] = step_launches.get(k, 0) + v
        for n in range(n_img):
            d1, _ = pipe.solve(gps[n], m_b[n], v_b[n], tuple(s[n] for s in st))
            o1 = defocus.defocus_box(rgb_b[n], torch.clamp(d1, 0.0, 255.0), cfg)
            torch.cuda.synchronize()
            require_equal(torch, f"sharded step {i} image {n} depth vs single device",
                          depth_b[n], d1)
            require_equal(torch, f"sharded step {i} image {n} defocus vs K3", out_b[n], o1)
        if not torch.equal(depth_b[m_b], v_b[m_b].to(torch.float32)):
            raise AssertionError(f"sharded step {i}: scribble pixels are not pinned")
        print(f"sharded step {i}: {step_ms[-1]:.3f} ms (CUDA events), launches {json.dumps(counts)}, "
              f"depth and defocus of {n_img} images equal to the single-device frame")
        last_in, st = (rgb_b, m_b, v_b, st), new_st
    print(f"sharded 1080p step, batch {n_img} on mesh {mesh8.shape}: "
          f"{json.dumps([round(t, 3) for t in step_ms])} ms on {card}")
    # The busy share: the last step again, on the same inputs (the same
    # work), under the profiler; its device time over that step's
    # unprofiled time. The slots share one stream, so kernels never overlap.
    traced(f"sharded step {len(step_ms) - 1}", lambda: step_fn(*last_in), step_ms[-1])

    # The fast profile, sharded: red-black with the rms early exit on (1, 2, 2),
    # one image, so that the exit's gate is that image's residual. A probe
    # within a hair of the threshold may fall either way when the sum is
    # taken in another order, so the image is the first seeded one whose
    # single-device probes all sit more than 1 % from the threshold.
    mesh4 = pmesh.make_mesh(4, device="cuda")
    fstep, _ = sharded.batched_step(mesh4, H, W, fast_cfg, fx.EFFECT_DEFOCUS)
    fm_d, fv_d = torch.from_numpy(smask).to(dev), torch.from_numpy(svalue).to(dev)
    fst = fpipe.initial_state()
    for attempt in range(12):
        img = imgs[attempt] if attempt < n_img else seeded_image(rng, H, W)
        _, fgp = fpipe.prepare_image(img)
        slog = []
        f1, _ = fpipe.solve(fgp, fm_d, fv_d, fst, slog)
        margin = min(abs(q - e["tol"]) / e["tol"] for e in slog for q in e["probes"])
        if margin > 0.01:
            break
    else:
        raise AssertionError("no seeded image has its fast probes > 1 % from the threshold")
    ops.reset_launch_counts()
    flog = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fdepth, _, fout = fstep(torch.from_numpy(img)[None].to(dev), fm_d[None], fv_d[None],
                            tuple(t[None] for t in fst), flog)
    torch.cuda.synchronize()
    fast_step_s = time.perf_counter() - t0
    fast_halo = {k: v for k, v in ops.launch_counts().items() if v}
    # One K4 launch per exchange (k iterations of a chunk) on each card
    # that holds slots; every 1080p level is sharded on this mesh.
    exchanges = sum(-(-n // halo) for e in flog
                    for n in exit_chunks(e, fast_cfg.residual_check_every))
    want_halo = {"rb_sweep_tiles": len(set(mesh4.devices.values())) * exchanges,
                 "defocus_block": mesh4.shape["dy"] * mesh4.shape["dx"]}
    if fast_halo != want_halo:
        raise AssertionError(f"the sharded fast step launched {fast_halo}, not {want_halo}")
    rmse = float(torch.sqrt(torch.mean(((fdepth[0] - f1) / 255.0) ** 2)))
    levels = [{"shape": list(e["shape"]), "iterations": e["iters"], "single_device": se["iters"],
               "probes": [round(q, 6) for q in e["probes"]]} for e, se in zip(flog, slog)]
    print(f"sharded fast step, seeded image {attempt} (probes >= {margin:.2%} from the threshold) "
          f"on mesh {mesh4.shape}: {fast_step_s * 1e3:.3f} ms (host clock), launches "
          f"{json.dumps(fast_halo)}; RMSE {rmse:.3e} against the single-device fast solve "
          f"(bar 1e-3); tol {flog[0]['tol']:.6f}; {json.dumps(levels)}")
    if not rmse <= 1e-3:
        raise AssertionError(f"sharded fast step: RMSE {rmse} > 1e-3")

    # The whole step on the kernels against the same step on the plain versions.
    h3, w3 = 270, 480
    k_fn, args3 = sharded.batched_step(mesh8, h3, w3, cfg, fx.EFFECT_DEFOCUS)
    p_fn, _ = sharded.batched_step(mesh8, h3, w3, cfg, fx.EFFECT_DEFOCUS, plain=True)
    args3 = args3(2)
    runs = {}
    for name, fn in (("kernels", k_fn), ("plain", p_fn)):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d3, _, o3 = fn(*args3)
        torch.cuda.synchronize()
        runs[name] = (d3, o3, time.perf_counter() - t0, dict(ops.launch_counts()))
    if any(runs["plain"][3].values()):
        raise AssertionError(f"the plain step launched kernels: {runs['plain'][3]}")
    step_err = max(require_equal(torch, "270x480 step depth", runs["kernels"][0], runs["plain"][0]),
                   require_equal(torch, "270x480 step defocus", runs["kernels"][1],
                                 runs["plain"][1]))
    print(f"sharded {h3}x{w3} step, batch 2 on mesh {mesh8.shape}: kernels "
          f"{runs['kernels'][2] * 1e3:.3f} ms, plain {runs['plain'][2] * 1e3:.3f} ms (host clock), "
          f"max_abs_err {step_err}")

    print(f"dryrun_multichip(8): {json.dumps(dryrun.dryrun_multichip(8, device='cuda'))}")
    phase_done("7 (the multi-device step)")

    # -- 9. the incremental re-solve, the V-cycle, the facade, the oracle, the codec ---
    import tempfile
    from unittest import mock

    from realtimedepthdiffusion_tpu_torch import io as port_io
    from realtimedepthdiffusion_tpu_torch import models
    from realtimedepthdiffusion_tpu_torch.core import incremental
    from realtimedepthdiffusion_tpu_torch.core.multigrid import (
        solve_cascade, vcycle_polish, vcycle_warm_config)
    from realtimedepthdiffusion_tpu_torch.oracle import numpy_ref

    def rmse01(a, b):
        """Depth RMSE on [0, 1], of tensors or arrays."""
        a, b = (t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
                for t in (a, b))
        return float(np.sqrt(np.mean(((a.astype(np.float64) - b) / 255.0) ** 2)))

    # The windows, cut from the scene of phase 4 (its last depth state and
    # annotation): K1 and K2 at shapes no frame of phases 4-7 gives them.
    icfg = DiffusionConfig(incremental_iterations=120)
    win_masks, _ = build_annotation_pyramids(frames[2][2], frames[2][3], icfg)
    win_routes = {lv: sweep.strip_route(icfg.incremental_window >> lv,
                                        icfg.incremental_window >> lv, l2, max_cluster)
                  for lv in (0, 1)}
    if win_routes != {0: "K1", 1: "K2"}:
        raise AssertionError(f"the incremental windows route to {win_routes}, not K1 and K2")
    if rb_sweep.rb_resident_fits(192, 192) or rb_sweep.rb_resident_fits(384, 384):
        raise AssertionError("one CTA of K5 holds an incremental window: the red-black "
                             "windows were expected on K4")

    def window_case(level, center):
        """The window of ``solve_incremental`` at ``level`` for an edit at
        ``center``: its clamped origin, the crop of the depth (a view), the
        mask with the frozen ring, and the weights of the crop."""
        win = icfg.incremental_window >> level
        h, w = gpyr[level].shape
        oy, ox = incremental.clamp_origin((center[0] >> level) - win // 2,
                                          (center[1] >> level) - win // 2, win, win, h, w)
        rows, cols = slice(oy, oy + win), slice(ox, ox + win)
        u_w = state[level][rows, cols]
        m_w = win_masks[level][rows, cols] | incremental._ring(win, dev)
        wts = edge_weights(gpyr[level][rows, cols], u_w, level, L, icfg)
        return (oy, ox), u_w, m_w, wts

    win_centers = {"inside": (600, 1100), "top left, clamped": (5, 5),
                   "far corner, clamped": (H - 1, W - 1)}
    windows = {}
    for level, kernel_name, want_launches in ((0, "jc_sweep_tiles", 15), (1, "jc_sweep_resident", 1)):
        abc = abc_schedule(max(icfg.incremental_iterations >> level, 1), icfg)
        om = rb_omegas(len(abc), fast_cfg)
        line = {"sweeps": len(abc), "max_abs_err": 0.0, "origins": {}}
        for label, center in win_centers.items():
            origin, u_w, m_w, wts = window_case(level, center)
            ops.reset_launch_counts()
            got = sweep.solve_level_cuda(u_w, m_w, wts, abc)
            counts = {k: v for k, v in ops.launch_counts().items() if v}
            if counts != {kernel_name: want_launches}:
                raise AssertionError(f"L{level} window {label}: launched {counts}, not "
                                     f"{kernel_name} x{want_launches}")
            want = sweep.solve_level_plain(u_w, m_w, wts, abc)
            torch.cuda.synchronize()
            name = f"{kernel_name} on the L{level} window at {origin} ({label})"
            line["max_abs_err"] = max(line["max_abs_err"], require_equal(torch, name, got, want))
            if not torch.equal(got[m_w], u_w[m_w]):
                raise AssertionError(f"{name}: the frozen ring or a scribble moved")
            # Red-black on the same window: K4, with the window's own parity.
            got_rb = rb_sweep.solve_level_rb_cuda(u_w, m_w, wts, om)
            want_rb = rb_sweep.solve_level_rb_plain(u_w, m_w, wts, om)
            torch.cuda.synchronize()
            line["rb_max_abs_err"] = max(line.get("rb_max_abs_err", 0.0), require_equal(
                torch, f"K4 on the L{level} window at {origin}", got_rb, want_rb))
            line["origins"][label] = list(origin)
        origin, u_w, m_w, wts = window_case(level, win_centers["inside"])
        px = int(u_w.numel())
        line.update(shape=list(u_w.shape), launches=want_launches,
                    ms=time_ms(torch, lambda: sweep.solve_level_cuda(u_w, m_w, wts, abc), 10),
                    plain_ms=time_ms(torch, lambda: sweep.solve_level_plain(u_w, m_w, wts, abc), 3),
                    bound_ms=bound(px * 29, px * len(abc) * JC_OPS)[0])
        w_state, w_run, _ = sweep.chunks_cuda(u_w, m_w, wts, abc)
        device_only[f"window L{level}"] = (
            lambda run=w_run, st=w_state, n=len(abc): run(st, 0, n))
        windows[level] = line
        print(f"incremental window L{level} ({kernel_name}, ring mask, weights of the crop): "
              f"{json.dumps(line)}")

    # The incremental path at full width.
    def incremental_launches(c, gp):
        """The launches of one incremental frame by the routes: a windowed
        level solves its window (and its global sweeps, if any), every other
        level itself; one K3."""
        want = collections.Counter(defocus_box=1)
        inc = c.incremental_iterations if c.incremental_iterations > 0 else c.max_iterations
        for level, g in enumerate(gp):
            h, w = g.shape
            win = c.incremental_window >> level
            if level < c.incremental_window_levels and win < min(h, w):
                iters = max(inc >> level, 1)
                solves = [((win, win), iters)]
                if c.incremental_global_smooth > 0:
                    solves.append(((h, w), min(c.incremental_global_smooth, iters)))
            else:
                solves = [((h, w), c.level_iterations(len(gp), level))]
            for (sh, sw), iters in solves:
                blocks = -(-iters // sweep.TILE_SWEEPS)
                want.update({"K2": {"jc_sweep_resident": 1}, "K1": {"jc_sweep_tiles": blocks},
                             "K6": {"jc_sweep_fused": blocks}}[
                                 sweep.strip_route(sh, sw, l2, max_cluster)])
        return want

    want_inc = incremental_launches(icfg, gray_pyr)
    want_inc_default = incremental_launches(cfg, gray_pyr)
    print(f"incremental frame: launches per frame {json.dumps(want_inc)}; at the default "
          f"config {json.dumps(want_inc_default)}")
    if dict(want_inc) != {"jc_sweep_resident": 4, "jc_sweep_tiles": 15, "defocus_box": 1}:
        raise AssertionError(f"an incremental 1080p frame launches {dict(want_inc)}")
    if dict(want_inc_default) != {"jc_sweep_resident": 4, "jc_sweep_tiles": 125,
                                  "defocus_box": 1}:
        raise AssertionError(f"a default incremental frame launches {dict(want_inc_default)}")

    def plain_solve_level(depth, mask, gray, level, max_level, iters, c, exit_log=None):
        return plain_level(c, depth, mask, gray, level, max_level, iters)

    # The scene: a photograph-like image under a dense annotation, on which
    # a full solve stands still after a few solves. (On the noisy blocks of
    # phases 3-8 it never does, and an incremental frame then differs from
    # a full re-solve by what the full solve itself still moves.)
    ipipe = DepthPipeline(H, W, icfg, device="cuda")
    irgb_d, igp = ipipe.prepare_image(photo_like(np.random.default_rng(SEED + 8), H, W))
    imask, ivalue = dense_scribbles(H, W)
    im_d, iv_d = torch.from_numpy(imask).to(dev), torch.from_numpy(ivalue).to(dev)
    ops.reset_launch_counts()
    _, istate, _ = ipipe.solve_and_effect(fx.EFFECT_DEFOCUS, igp, irgb_d, im_d, iv_d,
                                          ipipe.initial_state())
    if {k: v for k, v in ops.launch_counts().items() if v} != dict(want_frame):
        raise AssertionError(f"the full frame before the edits launched {ops.launch_counts()}")
    # A live session edits a depth that has settled. Only the coarsest
    # level of a full solve starts warm, so the state moves from solve to
    # solve until that level has converged; the frames below are held to a
    # full re-solve, which means something only once the full solve itself
    # stands still.
    for n_settle in range(1, 13):
        settled, new_state = ipipe.solve(igp, im_d, iv_d, istate)
        moved = rmse01(settled, istate[0])
        istate = new_state
        if moved < 1e-3:
            break
    else:
        raise AssertionError(f"the full solve still moves the depth by RMSE {moved} a solve")
    print(f"incremental path: the state settled after {n_settle} more full solves "
          f"(the last moved the depth by RMSE {moved:.3e})")
    win0 = icfg.incremental_window
    edits = (((600, 1100), (590, 610), (1090, 1110), 64), ((5, 5), (0, 12), (0, 12), 192),
             ((H - 1, W - 1), (H - 20, H), (W - 20, W), 128))
    inc_launches, inc_frames = collections.Counter(), []
    for i, ((cy, cx), (r0, r1), (c0, c1), val) in enumerate(edits):
        imask[r0:r1, c0:c1], ivalue[r0:r1, c0:c1] = True, val
        # The session's upload: only the window's bytes cross to the card;
        # the pipeline clamps the origin as it clamps the solve's window.
        oy, ox = incremental.clamp_origin(cy - win0 // 2, cx - win0 // 2, win0, win0, H, W)
        im_d, iv_d = ipipe.update_annotation_window(
            im_d, iv_d, imask[oy:oy + win0, ox:ox + win0], ivalue[oy:oy + win0, ox:ox + win0],
            (cy - win0 // 2, cx - win0 // 2))
        if not (torch.equal(im_d.cpu(), torch.from_numpy(imask))
                and torch.equal(iv_d.cpu(), torch.from_numpy(ivalue))):
            raise AssertionError(f"incremental frame {i}: the uploaded window missed the planes")
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        depth0, new_state, out = ipipe.solve_incremental_and_effect(
            fx.EFFECT_DEFOCUS, igp, irgb_d, im_d, iv_d, istate, (cy, cx))
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        if counts != dict(want_inc):
            raise AssertionError(f"incremental frame {i} launched {counts}, not {dict(want_inc)}")
        inc_launches.update(counts)
        if not bool(torch.isfinite(depth0).all()):
            raise AssertionError(f"incremental frame {i}: depth is not finite")
        if not torch.equal(depth0[im_d], iv_d[im_d].to(torch.float32)):
            raise AssertionError(f"incremental frame {i}: scribble pixels are not pinned")
        if new_state[0] is not depth0 or len(new_state) != n_levels:
            raise AssertionError(f"incremental frame {i}: level 0 of the state is not the depth")
        if tuple(out.shape) != (H, W, 3) or out.dtype != torch.uint8:
            raise AssertionError(f"incremental frame {i}: effect is {tuple(out.shape)} {out.dtype}")
        # Outside the window (and on its frozen ring) level 0 is the old
        # level plus the pyrUp'd correction of level 1, re-seeded.
        injected = seed_depth(istate[0] + pyr_up(new_state[1] - istate[1], (H, W)), im_d, iv_d)
        outside = torch.ones((H, W), dtype=torch.bool, device=dev)
        outside[oy + 1:oy + win0 - 1, ox + 1:ox + win0 - 1] = False
        if not torch.equal(depth0[outside], injected[outside]):
            raise AssertionError(f"incremental frame {i}: pixels outside the window at "
                                 f"({oy}, {ox}) differ from the injected field")
        if torch.equal(depth0[~outside], injected[~outside]):
            raise AssertionError(f"incremental frame {i}: the window solve changed nothing")
        # The same frame on the plain versions, on the card.
        ops.reset_launch_counts()
        with mock.patch.object(incremental, "solve_level", plain_solve_level):
            p_depth, p_state = incremental.solve_incremental(igp, im_d, iv_d, istate, (cy, cx), icfg)
        p_out = defocus.defocus_sat(irgb_d, torch.clamp(p_depth, 0.0, 255.0), icfg)
        torch.cuda.synchronize()
        if any(ops.launch_counts().values()):
            raise AssertionError(f"the plain incremental frame launched {ops.launch_counts()}")
        err = max([require_equal(torch, f"incremental frame {i} effect", out, p_out)]
                  + [require_equal(torch, f"incremental frame {i} state L{lv}", a, b)
                     for lv, (a, b) in enumerate(zip(new_state, p_state))])
        # Against a full re-solve of the same annotation from the same state.
        full_depth, _ = ipipe.solve(igp, im_d, iv_d, istate)
        rmse = rmse01(depth0, full_depth)
        print(f"incremental frame {i}: centre ({cy}, {cx}), window at ({oy}, {ox}), "
              f"{host_ms:.3f} ms (host clock), launches {json.dumps(counts)}, kernels against "
              f"plain max_abs_err {err}, RMSE against a full re-solve {rmse:.3e} (bar 3e-2)")
        if not rmse <= 3e-2:
            raise AssertionError(f"incremental frame {i}: RMSE {rmse} > 3e-2 against a full re-solve")
        inc_frames.append((istate, im_d, iv_d, (cy, cx)))
        istate = new_state

    # For the record, no bar: on the scene of phases 3-8 a full solve does
    # not stand still, so there an incremental frame, even one with no edit
    # at all, differs from a full re-solve by what the full solve itself
    # still moves.
    hard_m, hard_v, hard_state, hard_moves = frames[2][2], frames[2][3], state, []
    for _ in range(3):
        hard_depth, hard_new = pipe.solve(gpyr, hard_m, hard_v, hard_state)
        hard_moves.append(rmse01(hard_depth, hard_state[0]))
        hard_state = hard_new
    hard_inc, _ = ipipe.solve_incremental(gpyr, hard_m, hard_v, hard_state, edits[0][0])
    hard_full, _ = ipipe.solve(gpyr, hard_m, hard_v, hard_state)
    print(f"on the noisy blocks of phases 3-8 (frames 4-6 of that scene): successive full "
          f"solves move the depth by RMSE {json.dumps([round(x, 5) for x in hard_moves])}; an "
          f"incremental frame with no edit differs from a full re-solve by "
          f"{rmse01(hard_inc, hard_full):.3e}")

    # Times in one call: the first edit's incremental frame, a full frame
    # from the same state on the same annotation, and the incremental
    # frame at the default config (1000 sweeps at level 0).
    t_state, t_m, t_v, t_c = inc_frames[0]
    inc_run = lambda: ipipe.solve_incremental_and_effect(  # noqa: E731
        fx.EFFECT_DEFOCUS, igp, irgb_d, t_m, t_v, t_state, t_c)
    full_run = lambda: ipipe.solve_and_effect(fx.EFFECT_DEFOCUS, igp, irgb_d, t_m, t_v, t_state)  # noqa: E731
    inc_default_run = lambda: pipe.solve_incremental_and_effect(  # noqa: E731
        fx.EFFECT_DEFOCUS, igp, irgb_d, t_m, t_v, t_state, t_c)
    ops.reset_launch_counts()
    inc_default_run()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    if counts != dict(want_inc_default):
        raise AssertionError(f"the default incremental frame launched {counts}, not "
                             f"{dict(want_inc_default)}")
    inc_line = {"incremental_ms": time_ms(torch, inc_run, 10), "full_ms": time_ms(torch, full_run, 10),
                "incremental_default_ms": time_ms(torch, inc_default_run, 5),
                "default_launches": counts}
    inc_line["incremental_traced"] = traced("incremental frame", inc_run, inc_line["incremental_ms"])
    inc_line["full_traced"] = traced("full frame beside it", full_run, inc_line["full_ms"])
    print(f"incremental frame {H}x{W} (incremental_iterations=120) solve+defocus against a full "
          f"frame, same state and annotation (CUDA events, median): {json.dumps(inc_line)}")

    # The V-cycle path at full width.
    vcfg = DiffusionConfig(multigrid="vcycle")
    vpipe = DepthPipeline(H, W, vcfg, device="cuda")
    vmask, vvalue = bench_scribbles(H, W)
    vstate = vpipe.initial_state()
    v_launches = collections.Counter()
    for i in range(2):
        if i == 1:
            add_scribble(vmask, vvalue)
        vm_d, vv_d = torch.from_numpy(vmask).to(dev), torch.from_numpy(vvalue).to(dev)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v_depth, v_new, v_out = vpipe.solve_and_effect(fx.EFFECT_DEFOCUS, igp, irgb_d, vm_d, vv_d,
                                                       vstate)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        if counts != dict(want_frame):
            raise AssertionError(f"V-cycle frame {i} launched {counts}, not its warm cascade's "
                                 f"{dict(want_frame)}")
        v_launches.update(counts)
        if not bool(torch.isfinite(v_depth).all()):
            raise AssertionError(f"V-cycle frame {i}: depth is not finite")
        lo, hi = float(v_depth.min()), float(v_depth.max())
        if lo < 0.0 or hi > 255.0:
            raise AssertionError(f"V-cycle frame {i}: depth [{lo}, {hi}] left [0, 255]")
        if not torch.equal(v_depth[vm_d], vv_d[vm_d].to(torch.float32)):
            raise AssertionError(f"V-cycle frame {i}: scribble pixels are not pinned")
        if v_new[0] is not v_depth or tuple(v_out.shape) != (H, W, 3) or v_out.dtype != torch.uint8:
            raise AssertionError(f"V-cycle frame {i}: state or effect malformed")
        print(f"V-cycle frame {i}: {host_ms:.3f} ms (host clock), launches {json.dumps(counts)}, "
              f"depth [{lo:.4f}, {hi:.4f}]")
        v_prev, vstate = vstate, v_new
    # The polish must not leave the fine level further from converged than
    # the cascade it starts from, both measured under one operator: the
    # weights of the cascade's depth, which are the polish's own.
    u_c, st_c = solve_cascade(igp, vm_d, vv_d, v_prev, vcycle_warm_config(vcfg))
    wts_c = edge_weights(igp[0], u_c, 0, L, vcfg)
    v_res = {"cascade_max": float(solver.residual_norm(u_c, vm_d, wts_c)),
             "vcycle_max": float(solver.residual_norm(v_depth, vm_d, wts_c)),
             "cascade_rms": float(solver.residual_rms(u_c, vm_d, wts_c)),
             "vcycle_rms": float(solver.residual_rms(v_depth, vm_d, wts_c))}
    require_equal(torch, "the V-cycle's polish of the cascade's depth", v_depth,
                  vcycle_polish(igp, vm_d, vv_d, u_c, vcfg))
    if not v_res["vcycle_max"] <= 1.05 * v_res["cascade_max"]:
        raise AssertionError(f"the V-cycle's fine residual grew: {v_res}")
    v_run = lambda: vpipe.solve_and_effect(fx.EFFECT_DEFOCUS, igp, irgb_d, vm_d, vv_d, v_prev)  # noqa: E731
    polish_run = lambda: vcycle_polish(igp, vm_d, vv_d, u_c, vcfg)  # noqa: E731
    ops.reset_launch_counts()
    polish_run()
    if any(ops.launch_counts().values()):
        raise AssertionError(f"the polish launched a kernel of the port: {ops.launch_counts()}")
    v_line = {"frame_ms": time_ms(torch, v_run, 3), "polish_ms": time_ms(torch, polish_run, 3),
              "residuals": v_res}
    v_line["polish_traced"] = traced("V-cycle polish", polish_run, v_line["polish_ms"])
    v_line["frame_traced"] = traced("V-cycle frame", v_run, v_line["frame_ms"])
    print(f"V-cycle {H}x{W} ({vcfg.vcycles} cycles, {vcfg.vcycle_pre_smooth}+"
          f"{vcfg.vcycle_post_smooth} smoothing steps a level, {vcfg.vcycle_coarse_iters} at the "
          f"coarsest), plain torch ops on the card: {json.dumps(v_line)}")

    def card_vs_cpu(c, name, h, w):
        """One solve of ``c`` at (h, w) on the card and on the CPU; RMSE."""
        rgb_s = seeded_image(np.random.default_rng(SEED + 9), h, w)
        m_s, v_s = bench_scribbles(H, W)
        m_s = m_s[::H // h, ::W // w][:h, :w].copy()
        v_s = v_s[::H // h, ::W // w][:h, :w].copy()
        depths = []
        for device in ("cuda", "cpu"):
            sp = DepthPipeline(h, w, c, device=device)
            _, sg = sp.prepare_image(rgb_s)
            d, _ = sp.solve(sg, torch.from_numpy(m_s).to(device), torch.from_numpy(v_s).to(device),
                            sp.initial_state())
            depths.append(d)
        rmse = rmse01(*depths)
        print(f"{name} solve {h}x{w}: card vs CPU depth RMSE {rmse:.3e} (bar 1e-3)")
        if not rmse <= 1e-3:
            raise AssertionError(f"{name} solve {h}x{w}: card vs CPU RMSE {rmse} > 1e-3")
        return rmse

    v_cpu_rmse = card_vs_cpu(vcfg, "V-cycle", h3, w3)

    # The sharded V-cycle: a sharded warm cascade, the polish per image.
    sv_fn, sv_args = sharded.batched_step(mesh8, h3, w3, vcfg, fx.EFFECT_DEFOCUS)
    sv_args = sv_args(2)
    ops.reset_launch_counts()
    sv_depth, _, sv_out = sv_fn(*sv_args)
    torch.cuda.synchronize()
    sv_counts = {k: v for k, v in ops.launch_counts().items() if v}
    if not sv_counts.get("jc_sweep_tiles") or not sv_counts.get("defocus_block"):
        raise AssertionError(f"the sharded V-cycle step launched {sv_counts}")
    sv_pipe = DepthPipeline(h3, w3, vcfg, device="cuda")
    sv_rmse = 0.0
    for n in range(2):
        _, sg = sv_pipe.prepare_image(sv_args[0][n])
        d1, _ = sv_pipe.solve(sg, sv_args[1][n], sv_args[2][n], tuple(t[n] for t in sv_args[3]))
        sv_rmse = max(sv_rmse, rmse01(sv_depth[n], d1))
    print(f"sharded V-cycle {h3}x{w3} step, batch 2 on mesh {mesh8.shape}: launches "
          f"{json.dumps(sv_counts)}, RMSE {sv_rmse:.3e} against the single-device V-cycle (bar 1e-3)")
    if not sv_rmse <= 1e-3:
        raise AssertionError(f"sharded V-cycle: RMSE {sv_rmse} > 1e-3")

    # The NumPy oracle, run here on the host, against a solve on the card.
    ho, wo = 96, 128
    orgb = seeded_image(np.random.default_rng(SEED + 10), ho, wo)
    omask, ovalue = bench_scribbles(H, W)
    omask, ovalue = omask[::11, ::15][:ho, :wo].copy(), ovalue[::11, ::15][:ho, :wo].copy()
    opipe = DepthPipeline(ho, wo, cfg, device="cuda")
    _, ogp = opipe.prepare_image(orgb)
    o_depth, _ = opipe.solve(ogp, torch.from_numpy(omask).to(dev), torch.from_numpy(ovalue).to(dev),
                             opipe.initial_state())
    t0 = time.perf_counter()
    o_want, _ = numpy_ref.solve_pyramid(numpy_ref.rgb_to_gray(orgb), omask, ovalue, None, cfg)
    oracle_rmse = rmse01(o_depth, o_want)
    print(f"oracle: {ho}x{wo} default solve on the card against numpy_ref.solve_pyramid on the "
          f"host ({time.perf_counter() - t0:.2f} s): RMSE {oracle_rmse:.3e} (bar 1e-3), "
          f"{int(omask.sum())} scribbled pixels")
    if not oracle_rmse <= 1e-3 or not omask.any():
        raise AssertionError(f"card solve against the oracle: RMSE {oracle_rmse} > 1e-3")

    # The facade: numpy in, numpy out, the state on the card.
    hf, wf = H // 2, W // 2
    frgb = seeded_image(np.random.default_rng(SEED + 11), hf, wf)
    fmask, fvalue = (a[::2, ::2].copy() for a in bench_scribbles(H, W))
    model = models.ChebyshevCascade(device="cuda", incremental_window=192)
    ops.reset_launch_counts()
    f_depth, f_art, f_state = model.solve_and_render(frgb, fmask, fvalue, "b")
    f_counts = {k: v for k, v in ops.launch_counts().items() if v}
    fmask[300:310, 500:510], fvalue[300:310, 500:510] = True, 96
    ops.reset_launch_counts()
    f_depth2, f_state2 = model.solve_incremental(frgb, fmask, fvalue, f_state, (305, 505))
    f_counts2 = {k: v for k, v in ops.launch_counts().items() if v}
    for name, d in (("solve_and_render", f_depth), ("solve_incremental", f_depth2)):
        if not (isinstance(d, np.ndarray) and d.dtype == np.float32 and d.shape == (hf, wf)
                and np.isfinite(d).all()):
            raise AssertionError(f"facade {name}: depth malformed")
    if not (f_art.dtype == np.uint8 and f_art.shape == (hf, wf, 3)):
        raise AssertionError(f"facade: art is {f_art.dtype} {f_art.shape}")
    if not np.array_equal(f_depth2[fmask], fvalue[fmask].astype(np.float32)):
        raise AssertionError("facade solve_incremental: scribble pixels are not pinned")
    if not all(t.is_cuda for t in f_state2) or not f_counts2.get("jc_sweep_resident"):
        raise AssertionError(f"facade solve_incremental: state off the card or launches {f_counts2}")
    if set(f_counts) != {"jc_sweep_resident", "jc_sweep_tiles", "defocus_box"}:
        raise AssertionError(f"facade solve_and_render launched {f_counts}")
    print(f"facade ChebyshevCascade(device='cuda', incremental_window=192) at {hf}x{wf}: "
          f"solve_and_render launches {json.dumps(f_counts)}, solve_incremental "
          f"{json.dumps(f_counts2)}, moved the depth by RMSE {rmse01(f_depth2, f_depth):.3e}")

    # The codec: a 16-bit depth and an RGB image through PNG files.
    u16 = port_io.depth_to_u16(f_depth2)
    if not np.array_equal(u16, opipe.depth_u16(torch.from_numpy(f_depth2).to(dev)).cpu().numpy()):
        raise AssertionError("io.depth_to_u16 differs from DepthPipeline.depth_u16 on the card")
    for name, arr in (("depth16", u16), ("art", f_art)):
        if not np.array_equal(port_io.png_decode(port_io.png_encode(arr, 1)), arr):
            raise AssertionError(f"codec: {name} did not survive png_encode -> png_decode")
    with tempfile.TemporaryDirectory() as tmp:
        p16, prgb, pann = (f"{tmp}/{n}.png" for n in ("depth16", "art", "ann"))
        port_io.imwrite(p16, u16, png_level=1)
        port_io.imwrite(prgb, f_art)
        port_io.save_annotation(pann, fmask, fvalue)
        with open(p16, "rb") as f:
            back16 = port_io.png_decode(f.read())
        m_back, v_back = port_io.load_annotation(pann)
        if not (np.array_equal(back16, u16) and np.array_equal(port_io.imread_rgb(prgb), f_art)
                and port_io.image_size(prgb) == (hf, wf) and np.array_equal(m_back, fmask)
                and np.array_equal(v_back[fmask], fvalue[fmask])):
            raise AssertionError("codec: a PNG written by io.imwrite did not read back equal")
    print(f"codec {port_io.codec()!r}: a 16-bit gray and an RGB PNG of {hf}x{wf} and an "
          f"annotation written and read back equal")
    phase_done("9 (incremental, V-cycle, facade, oracle, codec)")

    # -- 10. the live session: native runtime, CLI, live updates, checkpoint, GUI -----
    from realtimedepthdiffusion_tpu_torch.core.annotation import paint as torch_paint
    from realtimedepthdiffusion_tpu_torch.live import cli as live_cli
    from realtimedepthdiffusion_tpu_torch.live import gui as live_gui
    from realtimedepthdiffusion_tpu_torch.live.session import DepthSession
    from realtimedepthdiffusion_tpu_torch.native import runtime as native_rt

    live = {"codec": port_io.codec()}
    live_launches = collections.Counter()
    tmp_live = tempfile.TemporaryDirectory()
    tmp = tmp_live.name

    # The native runtime: built by g++ here, and the session runs on it. Its
    # planner, brush and codec against its own Python fallback.
    t0 = time.perf_counter()
    nrt = native_rt.NativeRuntime()
    if not nrt.available:
        raise AssertionError("the native runtime did not build with g++: a session would run "
                             "its Python fallback")
    probe = native_rt.Arena(4096)
    if not probe.native:
        raise AssertionError("the session's host arena is not the native one")
    probe.close()
    build_s = time.perf_counter() - t0
    fallback = native_rt.NativeRuntime()
    fallback.lib = None
    for (h, w), c in (((H, W), cfg), ((H4, W4), cfg), ((H, W), icfg)):
        for it in (c.max_iterations, c.incremental_iterations or 7):
            got = nrt.plan(h, w, c.pyramid_base_size, it)
            if got != fallback.plan(h, w, c.pyramid_base_size, it) or got != [
                    (*c.level_size(h, w, lv), DiffusionConfig(max_iterations=it).level_iterations(
                        len(got), lv)) for lv in range(c.num_levels(h, w))]:
                raise AssertionError(f"native plan {h}x{w} {it}: {got}")
    if not np.array_equal(nrt.chebyshev_omegas(1000, cfg.chebyshev_s, cfg.chebyshev_rho),
                          fallback.chebyshev_omegas(1000, cfg.chebyshev_s, cfg.chebyshev_rho)):
        raise AssertionError("native Chebyshev omegas differ from the fallback's")
    radius = cfg.brush_radius(H, W)
    strokes = [(900, 560, 64, radius), (0, 0, 192, radius), (W - 1, H - 1, 254, radius),
               (-5, 300, 0, radius), (1000, H + 4, 128, radius), (5000, 5000, 64, radius),
               (700, 700, 128, 0), (700, 700, 128, -3), (960, 540, 1, 400)]
    planes = {}
    for tag, r in (("native", nrt), ("fallback", fallback)):
        m_p, v_p = (a.astype(np.uint8) for a in dense_scribbles(H, W))
        rects = [r.paint(m_p, v_p, x, y, col, rad) for x, y, col, rad in strokes]
        planes[tag] = (rects, m_p, v_p)
    if not (planes["native"][0] == planes["fallback"][0]
            and np.array_equal(planes["native"][1], planes["fallback"][1])
            and np.array_equal(planes["native"][2], planes["fallback"][2])):
        raise AssertionError("the native brush differs from the fallback's")
    tm, tv = (torch.from_numpy(a).to(dev) for a in dense_scribbles(H, W))
    for x, y, col, rad in strokes:
        tm, tv = torch_paint(tm, tv, x, y, col, rad)
    if not (np.array_equal(tm.cpu().numpy(), planes["native"][1].astype(bool))
            and np.array_equal(tv.cpu().numpy(), planes["native"][2])):
        raise AssertionError("core.annotation.paint on the card differs from the native brush")
    enc = nrt.annotation_encode(planes["native"][1], planes["native"][2], cfg.annotation_sentinel)
    dec = nrt.annotation_decode(enc, cfg.annotation_sentinel)
    if not (np.array_equal(enc, fallback.annotation_encode(planes["native"][1], planes["native"][2],
                                                           cfg.annotation_sentinel))
            and all(np.array_equal(a, b) for a, b in
                    zip(dec, fallback.annotation_decode(enc, cfg.annotation_sentinel)))
            and np.array_equal(dec[0], planes["native"][1].astype(bool))):
        raise AssertionError("the native annotation codec differs from the fallback's")
    pm, pv = (a.astype(np.uint8) for a in dense_scribbles(H, W))
    paint_us = {}
    for tag, r in (("native", nrt), ("fallback", fallback)):
        t0 = time.perf_counter()
        for i in range(200):
            r.paint(pm, pv, (100 + 7 * i) % (W - 100), H // 2, 64, radius)
        paint_us[tag] = (time.perf_counter() - t0) / 200 * 1e6
    live["native"] = {"library": native_rt._SO.rsplit("/", 1)[-1], "build_s": build_s,
                      "paint_us": paint_us, "strokes_checked": len(strokes)}
    print(f"native runtime: {json.dumps(live['native'])}; plan, omegas, brush and codec equal "
          f"to the Python fallback, the card's paint equal to the native brush")

    # The CLI, headless at full width on PNG files, against the pipeline.
    lrgb = photo_like(np.random.default_rng(SEED + 12), H, W)
    lmask, lvalue = dense_scribbles(H, W)
    img_p, ann_p, cli_out = f"{tmp}/image.png", f"{tmp}/annotation.png", f"{tmp}/cli"
    port_io.imwrite(img_p, lrgb, png_level=1)
    port_io.save_annotation(ann_p, lmask, lvalue)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rc = live_cli.main(["-i", img_p, "-a", ann_p, "--headless", "--solve", "--effect", "b",
                        "--save-dir", cli_out, "--depth16", "--time", "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    cli_counts = {k: v for k, v in ops.launch_counts().items() if v}
    # The solve's frame, and K3 once more: save() renders the effect again
    # for ArtisticEffect.png, as the reference's save does.
    want_cli = dict(want_frame + collections.Counter(defocus_box=1))
    if rc != 0 or cli_counts != want_cli:
        raise AssertionError(f"the CLI returned {rc} and launched {cli_counts}, not {want_cli}")
    live_launches.update(cli_counts)
    cpipe = DepthPipeline(H, W, cfg, device="cuda")
    c_rgb, c_gp = cpipe.prepare_image(lrgb)
    c_m, c_v = port_io.load_annotation(ann_p)
    c_depth, _, c_out = cpipe.solve_and_effect(fx.EFFECT_DEFOCUS, c_gp, c_rgb,
                                               torch.from_numpy(c_m).to(dev),
                                               torch.from_numpy(c_v).to(dev), cpipe.initial_state())
    want8 = cpipe.depth_u8(c_depth).cpu().numpy()
    got8 = port_io.imread_rgb(f"{cli_out}/DepthMap.png")
    with open(f"{cli_out}/DepthMap16.png", "rb") as f:
        got16 = port_io.png_decode(f.read())
    if not all(np.array_equal(got8[..., ch], want8) for ch in range(3)):
        raise AssertionError("the CLI's DepthMap.png differs from DepthPipeline.solve_and_effect")
    if not np.array_equal(port_io.imread_rgb(f"{cli_out}/ArtisticEffect.png"), c_out.cpu().numpy()):
        raise AssertionError("the CLI's ArtisticEffect.png differs from the pipeline's effect")
    if not np.array_equal(got16, cpipe.depth_u16(c_depth).cpu().numpy()):
        raise AssertionError("the CLI's DepthMap16.png differs from DepthPipeline.depth_u16")
    live["cli"] = {"s": cli_s, "launches": cli_counts,
                   "files": sorted(os.listdir(cli_out))}
    print(f"CLI --headless --solve --effect b --depth16 --time --device cuda at {H}x{W}: "
          f"{cli_s:.3f} s from reading the PNGs to writing five (codec {port_io.codec()!r}), "
          f"launches {json.dumps(cli_counts)}; DepthMap.png, DepthMap16.png and "
          f"ArtisticEffect.png equal to the pipeline's")

    # Live sessions: each update is strokes and solve() as a user makes
    # them, with the launches it must make, and the same update on the plain
    # versions on the card from the state before it.
    def logged(fn, n_pos, log):
        """``fn`` with ``exit_log=log`` where its caller passes none."""
        def call(*a, **kw):
            if len(a) > n_pos or "exit_log" in kw:
                return fn(*a, **kw)
            return fn(*a, exit_log=log, **kw)
        return call

    def live_session(c):
        s = DepthSession(lrgb, c, device="cuda")
        if not (s.native.available and s.arena.native):
            raise AssertionError("the session does not run on the native runtime")
        s.exit_log = []
        for p in filter(None, (s.pipe, s._inc_pipe)):
            for meth, n_pos in (("solve", 4), ("solve_and_effect", 6), ("solve_incremental", 5),
                                ("solve_incremental_and_effect", 7)):
                setattr(p, meth, logged(getattr(p, meth), n_pos, s.exit_log))
        s.set_effect_key("b")
        return s

    def expected_launches(s, c, local, n_rects, pipe_cfg):
        """What an update must launch: by the exit log under the early exit,
        else by the routes (a full frame of its pipeline, or one windowed
        re-solve per rect); one K3."""
        if c.early_exit:
            want = collections.Counter(defocus_box=1)
            for e in s.exit_log:
                if rb_sweep.rb_resident_fits(*e["shape"]):
                    want["rb_sweep_resident"] += len(exit_chunks(e, c.residual_check_every))
                else:
                    want["rb_sweep_tiles"] += sum(-(-n // rb_sweep.RB_TILE_ITERS)
                                                  for n in exit_chunks(e, c.residual_check_every))
            return dict(want)
        if not local:
            return dict(frame_launches(gray_pyr, pipe_cfg))
        one = incremental_launches(c, gray_pyr)
        return {k: (1 if k == "defocus_box" else n_rects * v) for k, v in one.items()}

    def live_update(s, c, name, paints=(), load=False, verify=True):
        """One update: (x, y, colour key) strokes or an annotation load, then
        solve(). Returns its row of numbers."""
        pipe_cfg = s._inc_pipe.cfg if (s._inc_pipe is not None and s.solve_count > 0) else c
        before_state = s.depth_state
        totals = dict(s.timer.totals)
        s.exit_log.clear()
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for x, y, key in paints:
            s.set_color_key(key)
            s.paint(x, y)
        if load:
            s.load_annotation_file(ann_p)
        rects = list(s.dirty_rects)
        u8 = s.solve()
        end.record()
        end.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        live_launches.update(counts)
        s_win = min(c.incremental_window, H, W)
        local = (s._inc_pipe is not None and s.solve_count > 1 and bool(rects)
                 and len(rects) <= max(c.incremental_max_rects, 1)
                 and all(r[2] - r[0] + 1 <= s_win and r[3] - r[1] + 1 <= s_win for r in rects))
        want_bytes = (2 * s_win * s_win * len(rects) if local
                      else 2 * H * W if rects or s.solve_count == 1 else 0)
        if s.last_upload_bytes != want_bytes:
            raise AssertionError(f"{name}: uploaded {s.last_upload_bytes} bytes, not {want_bytes}")
        want = expected_launches(s, c, local, len(rects), pipe_cfg)
        if counts != want:
            raise AssertionError(f"{name}: launched {counts}, not {want}")
        if not (isinstance(u8, np.ndarray) and u8.dtype == np.uint8 and u8.shape == (H, W)):
            raise AssertionError(f"{name}: solve() returned {type(u8)}")
        m_d = torch.tensor(s.mask_np != 0, device=dev)
        v_d = torch.tensor(s.value_np, device=dev)
        if not (torch.equal(s._mask_d, m_d) and torch.equal(s._value_d, v_d)):
            raise AssertionError(f"{name}: the device planes differ from the host planes")
        if not torch.equal(s.depth0[m_d], v_d[m_d].to(torch.float32)):
            raise AssertionError(f"{name}: scribble pixels are not pinned")
        row = {"rects": len(rects), "path": "windowed" if local else "full",
               "host_ms": host_ms, "event_ms": start.elapsed_time(end),
               "upload_ms": (s.timer.totals["upload"] - totals.get("upload", 0.0)) * 1e3,
               "solve_ms": (s.timer.totals["solve"] - totals.get("solve", 0.0)) * 1e3,
               "upload_bytes": s.last_upload_bytes, "launches": counts}
        if verify:
            # The same update on the plain versions on the card.
            ops.reset_launch_counts()
            if local:
                st = before_state
                with mock.patch.object(incremental, "solve_level", plain_solve_level):
                    for r in rects:
                        p_depth, st = incremental.solve_incremental(
                            s.gray_pyr, m_d, v_d, st, ((r[0] + r[2]) // 2, (r[1] + r[3]) // 2), c)
                p_out = defocus.defocus_sat(s.rgb, torch.clamp(p_depth, 0.0, 255.0), c)
            else:
                p_depth, st, p_out = plain_frame(pipe_cfg, s.gray_pyr, before_state,
                                                 (None, s.rgb, m_d, v_d))
            torch.cuda.synchronize()
            if any(ops.launch_counts().values()):
                raise AssertionError(f"{name}: the plain update launched {ops.launch_counts()}")
            row["max_abs_err"] = max(
                [require_equal(torch, f"{name} effect", s.artistic, p_out)]
                + [require_equal(torch, f"{name} state L{lv}", a, b)
                   for lv, (a, b) in enumerate(zip(s.depth_state, st))])
            if not np.array_equal(u8, s.pipe.depth_u8(p_depth).cpu().numpy()):
                raise AssertionError(f"{name}: the u8 map differs from the plain update's")
        return row

    def at(fx_, fy_):
        """The pixel (x, y) at these fractions of the width and height."""
        return int(fx_ * W), int(fy_ * H)

    def drag(fx_, fy_, n, key):
        """A drag of ``n`` paint events 6 pixels apart, to the right."""
        x0, y = at(fx_, fy_)
        return [(x0 + 6 * i, y, key) for i in range(n)]

    script = [
        ("first", {"load": True}),
        ("one rect", {"paints": drag(0.47, 0.52, 8, 1)}),
        ("two rects", {"paints": [(*at(0.16, 0.74), 3), (*at(0.83, 0.28), 4)]}),
        # Five strokes, the last two near each other but apart: the fifth
        # rect merges with the fourth, the nearest.
        ("overflow", {"paints": [(*at(0.1, 0.18), 2), (*at(0.88, 0.18), 2), (*at(0.88, 0.83), 2),
                                 (*at(0.5, 0.5), 0), (*at(0.52, 0.56), 0)]}),
        ("annotation load", {"load": True}),
        ("idle", {}),
    ]
    timed_kinds = {"one rect": lambda i: {"paints": drag(0.22 + 0.047 * i, 0.93, 8, 1 + i % 4)},
                   "two rects": lambda i: {"paints": [(*at(0.07 + 0.03 * i, 0.13), 2),
                                                      (*at(0.93 - 0.03 * i, 0.87), 3)]},
                   "idle": lambda i: {}}

    def live_loop(label, c, verified=None, n_timed=5):
        """The script on a new session of ``c``, each update (or those
        named in ``verified``) held to its plain version, then ``n_timed``
        timed updates of each kind."""
        s = live_session(c)
        rows = {}
        for name, kw in script:
            if name == "overflow" and c.incremental_iterations > 0:
                for x, y, key in kw["paints"][:-1]:
                    s.set_color_key(key)
                    s.paint(x, y)
                if len(s.dirty_rects) != max(c.incremental_max_rects, 1):
                    raise AssertionError(f"{label} overflow: {len(s.dirty_rects)} rects pending")
                kw = {"paints": kw["paints"][-1:]}
            rows[name] = live_update(s, c, f"{label} {name}",
                                     verify=verified is None or name in verified, **kw)
        timed = {}
        for kind, make in timed_kinds.items():
            timed[kind] = [live_update(s, c, f"{label} {kind} (timed {i})", verify=False,
                                       **make(i)) for i in range(n_timed)]
        summary = {}
        for kind, rs in timed.items():
            summary[kind] = {key: float(np.median([r[key] for r in rs]))
                             for key in ("host_ms", "event_ms", "upload_ms", "solve_ms")}
            summary[kind].update(upload_bytes=rs[0]["upload_bytes"], path=rs[0]["path"],
                                 launches=rs[0]["launches"], n=len(rs),
                                 host_ms_all=[round(r["host_ms"], 3) for r in rs])
        for name, row in rows.items():
            print(f"live {label} update '{name}': {json.dumps(row)}")
        print(f"live {label}: per update as a user sees it (strokes, then solve() returning the "
              f"u8 map; medians of {n_timed}): {json.dumps(summary)}")
        return s, {"updates": rows, "timed": summary}

    s_inc, live["incremental_120"] = live_loop("incremental_iterations=120", icfg)
    inc_rows = live["incremental_120"]["updates"]
    for name, want in (("first", {"jc_sweep_resident": 3, "jc_sweep_tiles": 24, "defocus_box": 1}),
                       ("one rect", {"jc_sweep_resident": 4, "jc_sweep_tiles": 15, "defocus_box": 1}),
                       ("two rects", {"jc_sweep_resident": 8, "jc_sweep_tiles": 30,
                                      "defocus_box": 1})):
        if inc_rows[name]["launches"] != want:
            raise AssertionError(f"live update '{name}' launched {inc_rows[name]['launches']}, "
                                 f"not {want}")
    # Every update at the default config is a full frame: two of them are
    # held to plain, the frame of phase 4 being the same code.
    _, live["default"] = live_loop("default config", cfg, verified=("first", "one rect"))
    fast_live = live_cli.make_config(live_cli.parse_args(["-i", img_p, "--profile", "fast"]))
    _, live["fast"] = live_loop("--profile fast", fast_live)
    fast_counts = collections.Counter()
    for row in live["fast"]["updates"].values():
        fast_counts.update(row["launches"])
    if not (fast_counts["rb_sweep_tiles"] and fast_counts["rb_sweep_resident"]
            and not fast_counts["jc_sweep_tiles"] and not fast_counts["jc_sweep_resident"]):
        raise AssertionError(f"the fast live loop launched {dict(fast_counts)}")

    # save(): the four PNGs and the annotation, by the codec this machine has.
    t0 = time.perf_counter()
    paths = s_inc.save(f"{tmp}/save", depth16=True)
    live["save_ms"] = (time.perf_counter() - t0) * 1e3
    if len(paths) != 4 or not all(os.path.exists(p) for p in paths):
        raise AssertionError(f"save() wrote {paths}")
    print(f"save(): {live['save_ms']:.3f} ms for AnnotatedImage, Annotation, DepthMap, "
          f"ArtisticEffect and DepthMap16 at {H}x{W} (codec {port_io.codec()!r}, host clock)")

    # A checkpoint with two distant rects pending, resumed into a new
    # session: its next solve() equals the original's, bit for bit.
    s_inc.set_color_key(2)
    s_inc.paint(*at(0.26, 0.28))
    s_inc.paint(*at(0.78, 0.79))
    ck = f"{tmp}/session.npz"
    t0 = time.perf_counter()
    s_inc.save_checkpoint(ck)
    ck_save_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    resumed = DepthSession(lrgb, icfg, device="cuda")
    resumed.load_checkpoint(ck)
    ck_load_ms = (time.perf_counter() - t0) * 1e3
    if resumed.dirty_rects != s_inc.dirty_rects or len(resumed.dirty_rects) != 2:
        raise AssertionError(f"the pending rects came back as {resumed.dirty_rects}")
    results = []
    for sess in (s_inc, resumed):
        ops.reset_launch_counts()
        u8 = sess.solve()
        results.append((u8, {k: v for k, v in ops.launch_counts().items() if v}))
        live_launches.update(results[-1][1])
    if results[0][1] != results[1][1] or not np.array_equal(results[0][0], results[1][0]):
        raise AssertionError(f"the resumed solve differs: launches {results[1][1]} against "
                             f"{results[0][1]}")
    err = max([require_equal(torch, "resumed effect", resumed.artistic, s_inc.artistic)]
              + [require_equal(torch, f"resumed state L{lv}", a, b)
                 for lv, (a, b) in enumerate(zip(resumed.depth_state, s_inc.depth_state))])
    live["checkpoint"] = {"bytes": os.path.getsize(ck), "save_ms": ck_save_ms,
                          "resume_ms": ck_load_ms, "launches": results[1][1],
                          "max_abs_err": err}
    print(f"checkpoint with 2 rects pending: {json.dumps(live['checkpoint'])}; the resumed "
          f"session's next solve() equals the original's")

    # run_gui under --live through a scripted stand-in for cv2 (no display
    # here, and cv2 need not be installed): a drag on one tick is drained
    # and painted before the next tick's solve.
    class ScriptedCv2:
        EVENT_MOUSEMOVE, EVENT_LBUTTONDOWN, EVENT_LBUTTONUP = 0, 1, 4

        def __init__(self, ticks):
            self.ticks, self.tick, self.cb, self.shown, self.stamps = ticks, 0, None, [], []

        def namedWindow(self, name):
            pass

        def setMouseCallback(self, name, cb):
            self.cb = cb if name == "Edited Image" else self.cb

        def imshow(self, name, img):
            self.shown.append((self.tick, name, img.shape))

        def waitKey(self, ms):
            self.stamps.append(time.perf_counter())
            if self.tick >= len(self.ticks):
                return 27
            events, key = self.ticks[self.tick]
            self.tick += 1
            for ev, x, y in events:
                self.cb(ev, x, y, 0, None)
            return key

        def destroyAllWindows(self):
            pass

    gx, gy = at(0.62, 0.19)
    stroke = ([(ScriptedCv2.EVENT_LBUTTONDOWN, gx, gy)]
              + [(ScriptedCv2.EVENT_MOUSEMOVE, gx + 4 * i, gy) for i in range(10)]
              + [(ScriptedCv2.EVENT_LBUTTONUP, gx + 40, gy)])
    fake = ScriptedCv2([([], 255), (stroke, 255), ([], 255), ([], 255), ([], 27)])
    drained = []
    real_inc = s_inc.pipe.solve_incremental_and_effect

    def spy_inc(*a, **kw):
        drained.append((s_inc.solve_count, bool(s_inc.mask_np[gy, gx + 20])))
        return real_inc(*a, **kw)

    s_inc.pipe.solve_incremental_and_effect = spy_inc
    queues = []

    class SpyQueue(native_rt.EventQueue):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            queues.append(self)

    ops.reset_launch_counts()
    n0 = s_inc.solve_count
    sys.modules["cv2"] = fake
    try:
        with mock.patch.object(native_rt, "EventQueue", SpyQueue):
            rc = live_gui.run_gui(s_inc, live=True)
    finally:
        del sys.modules["cv2"]
    gui_counts = {k: v for k, v in ops.launch_counts().items() if v}
    live_launches.update(gui_counts)
    if rc != 0 or s_inc.solve_count - n0 != 5:
        raise AssertionError(f"run_gui returned {rc} after {s_inc.solve_count - n0} solves, not 5")
    if drained != [(n0 + 2, True)]:
        raise AssertionError(f"the drag was not painted before its tick's solve: {drained}")
    if not (len(queues) == 1 and queues[0]._closed and queues[0].lib is not None):
        raise AssertionError("run_gui's event queue was not the native one, or stayed open")
    if not torch.equal(s_inc.depth0[gy, gx:gx + 37].cpu(),  # the drag's events
                       torch.full((37,), float(s_inc.scribble_color))):
        raise AssertionError("the drag's pixels are not pinned after the GUI loop")
    tick_ms = [(b - a) * 1e3 for a, b in zip(fake.stamps, fake.stamps[1:])]
    live["gui"] = {"ticks": len(tick_ms), "tick_ms": tick_ms, "launches": gui_counts,
                   "windows": sorted({n for _, n, _ in fake.shown})}
    print(f"run_gui --live, {len(tick_ms)} ticks (drain, handle_key's solve, edited_image and "
          f"the readbacks; host clock): {json.dumps(live['gui'])}")
    tmp_live.cleanup()
    live["launches"] = dict(live_launches)
    print(json.dumps({"live": live}))
    phase_done("10 (the live session)")

    # -- 11. serving: the directory server, its watch mode, the warmup, the examples ----
    import contextlib
    import importlib.util
    import io as pyio
    import shutil
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import realtimedepthdiffusion_tpu_torch.pipeline as pipeline_mod
    from realtimedepthdiffusion_tpu_torch import serve, warmup

    srv = {"codec": port_io.codec()}
    serve_launches = collections.Counter()
    tmp_srv = tempfile.TemporaryDirectory()
    sd = tmp_srv.name
    n_pairs = 8
    for sub in ("images", "annotations"):
        os.makedirs(f"{sd}/{sub}")

    def write_scene(i):
        img = photo_like(np.random.default_rng(SEED + 100 + i), H, W)
        m, v = dense_scribbles(H, W)
        port_io.imwrite(f"{sd}/images/p{i}.png", img, png_level=1)
        port_io.save_annotation(f"{sd}/annotations/p{i}.png", m, v)
        return img, m, v

    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as ex:
        scenes = list(ex.map(write_scene, range(n_pairs)))
    srv["write_pairs_s"] = time.perf_counter() - t0
    pairs = serve.discover_pairs(f"{sd}/images", f"{sd}/annotations")
    if [os.path.basename(p) for p, _ in pairs] != [f"p{i}.png" for i in range(n_pairs)]:
        raise AssertionError(f"discover_pairs found {pairs}")

    # What each pair's PNGs must hold: DepthPipeline.solve_and_effect on the
    # same inputs, read back on the host.
    vpipe = DepthPipeline(H, W, cfg, device="cuda")
    want_png = []
    for img, m, v in scenes:
        v_rgb, v_gp = vpipe.prepare_image(img)
        d, _, out = vpipe.solve_and_effect(fx.EFFECT_DEFOCUS, v_gp, v_rgb,
                                           torch.from_numpy(m).to(dev),
                                           torch.from_numpy(v).to(dev), vpipe.initial_state())
        want_png.append((vpipe.depth_u8(d).cpu().numpy(), vpipe.depth_u16(d).cpu().numpy(),
                         out.cpu().numpy()))

    def read_png16(path):
        """A 16-bit gray PNG's pixels: by Pillow where the codec is Pillow's
        (the zlib codec unfilters Paeth rows in Python, seconds a 1080p
        map), else by ``png_decode``."""
        if port_io.codec() == "pil":
            from PIL import Image

            with Image.open(path) as im:
                if im.mode not in ("I;16", "I;16B", "I"):
                    raise AssertionError(f"{path}: a {im.mode} PNG, not 16-bit gray")
                return np.asarray(im).astype(np.uint16)
        with open(path, "rb") as f:
            return port_io.png_decode(f.read())

    suffixes = ("_depth.png", "_depth16.png", "_effect.png")

    def check_outputs(name, out_dir, idx):
        """Each pair's three PNGs decoded against its frame."""
        for i in idx:
            u8, u16, art = want_png[i]
            if not (np.array_equal(port_io.imread_gray(f"{out_dir}/p{i}_depth.png"), u8)
                    and np.array_equal(read_png16(f"{out_dir}/p{i}_depth16.png"), u16)
                    and np.array_equal(port_io.imread_rgb(f"{out_dir}/p{i}_effect.png"), art)):
                raise AssertionError(f"{name}: the PNGs of pair {i} differ from "
                                     f"DepthPipeline.solve_and_effect")

    def same_files(name, out_dir, idx, checked_dir):
        """Each pair's three PNGs byte for byte those of ``checked_dir``,
        which ``check_outputs`` decoded: the same pixels through the same
        encoder at the same level."""
        for i in idx:
            for suffix in suffixes:
                with open(f"{out_dir}/p{i}{suffix}", "rb") as f1, \
                        open(f"{checked_dir}/p{i}{suffix}", "rb") as f2:
                    if f1.read() != f2.read():
                        raise AssertionError(f"{name}: p{i}{suffix} differs from the checked "
                                             f"run's, so from the pipeline's frame")

    def counted():
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        serve_launches.update(counts)
        return counts

    # solve_pairs as rtdd-serve-torch --effect b --depth16 --png-level 1
    # runs it, asynchronous (the default) and strictly sequential. The host
    # time of each solve_and_effect call (its ~400 launches enqueued, no
    # wait) shows what the IO threads take from the dispatching thread.
    runs = {}
    dispatch_ms = []

    class TimedPipeline(pipeline_mod.DepthPipeline):
        def solve_and_effect(self, *a, **kw):
            t = time.perf_counter()
            out = super().solve_and_effect(*a, **kw)
            dispatch_ms.append((time.perf_counter() - t) * 1e3)
            return out

    for mode, kw in (("async", {"io_workers": 4, "prefetch": 2}),
                     ("sequential", {"io_workers": 1, "prefetch": 0})):
        stats = {}
        dispatch_ms.clear()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        with mock.patch.object(pipeline_mod, "DepthPipeline", TimedPipeline):
            written = serve.solve_pairs(pairs, f"{sd}/{mode}", cfg, fx.EFFECT_DEFOCUS,
                                        png_level=1, depth16=True, stats_out=stats, device="cuda",
                                        **kw)
        wall = time.perf_counter() - t0
        counts = counted()
        want = {k: n_pairs * v for k, v in want_frame.items()}
        if counts != want:
            raise AssertionError(f"serve {mode}: {n_pairs} pairs launched {counts}, not {want}")
        if len(written) != n_pairs or not all(written):
            raise AssertionError(f"serve {mode} wrote {written}")
        if mode == "async":
            check_outputs(f"serve {mode}", f"{sd}/{mode}", range(n_pairs))
        else:
            same_files(f"serve {mode}", f"{sd}/{mode}", range(n_pairs), f"{sd}/async")
        solve_s = [stats[p] for p, _ in pairs]
        runs[mode] = {"images_per_s": n_pairs / wall, "wall_s": wall, "first_solve_s": solve_s[0],
                      "median_solve_s": float(np.median(solve_s)), "solve_s": solve_s,
                      "median_dispatch_ms": float(np.median(dispatch_ms)),
                      "dispatch_ms": list(dispatch_ms), "launches_per_pair": dict(want_frame)}
        print(f"serve {mode} ({kw}): {n_pairs} {H}x{W} pairs, --effect b --depth16 --png-level 1: "
              f"{json.dumps(runs[mode])}; every PNG equal to the pipeline's frame")
    # The async run once more under the profiler: its device time over the
    # unprofiled run's wall is the card's busy share while it serves.
    runs["async"]["traced"] = traced("serve async", lambda: serve.solve_pairs(
        pairs, f"{sd}/traced", cfg, fx.EFFECT_DEFOCUS, png_level=1, depth16=True, device="cuda"),
        runs["async"]["wall_s"] * 1e3)
    srv["solve_pairs"] = runs

    # --profile fast on two pairs; the launches by the exit log of each solve.
    fast_logs = []

    class LoggedPipeline(pipeline_mod.DepthPipeline):
        def solve_and_effect(self, *a, **kw):
            fast_logs.append([])
            return super().solve_and_effect(*a, exit_log=fast_logs[-1], **kw)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with mock.patch.object(pipeline_mod, "DepthPipeline", LoggedPipeline):
        written = serve.solve_pairs(pairs[:2], f"{sd}/fast", fast_cfg, fx.EFFECT_DEFOCUS,
                                    png_level=1, device="cuda")
    fast_wall = time.perf_counter() - t0
    counts = counted()
    want = collections.Counter(defocus_box=len(fast_logs))
    for log in fast_logs:
        for e in log:
            chunks = exit_chunks(e, fast_cfg.residual_check_every)
            if rb_sweep.rb_resident_fits(*e["shape"]):
                want["rb_sweep_resident"] += len(chunks)
            else:
                want["rb_sweep_tiles"] += sum(-(-n // rb_sweep.RB_TILE_ITERS) for n in chunks)
    if len(fast_logs) != 2 or not all(written) or counts != dict(want):
        raise AssertionError(f"serve --profile fast: {len(fast_logs)} solves launched {counts}, "
                             f"not {dict(want)} by the exit log")
    srv["fast"] = {"pairs": 2, "wall_s": fast_wall, "launches": counts,
                   "iterations": [[e["iters"] for e in log] for log in fast_logs]}
    print(f"serve --profile fast: {json.dumps(srv['fast'])}")

    # --multichip --batch 4 on the 8-slot mesh of phase 7: six pairs, so the
    # second step carries two pads.
    mc_pairs = pairs[:6]
    stats = {}
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    written = serve.solve_pairs_multichip(mc_pairs, f"{sd}/multichip", cfg, fx.EFFECT_DEFOCUS,
                                          batch=4, mesh=mesh8, png_level=1, depth16=True,
                                          stats_out=stats, device="cuda")
    mc_wall = time.perf_counter() - t0
    counts = counted()
    want = {k: 2 * v for k, v in want_step.items()}
    if counts != want or len(written) != len(mc_pairs):
        raise AssertionError(f"serve --multichip: launched {counts}, not {want}; wrote {written}")
    same_files("serve --multichip", f"{sd}/multichip", range(len(mc_pairs)), f"{sd}/async")
    srv["multichip"] = {"pairs": len(mc_pairs), "batch": 4, "mesh": mesh8.shape,
                        "wall_s": mc_wall, "images_per_s": len(mc_pairs) / mc_wall,
                        "batch_ms": [stats[mc_pairs[0][0]] * 4e3, stats[mc_pairs[4][0]] * 2e3],
                        "launches": counts}
    print(f"serve --multichip --batch 4 on {mesh8}: {json.dumps(srv['multichip'])}; depth, "
          f"depth16 and defocus equal to the single-device frames")

    # --watch on a thread: three pairs and a broken p0.jpg that shares p0.png's
    # stem; p1's annotation touched after the first batch.
    wd, wout, wrep = f"{sd}/inbox", f"{sd}/watch", f"{sd}/watch.json"
    for sub in ("images", "annotations"):
        os.makedirs(f"{wd}/{sub}")
        for i in range(3):
            shutil.copy(f"{sd}/{sub}/p{i}.png", f"{wd}/{sub}/p{i}.png")
    with open(f"{wd}/images/p0.jpg", "wb") as f:
        f.write(b"not a jpeg")
    watch_res = {}

    def run_watch():
        try:
            watch_res["rc"] = serve.main([
                "--images", f"{wd}/images", "--annotations", f"{wd}/annotations", "--out", wout,
                "--watch", "--poll-interval", "0.2", "--idle-exit", "1.5", "--effect", "b",
                "--depth16", "--png-level", "1", "--report", wrep, "--device", "cuda"])
        except BaseException as e:  # handed to the main thread, which raises it
            watch_res["error"] = e

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    th = threading.Thread(target=run_watch)
    th.start()
    deadline = time.monotonic() + 120
    while not all(os.path.exists(f"{wout}/p{i}_depth.png") for i in range(3)):
        if time.monotonic() > deadline or not th.is_alive():
            break
        time.sleep(0.05)
    time.sleep(0.5)
    os.utime(f"{wd}/annotations/p1.png")
    th.join(timeout=120)
    watch_wall = time.perf_counter() - t0
    if th.is_alive():
        raise AssertionError("serve --watch did not exit on --idle-exit")
    if "error" in watch_res:
        raise watch_res["error"]
    counts = counted()
    want = {k: 4 * v for k, v in want_frame.items()}
    with open(wrep) as f:
        rep = json.load(f)
    status = {os.path.basename(e["image"]): e["status"] for e in rep["pairs"]}
    if watch_res["rc"] != 1 or counts != want or status != {
            "p0.jpg": "failed", "p0.png": "solved", "p1.png": "solved", "p2.png": "solved"}:
        raise AssertionError(f"serve --watch: rc {watch_res['rc']}, launches {counts} (not "
                             f"{want}), manifest {status}")
    if rep["config"]["device"] != "cuda":
        raise AssertionError(f"serve --watch manifest: {rep['config']}")
    same_files("serve --watch", wout, range(3), f"{sd}/async")  # p0's survived p0.jpg's give-up
    srv["watch"] = {"wall_s": watch_wall, "rc": watch_res["rc"], "status": status,
                    "solve_s": {os.path.basename(e["image"]): e.get("solve_s")
                                for e in rep["pairs"]}, "launches": counts}
    print(f"serve --watch: {json.dumps(srv['watch'])}; p1 re-solved after its touch, "
          f"p0.png's outputs kept when p0.jpg was given up")

    # rtdd-warmup-torch at 1080p and 4K, with the defocus and the incremental path.
    buf = pyio.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = warmup.main(["--size", "1080p", "--size", "4k", "--effect", "b",
                          "--incremental", "120"])
    warm_wall = time.perf_counter() - t0
    print(buf.getvalue(), end="")
    counts = counted()
    warm = collections.defaultdict(dict)
    for line in buf.getvalue().splitlines():
        m_ = re.fullmatch(r"  (\d+x\d+) (\S+): ([0-9.]+) s", line)
        if m_:
            warm[m_.group(1)][m_.group(2)] = float(m_.group(3))
    e_ = fx.EFFECT_DEFOCUS
    want_names = {"build", "gray_pyramid", "solve", "depth_u8", "depth_u16", f"solve+effect[{e_}]",
                  f"effect[{e_}]", "incremental", f"incremental+effect[{e_}]"}
    if rc != 0 or set(warm) != {f"{H}x{W}", f"{H4}x{W4}"} or any(
            set(v) != want_names for v in warm.values()):
        raise AssertionError(f"warmup returned {rc} and timed {dict(warm)}")
    if not all(counts.get(k) for k in ("jc_sweep_tiles", "jc_sweep_resident", "jc_sweep_fused",
                                       "defocus_box")):
        raise AssertionError(f"warmup launched {counts}")
    srv["warmup"] = {"wall_s": warm_wall, "seconds": dict(warm), "launches": counts}

    # The examples, each once on the card, on a 540x960 pair.
    ex_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "realtimedepthdiffusion_tpu_torch", "examples")
    ed = f"{sd}/example"
    for sub in ("images", "annotations"):
        os.makedirs(f"{ed}/{sub}")
    port_io.imwrite(f"{ed}/images/e.png", photo_like(np.random.default_rng(SEED + 200), 540, 960),
                    png_level=1)
    port_io.save_annotation(f"{ed}/annotations/e.png", *dense_scribbles(540, 960))
    examples = {}
    for name, argv, check in (
            ("01_depth_and_effects", ["--image", f"{ed}/images/e.png", "--annotation",
                                      f"{ed}/annotations/e.png", "--out", f"{ed}/01"],
             lambda r: r.shape == (540, 960) and np.isfinite(r).all()),
            ("02_warm_edits", ["--image", f"{ed}/images/e.png"],
             lambda r: r.shape == (540, 960) and r.dtype == np.uint8),
            ("03_batch_serving", ["--images", f"{ed}/images", "--annotations",
                                  f"{ed}/annotations", "--out", f"{ed}/03"],
             lambda r: len(r) == 1 and os.path.exists(r[0])),
            ("04_multichip", ["--slots", "8"],
             lambda r: r.shape == (2, 128, 192) and np.isfinite(r).all())):
        spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                      os.path.join(ex_dir, f"{name}.py"))
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        result = module.main(argv)
        torch.cuda.synchronize()
        counts = counted()
        if not counts or not check(result):
            raise AssertionError(f"example {name}: launched {counts}, returned {type(result)}")
        examples[name] = {"s": time.perf_counter() - t0, "launches": counts}
    srv["examples"] = examples
    tmp_srv.cleanup()
    srv["launches"] = dict(serve_launches)
    print(json.dumps({"serve": srv}))
    phase_done("11 (serving)")

    # -- 8. device time alone ----------------------------------------------------------
    device_ms = {label: graph_ms(torch, fn, 5) for label, fn in device_only.items()}
    print(f"device time alone (launches replayed from a CUDA graph, median ms): "
          f"{json.dumps(device_ms)}")
    phase_done("8 (device time alone)")

    px0, px4, px4k = H * W, int(gray_pyr[L].numel()), H4 * W4

    def k3_device(prefix):
        """K3's device ms by route, of the cases whose name starts so."""
        return {k.split(" route ")[1]: v for k, v in device_ms.items() if k.startswith(prefix)}

    def bounded(entry, n_bytes, n_ops, n_int=0):
        entry["bound_ms"], entry["bound_by"] = bound(n_bytes, n_ops, n_int)
        entry["library_ms"] = None  # no PyTorch call computes a per-pixel-weight stencil
        return entry

    kernels = [
        bounded({"name": "jc_sweep_tiles", "route": "cuda",
                 "source": "realtimedepthdiffusion_tpu_torch/csrc/sweep.cu",
                 "replaces": f"{TPU_SWEEP}:298",
                 "also_replaces": [f"{TPU_SWEEP}:546", f"{TPU_SWEEP}:210", f"{TPU_SWEEP}:1936"],
                 "launches": launches["jc_sweep_tiles"],
                 "max_abs_err": max(k1_l0["max_abs_err"], k1_l1["max_abs_err"], k1_k),
                 "ms": k1_l0["ms"], "plain_ms": k1_l0["plain_ms"],
                 "device_ms": device_ms["K1 L0"], "l1_ms": k1_l1["ms"],
                 "l1_device_ms": device_ms["K1 L1"], "tiles_ms": k1_tiles,
                 "halo_launches": step_launches["jc_sweep_tiles"],
                 "halo_max_abs_err": max(b_k1["max_abs_err"], step_err),
                 "halo_ms": b_k1["ms"], "halo_plain_ms": b_k1["plain_ms"],
                 "halo_stack16_ms": b_k1["stack16_ms"],
                 "halo_stack16_bound_ms": b_k1["stack16_bound_ms"],
                 "incremental_launches": inc_launches["jc_sweep_tiles"],
                 "vcycle_launches": v_launches["jc_sweep_tiles"],
                 "window": dict(windows[0], device_ms=device_ms["window L0"])},
                px0 * 29, px0 * k1_l0["sweeps"] * JC_OPS),
        bounded({"name": "jc_sweep_resident", "route": "cuda",
                 "source": "realtimedepthdiffusion_tpu_torch/csrc/sweep.cu",
                 "replaces": f"{TPU_SWEEP}:111", "launches": launches["jc_sweep_resident"],
                 "max_abs_err": max(v["max_abs_err"] for v in k2.values()),
                 "ms": k2["L4"]["ms"], "plain_ms": k2["L4"]["plain_ms"],
                 "max_cluster": max_cluster,
                 "incremental_launches": inc_launches["jc_sweep_resident"],
                 "vcycle_launches": v_launches["jc_sweep_resident"],
                 "window": dict(windows[1], device_ms=device_ms["window L1"]),
                 "by_level": {n: {key: v[key] for key in ("shape", "sweeps", "cluster", "ms",
                                                          "bound_ms", "k1_ms")}
                              for n, v in k2.items()}},
                px4 * 29, px4 * k2["L4"]["sweeps"] * JC_OPS),
        bounded({"name": "defocus_box", "route": "cuda",
                 "source": "realtimedepthdiffusion_tpu_torch/csrc/defocus.cu",
                 "replaces": f"{TPU_DEFOCUS}:234",
                 "also_replaces": [f"{TPU_DEFOCUS}:126", f"{TPU_DEFOCUS}:49",
                                   f"{TPU_DEFOCUS}:569"],
                 "launches": launches["defocus_box"],
                 "incremental_launches": inc_launches["defocus_box"],
                 "vcycle_launches": v_launches["defocus_box"],
                 "max_abs_err": max(k3_dci, k3_wide["max_abs_err"], k3_uhd["max_abs_err"],
                                    *(v["max_abs_err"] for v in k3.values())),
                 "ms": k3["exact"]["ms"]["None"], "plain_ms": k3["exact"]["plain_ms"],
                 "device_ms": k3_device(f"K3 exact {H}x{W} max_half {max_half} ")["None"],
                 "route_taken": list(k3_route),
                 "by_route_ms": k3["exact"]["ms"], "by_route_device_ms": k3_device(f"K3 exact {H}x{W} max_half {max_half} "),
                 "approx_ms": k3["approx"]["ms"], "approx_device_ms": k3_device(f"K3 approx {H}x{W} max_half {max_half} "),
                 # The two torch.cumsum calls that give the table alone: a
                 # yardstick for the scan stage, not for the function.
                 "sat_library_ms": k3_sat_library_ms,
                 "wide_max_half": wide_half, "wide_ms": k3_wide["ms"]["None"],
                 "wide_device_ms": k3_device(f"K3 exact {H}x{W} max_half {wide_half}")["None"],
                 "wide_plain_ms": k3_wide["plain_ms"],
                 "uhd_route_taken": list(k3_uhd_route), "uhd_ms": k3_uhd["ms"],
                 "uhd_device_ms": k3_device(f"K3 approx {H4}x{W4}"),
                 "uhd_plain_ms": k3_uhd["plain_ms"],
                 "halo_launches": step_launches["defocus_block"],
                 "halo_max_abs_err": max(step_err, *(b["max_abs_err"] for b in b_k3.values())),
                 "halo_route_taken": list(defocus.defocus_route(ew - 1)),
                 "halo_ms": b_k3[(hb, wb, None)]["ms"],
                 "halo_plain_ms": b_k3[(hb, wb, None)]["plain_ms"],
                 "halo_by_route_device_ms": k3_device(f"K3 block ({hb}, {wb}) "),
                 "uhd_by_max_half_device_ms": {k[len("K3 sweep "):]: v for k, v in device_ms.items()
                                               if k.startswith("K3 sweep ")},
                 "all_blurred_device_ms": {k[len("K3 all-blurred "):]: v
                                           for k, v in device_ms.items()
                                           if k.startswith("K3 all-blurred ")}},
                px0 * 10, *k3_ops(px0, px0, True)),
        dict(b_k3[(hb, wb, None)], name="defocus_block", route="cuda",
             source="realtimedepthdiffusion_tpu_torch/csrc/defocus.cu",
             replaces=f"{TPU_DEFOCUS}:569", launches=step_launches["defocus_block"],
             device_ms=device_ms[f"K3 block ({hb}, {wb}) route None"], library_ms=None,
             border_ms=b_k3[(0, 0, None)]["ms"]),
        bounded({"name": "rb_sweep_tiles", "route": "cuda",
                 "source": "realtimedepthdiffusion_tpu_torch/csrc/rb_sweep.cu",
                 "replaces": f"{TPU_SWEEP}:1327",
                 "also_replaces": [f"{TPU_SWEEP}:1256", f"{TPU_SWEEP}:1491", f"{TPU_SWEEP}:1957"],
                 "launches": fast_launches["rb_sweep_tiles"],
                 "max_abs_err": max(k4_l0["max_abs_err"], k4_l1["max_abs_err"]),
                 "ms": k4_l0["ms"], "plain_ms": k4_l0["plain_ms"],
                 "device_ms": device_ms["K4 L0"], "l1_ms": k4_l1["ms"],
                 "l1_device_ms": device_ms["K4 L1"], "tiles_ms": k4_tiles,
                 "tiles_device_ms": {k: v for k, v in device_ms.items() if " tile " in k},
                 "halo_launches": fast_halo["rb_sweep_tiles"],
                 "halo_max_abs_err": max(k4_stack_err, *(b["max_abs_err"] for b in b_k4.values())),
                 "halo_ms": b_k4[1]["ms"], "halo_plain_ms": b_k4[1]["plain_ms"],
                 "halo_stack4_ms": k4_stack_ms, "halo_stack4_bound_ms": k4_stack_bound},
                px0 * 21, px0 * k4_l0["iterations"] * RB_OPS),
        bounded({"name": "rb_sweep_resident", "route": "cuda",
                 "source": "realtimedepthdiffusion_tpu_torch/csrc/rb_sweep.cu",
                 "replaces": f"{TPU_SWEEP}:1209", "launches": fast_launches["rb_sweep_resident"],
                 "max_abs_err": max(k5["max_abs_err"], k5["split_max_abs_err"]),
                 "ms": k5["ms"], "plain_ms": k5["plain_ms"], "device_ms": device_ms["K5 L4"],
                 "cta": k5["cta"],
                 "chunk_device_ms": {k: v for k, v in device_ms.items()
                                     if k.startswith("K5 L4 chunk")},
                 "k4_ms": k5["k4_ms"], "k4_device_ms": device_ms["K4 on K5's L4"]},
                px4 * 21, px4 * k5["iterations"] * RB_OPS),
        bounded({"name": "jc_sweep_fused", "route": "cuda",
                 "source": "realtimedepthdiffusion_tpu_torch/csrc/fused_sweep.cu",
                 "replaces": f"{TPU_SWEEP}:394", "launches": launches4["jc_sweep_fused"],
                 "max_abs_err": max(k6_l0["max_abs_err"], k6_l1["max_abs_err"]),
                 "ms": k6_ms, "plain_ms": k6_l0["plain_ms"],
                 "by_k_ms": {k: v for k, v in k6_l0.items() if k.startswith("ms_k")},
                 "device_ms": device_ms[f"K6 4K L0 k={fused_sweep.FUSED_SWEEPS}"],
                 "by_k_device_ms": {k: v for k, v in device_ms.items()
                                    if k.startswith("K6 4K L0 k=")},
                 "k1_device_ms": device_ms["K1 on K6 4K L0"],
                 "k1_ms": k6_l0["k1_ms"], "k1_with_weights_ms": k6_l0["k1_with_weights_ms"]},
                px4k * 15, px4k * (k6_l0["sweeps"] * JC_OPS + K6_DERIVE_OPS)),
    ]
    for k in kernels:  # the launches of phase 10's CLI, live updates, resume and GUI ticks
        k["session_launches"] = live_launches[k["name"]]
        k["serve_launches"] = serve_launches[k["name"]]  # phase 11's
    print(f"frames: default {frame['ms']:.3f} ms (plain {frame['plain_ms']:.3f}), "
          f"fast {fast_frame['ms']:.3f} ms (plain {fast_frame['plain_ms']:.3f}), "
          f"4K {frame4['ms']:.3f} ms (plain {frame4['plain_ms']:.3f}), "
          f"sharded 1080p step of 4 {np.median(step_ms):.3f} ms, "
          f"incremental {inc_line['incremental_ms']:.3f} ms beside a full frame's "
          f"{inc_line['full_ms']:.3f}, V-cycle {v_line['frame_ms']:.3f} ms (polish "
          f"{v_line['polish_ms']:.3f}) on {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
