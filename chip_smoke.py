#!/usr/bin/env python3
"""The port's kernel table on one NVIDIA GPU (an H100): each hand-written
kernel alone against its plain torch version, with its time and its bound.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits non-zero:

1. Requires a CUDA device and prints the card's name and power limit.
2. Builds the port's CUDA kernels from ``realtimedepthdiffusion_tpu_torch/csrc``.
3. Holds each kernel against its plain version on the card, at the shapes
   the main paths give it, with inputs from a numpy seed, and times both:
   K1 on 1080p L0 and L1 (and under four more CTA shapes, and at k=1
   against its default k); K2 on 1080p L4, L3 and L2 and 4K L3, each beside
   K1 on the same level, on every cluster the card runs and at the plan's
   sweeps per exchange against one exchange a sweep; K4 on L0 and L1 (and
   under its CTA shapes at k = 2, 4 and 8) and K5 on L4 with the red-black
   omegas, whole and in chunks from a base, beside K4 on the same level; the
   early exit's probe on L0 and on a 384x384 window, both metrics, timed
   live and after the exit; K3 exact and approx at 1080p on both of its
   routes (tiles, each with its table in shared memory, or a table of the
   whole image) and past the tile route's limit, beside the two
   ``torch.cumsum`` calls that give the table alone; K6 at 4K L0 and at the
   L1 shape at k = 1, 8, 12 and 16, beside K1; K3 approx at 4K on both
   routes, by max_half on every route that holds it and on all-blurred
   input, and at DCI 4K (2160x4096), where a whole image's summed-area
   table passes 2^31 - 1; the TPU-only variants the port maps onto K1 and K3
   (state prefetch, stacked and coldiff defocus), each equal to the default
   output; the sharded step's block routes at the 1080p blocks' shapes (K1
   on a halo block and on a stack of 16, K4 with parity 0 and 1 and on a
   stack of 4 of mixed parities, K3 on blocks with an origin), each also
   against the same pixels of the whole-image route; and K1 and K2 (and K4)
   on the incremental re-solve's 384x384 L0 and 192x192 L1 windows, with
   the frozen ring in the mask and the weights of the crop, at an inside
   origin and at clamped corners. Every comparison is exact (max abs
   difference 0), but the probe's rms residual (within 1e-5: the kernel sums
   its squares in float64). Times are CUDA-event medians as the host
   launches each kernel, and the device time alone, its launches captured
   once into a CUDA graph and replayed, so that the host paces nothing
   between them.
4. Runs once each main path, on ``benchmark/gen.py``'s inputs, and counts
   its launches from zero: a default 1080p frame (which must launch K2 x3,
   K1 x24, K3 x1); a live session of each of the benchmark's session
   configurations (``benchmark/configs/faithful_1080p``, ``fast_1080p``,
   ``faithful_4k``), its first update, first stroke and the stroke after;
   the server over two 1080p pairs (a frame's launches a pair); and the
   sharded 1080p step of 4 images on the slot mesh (2, 2, 2).

The line before the last is a JSON object of the kernels, each with its
largest difference from its plain version, its time, its device time, its
plain version's time, its bound (the least time the card could take for
the same work, from the bytes it must move and the operations it must do,
at the card's published peaks), the time of a PyTorch call computing the
same function (null: none exists) and its launches on each path of phase 4.
The last line is ``{"ok": true, "device": {...}}``.

Whole frames, sessions, the server and the program layer's graphs are held
on the card by ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py``, and timed from the user's side by
``benchmark/`` (``python3 benchmark/run.py --workload <cell>``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
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
# The probe (csrc/probe.cu): 5 multiplies, 3 adds, the clamp's 2 compares,
# the subtract, the square and its float64 add.
PROBE_OPS = 13
# Probe launches in each graph whose replay times the probe's device time
# alone: one launch of a few
# microseconds lies below what a replay's own launch costs.
PROBE_GRAPH_LAUNCHES = 100
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


def bench_scribbles(h, w):
    """The scribble layout of bench.py: five 40x60 blocks at depths 0..254."""
    mask = np.zeros((h, w), bool)
    value = np.zeros((h, w), np.uint8)
    for i, d in enumerate((0, 64, 128, 192, 254)):
        y, x = 120 + 180 * i, 200 + 320 * i
        mask[y:y + 40, x:x + 60] = True
        value[y:y + 40, x:x + 60] = d
    return mask, value


def add_scribble(mask, value):
    """The scribble added before the second solve of the windows' scene."""
    mask[900:940, 1500:1560] = True
    value[900:940, 1500:1560] = 96


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
    from realtimedepthdiffusion_tpu_torch.core import incremental, solver
    from realtimedepthdiffusion_tpu_torch.core.annotation import seed_depth
    from realtimedepthdiffusion_tpu_torch.core.color import rgb_to_gray
    from realtimedepthdiffusion_tpu_torch.core.multigrid import (
        build_annotation_pyramids, build_gray_pyramid)
    from realtimedepthdiffusion_tpu_torch.core.solver import abc_schedule, rb_omegas
    from realtimedepthdiffusion_tpu_torch.core.weights import edge_weights
    from realtimedepthdiffusion_tpu_torch.ops import (build, defocus, dispatch, fused_sweep,
                                                      probe, rb_sweep, sweep)
    from realtimedepthdiffusion_tpu_torch.parallel import sharded

    mark = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print(f"phase {name}: {now - mark[0]:.2f} s")
        mark[0] = now

    # Work whose device time alone is taken at the end of phase 3, by graph
    # replay.
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

    # -- 3. the kernels against their plain versions ---------------------------
    cfg = DiffusionConfig()
    rng = np.random.default_rng(SEED)
    rgb_np = seeded_image(rng, H, W)
    gray_pyr = build_gray_pyramid(rgb_to_gray(torch.from_numpy(rgb_np).to(dev)), cfg)
    n_levels = len(gray_pyr)
    L = n_levels - 1

    def level_case(gp, level, r=rng):
        h, w = gp[level].shape
        field = r.random((h // 8 + 2, w // 8 + 2)) * 255.0
        depth = np.kron(field, np.ones((8, 8)))[:h, :w].astype(np.float32)
        mask = r.random((h, w)) < 0.02
        value = r.integers(0, 255, (h, w)).astype(np.uint8)
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
            def launch(u_in, p_in, u_out, p_out, b, n_active, stop=None):
                sweep.jc_sweep_tiles(u_in, p_in, u_out, p_out, *planes, abc_d, b, n_active, k,
                                     tile, stop)
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
        # K2 at the rule's sweeps per exchange against one exchange a sweep
        # (one thread row, as before ghost rows), on the route's cluster.
        want_k2 = sweep.solve_level_cuda(depth_t, mask_t, wts, abc)
        line["by_s_ms"] = {}
        for plan in (sweep.resident_plan(*depth_t.shape, cluster, len(abc)),
                     (1, sweep.RESIDENT_ROWS)):
            state = (depth_t.clone(), torch.zeros_like(depth_t))
            run_s = lambda: sweep.jc_sweep_resident(  # noqa: E731
                *state, *planes, abc_d, 0, len(abc), cluster, plan=plan)
            run_s()
            require_equal(torch, f"K2 {name} at s={plan[0]}", state[0], want_k2)
            line["by_s_ms"][f"s={plan[0]}, {plan[1]} rows a thread"] = time_ms(torch, run_s, 10)
        k2[name] = line
        print(f"K2 {name} {tuple(gp[level].shape)}: {line['ms']:.3f} ms on a cluster of {cluster}, "
              f"K1 {line['k1_ms']:.3f} ms; K2 by cluster size {json.dumps(line['by_cluster_ms'])}; "
              f"by sweeps per exchange {json.dumps(line['by_s_ms'])}")

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

    # The early exit's probe (csrc/probe.cu) against its plain version on
    # 1080p L0 and on a 384x384 window of it, both metrics: the same flag
    # and counts, the rms residual within 1e-5 (its squares summed in
    # float64 against torch's float32), the max exact. Timed live (the flag
    # clear, tol 0: it never stops) and after the exit (the flag set: one
    # launch whose blocks return), as the host launches it and replayed from
    # a graph of PROBE_GRAPH_LAUNCHES launches (per launch), beside
    # the plain version; bound: u, the five weight planes and the mask read
    # once, 25 bytes a pixel.
    def check_probe(name, gp):
        depth_t, mask_t, wts, _ = level_case(gp, 0, np.random.default_rng(SEED + 18))
        h, w = depth_t.shape
        m8 = mask_t.to(torch.uint8)
        planes = (wts.wl, wts.wr, wts.wu, wts.wd, wts.inv_count)
        scratch = probe.probe_scratch(h, w, dev)

        def flags(stop=0):
            return (torch.full((), stop, dtype=torch.int32, device=dev),
                    torch.zeros(2, dtype=torch.int32, device=dev), torch.zeros(1, device=dev))

        def kernel(metric, tol, fl):
            return lambda: probe.residual_probe(depth_t, *planes, m8, 25, 0, tol, metric, *fl,
                                                *scratch)

        def plain(metric, tol, fl):
            return lambda: probe.probe_plain(depth_t, mask_t, wts, metric, 25, 0, tol, *fl)

        line = {"shape": [h, w], "max_rel_err": 0.0}
        for metric in probe.METRICS:
            res = float(probe.residual_plain(depth_t, mask_t, wts, metric))
            for tol in (res * 0.5, res * 2.0):
                got, want = flags(), flags()
                kernel(metric, tol, got)()
                plain(metric, tol, want)()
                torch.cuda.synchronize()
                rel = abs(float(got[2]) - float(want[2])) / float(want[2])
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                        and rel <= (1e-5 if metric == "rms" else 0.0)):
                    raise AssertionError(f"probe {name} {metric} at tol {tol}: kernel "
                                         f"{[t.tolist() for t in got]}, plain "
                                         f"{[t.tolist() for t in want]}")
                line["max_rel_err"] = max(line["max_rel_err"], rel)
        live, dead = flags(), flags(1)
        line["ms"] = time_ms(torch, kernel("rms", 0.0, live), 20)
        line["dead_ms"] = time_ms(torch, kernel("rms", 0.0, dead), 20)
        line["plain_ms"] = time_ms(torch, plain("rms", 0.0, flags()), 10)
        if int(live[0]) or int(dead[1][1]):
            raise AssertionError(f"probe {name}: the live probe stopped or the dead one counted")
        def many(fn):
            return lambda: [fn() for _ in range(PROBE_GRAPH_LAUNCHES)]

        device_only[f"probe {name}"] = many(kernel("rms", 0.0, live))
        device_only[f"probe {name} after the exit"] = many(kernel("rms", 0.0, dead))
        device_only[f"probe {name} plain"] = many(plain("rms", 0.0, flags()))
        line["bound_ms"], line["bound_by"] = bound(25 * h * w, PROBE_OPS * h * w)
        print(f"probe {name}: {json.dumps(line)}")
        return line

    probe_l0 = check_probe("L0", gray_pyr)
    probe_win = check_probe("window 384", [gray_pyr[0][300:684, 500:884].contiguous()]
                            + list(gray_pyr[1:]))

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

    # The scene the windows below are cut from: three solves of the image
    # under bench.py's scribbles, one more scribble added before the second,
    # as a user's first edits leave a session.
    pipe = DepthPipeline(H, W, cfg, device="cuda")
    _, gpyr = pipe.prepare_image(rgb_np)
    mask_np, value_np = bench_scribbles(H, W)
    state = pipe.initial_state()
    for i in range(3):
        if i == 1:
            add_scribble(mask_np, value_np)
        mask_d = torch.from_numpy(mask_np).to(dev)
        value_d = torch.from_numpy(value_np).to(dev)
        _, state = pipe.solve(gpyr, mask_d, value_d, state)
    # The inputs below follow a 181x243 image in the generator's order: it is
    # drawn and dropped, so that every row keeps the inputs PERF.md's table
    # was measured on.
    seeded_image(rng, 181, 243)

    # K6, on the 4K levels past the L2, beside K1.
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

    rgb4_d = torch.from_numpy(rgb4_np).to(dev)
    max_half4 = cfg.defocus_kernel_size(H4, W4) // 2

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
    # on every route that holds it (their device times alone), and the
    # 1080p and 4K apertures on an all-blurred input (depth 255: every tile scans
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

    # The sharded step's block routes, at the 1080p blocks of mesh (2, 2, 2).
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

    # The windows of the incremental re-solve, cut from the scene's last
    # depth state and annotation: K1 and K2 at shapes no whole level gives
    # them.
    icfg = DiffusionConfig(incremental_iterations=120)
    win_masks, _ = build_annotation_pyramids(mask_d, value_d, icfg)
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

    # The device time alone of every case above.
    device_ms = {label: graph_ms(torch, fn, 5) for label, fn in device_only.items()}
    print(f"device time alone (launches replayed from a CUDA graph, median ms): "
          f"{json.dumps(device_ms)}")
    phase_done("3 (the kernel table)")

    # -- 4. launches on the main paths -------------------------------------------
    # Each path the benchmark's cells and the server take, run once on the
    # benchmark's generators, its launches counted from zero: the kernels'
    # launches per run. tests/test_torch_cuda.py holds the same paths to
    # their plain versions and to the routes' tallies.
    from benchmark import gen
    from realtimedepthdiffusion_tpu_torch import io, serve
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.live.session import DepthSession
    from realtimedepthdiffusion_tpu_torch.parallel.mesh import make_mesh

    runs = {}

    def counted(path, fn):
        """Run ``fn`` with the launch counts set to zero; keep its launches."""
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        runs[path] = {k: v for k, v in ops.launch_counts().items() if v}
        print(f"launches, {path}: {json.dumps(runs[path])}")
        if not runs[path]:
            raise AssertionError(f"{path}: no kernel launched")
        return out

    def on_card(*planes):
        return [torch.from_numpy(p).to(dev) for p in planes]

    # A default 1080p frame: K2 on L4-L2, K1 on L1-L0, K3 once.
    frame = {"jc_sweep_resident": 3, "jc_sweep_tiles": 24, "defocus_box": 1}
    rgb, mask, value = gen.pair(SEED, 0, H, W)
    fpipe = DepthPipeline(H, W, cfg, device="cuda")
    rgb_d, gp = fpipe.prepare_image(rgb)
    counted("1080p frame", lambda: fpipe.solve_and_effect(
        fx.EFFECT_DEFOCUS, gp, rgb_d, *on_card(mask, value), fpipe.initial_state()))
    if runs["1080p frame"] != frame:
        raise AssertionError(f"a default 1080p frame launched {runs['1080p frame']}, not {frame}")
    del fpipe, gp

    # A live session of each session cell's configuration: its first
    # update, the first stroke (the windowed path's gate is closed: a full
    # re-solve and the gate's kick) and the stroke after it.
    for cell, rows, cols in (("faithful_1080p", H, W), ("fast_1080p", H, W),
                             ("faithful_4k", H4, W4)):
        with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmark",
                               "configs", f"{cell}.json")) as f:
            ccfg = DiffusionConfig(**json.load(f)["diffusion"])
        rgb, mask, value = gen.pair(SEED, 1, rows, cols)
        s = DepthSession(rgb, ccfg, device="cuda")
        s.mask_np[:], s.value_np[:] = mask, value
        s.mark_all_dirty()
        s.set_effect_key("b")
        counted(f"{cell} session, first update", s.solve)
        for i, label in enumerate(("first stroke", "stroke")):
            s.set_color_key(2 + i)
            for dx in range(0, 12, 2):
                s.paint(cols // 3 + i * cols // 3 + dx, rows // 2)
            counted(f"{cell} session, {label}", s.solve)
        if cell.startswith("fast") and {"jc_sweep_tiles", "jc_sweep_resident"} & {
                k for path, c in runs.items() if path.startswith(cell) for k in c}:
            raise AssertionError(f"the {cell} session launched a Jacobi kernel")
        del s

    # The server over two 1080p pairs: a default frame's launches a pair.
    with tempfile.TemporaryDirectory() as tmp:
        for sub in ("images", "annotations"):
            os.mkdir(os.path.join(tmp, sub))
        for k in range(2):
            rgb, mask, value = gen.pair(SEED, 2 + k, H, W)
            io.imwrite(os.path.join(tmp, "images", f"p{k}.png"), rgb)
            io.save_annotation(os.path.join(tmp, "annotations", f"p{k}.png"), mask, value)
        pairs = serve.discover_pairs(os.path.join(tmp, "images"), os.path.join(tmp, "annotations"))
        written = counted("serve, 2 1080p pairs", lambda: serve.solve_pairs(
            pairs, os.path.join(tmp, "out"), cfg, fx.EFFECT_DEFOCUS, device="cuda"))
    if len(written) != 2 or not all(written) or runs["serve, 2 1080p pairs"] != {
            k: 2 * v for k, v in frame.items()}:
        raise AssertionError(f"serve wrote {written}, launched {runs['serve, 2 1080p pairs']}")

    # The sharded step of 4 images on the slot mesh (2, 2, 2) of the card.
    step, make_args = sharded.batched_step(make_mesh(8, device="cuda"), H, W, cfg,
                                           fx.EFFECT_DEFOCUS)
    rgb_b, m_b, v_b = (torch.from_numpy(np.stack(a)).to(dev)
                       for a in zip(*(gen.pair(SEED, 4 + k, H, W) for k in range(4))))
    counted("sharded 1080p step of 4", lambda: step(rgb_b, m_b, v_b, make_args(4)[3]))
    del step, rgb_b, m_b, v_b
    phase_done("4 (launches on the main paths)")

    px0, px4, px4k = H * W, int(gray_pyr[L].numel()), H4 * W4

    def k3_device(prefix):
        """K3's device ms by route, of the cases whose name starts so."""
        return {k.split(" route ")[1]: v for k, v in device_ms.items() if k.startswith(prefix)}

    def probe_device(name):
        """The probe's device ms per launch, live, after the exit and plain."""
        return {f"{key}device_ms": device_ms[f"probe {name}{suffix}"] / PROBE_GRAPH_LAUNCHES
                for key, suffix in (("", ""), ("dead_", " after the exit"), ("plain_", " plain"))}

    def bounded(entry, n_bytes, n_ops, n_int=0):
        entry["bound_ms"], entry["bound_by"] = bound(n_bytes, n_ops, n_int)
        entry["library_ms"] = None  # no PyTorch call computes a per-pixel-weight stencil
        return entry

    kernels = [
        bounded({"name": "jc_sweep_tiles", "route": "cuda",
                 "source": "realtimedepthdiffusion_tpu_torch/csrc/sweep.cu",
                 "replaces": f"{TPU_SWEEP}:298",
                 "also_replaces": [f"{TPU_SWEEP}:546", f"{TPU_SWEEP}:210", f"{TPU_SWEEP}:1936"],
                 "max_abs_err": max(k1_l0["max_abs_err"], k1_l1["max_abs_err"], k1_k),
                 "ms": k1_l0["ms"], "plain_ms": k1_l0["plain_ms"],
                 "device_ms": device_ms["K1 L0"], "l1_ms": k1_l1["ms"],
                 "l1_device_ms": device_ms["K1 L1"], "tiles_ms": k1_tiles,
                 "halo_max_abs_err": b_k1["max_abs_err"],
                 "halo_ms": b_k1["ms"], "halo_plain_ms": b_k1["plain_ms"],
                 "halo_stack16_ms": b_k1["stack16_ms"],
                 "halo_stack16_bound_ms": b_k1["stack16_bound_ms"],
                 "window": dict(windows[0], device_ms=device_ms["window L0"])},
                px0 * 29, px0 * k1_l0["sweeps"] * JC_OPS),
        bounded({"name": "jc_sweep_resident", "route": "cuda",
                 "source": "realtimedepthdiffusion_tpu_torch/csrc/sweep.cu",
                 "replaces": f"{TPU_SWEEP}:111",
                 "max_abs_err": max(v["max_abs_err"] for v in k2.values()),
                 "ms": k2["L4"]["ms"], "plain_ms": k2["L4"]["plain_ms"],
                 "max_cluster": max_cluster,
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
                 "halo_max_abs_err": max(b["max_abs_err"] for b in b_k3.values()),
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
             replaces=f"{TPU_DEFOCUS}:569",
             device_ms=device_ms[f"K3 block ({hb}, {wb}) route None"], library_ms=None,
             border_ms=b_k3[(0, 0, None)]["ms"]),
        bounded({"name": "rb_sweep_tiles", "route": "cuda",
                 "source": "realtimedepthdiffusion_tpu_torch/csrc/rb_sweep.cu",
                 "replaces": f"{TPU_SWEEP}:1327",
                 "also_replaces": [f"{TPU_SWEEP}:1256", f"{TPU_SWEEP}:1491", f"{TPU_SWEEP}:1957"],
                 "max_abs_err": max(k4_l0["max_abs_err"], k4_l1["max_abs_err"]),
                 "ms": k4_l0["ms"], "plain_ms": k4_l0["plain_ms"],
                 "device_ms": device_ms["K4 L0"], "l1_ms": k4_l1["ms"],
                 "l1_device_ms": device_ms["K4 L1"], "tiles_ms": k4_tiles,
                 "tiles_device_ms": {k: v for k, v in device_ms.items() if " tile " in k},
                 "halo_max_abs_err": max(k4_stack_err, *(b["max_abs_err"] for b in b_k4.values())),
                 "halo_ms": b_k4[1]["ms"], "halo_plain_ms": b_k4[1]["plain_ms"],
                 "halo_stack4_ms": k4_stack_ms, "halo_stack4_bound_ms": k4_stack_bound},
                px0 * 21, px0 * k4_l0["iterations"] * RB_OPS),
        bounded({"name": "rb_sweep_resident", "route": "cuda",
                 "source": "realtimedepthdiffusion_tpu_torch/csrc/rb_sweep.cu",
                 "replaces": f"{TPU_SWEEP}:1209",
                 "max_abs_err": max(k5["max_abs_err"], k5["split_max_abs_err"]),
                 "ms": k5["ms"], "plain_ms": k5["plain_ms"], "device_ms": device_ms["K5 L4"],
                 "cta": k5["cta"],
                 "chunk_device_ms": {k: v for k, v in device_ms.items()
                                     if k.startswith("K5 L4 chunk")},
                 "k4_ms": k5["k4_ms"], "k4_device_ms": device_ms["K4 on K5's L4"]},
                px4 * 21, px4 * k5["iterations"] * RB_OPS),
        dict(probe_l0, name="residual_probe", route="cuda",
             source="realtimedepthdiffusion_tpu_torch/csrc/probe.cu",
             replaces=None,  # the JAX package leaves the probe to XLA
             library_ms=None,
             **probe_device("L0"), window=dict(probe_win, **probe_device("window 384"))),
        bounded({"name": "jc_sweep_fused", "route": "cuda",
                 "source": "realtimedepthdiffusion_tpu_torch/csrc/fused_sweep.cu",
                 "replaces": f"{TPU_SWEEP}:394",
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
    for entry in kernels:
        entry["launches"] = {path: c[entry["name"]] for path, c in runs.items()
                             if entry["name"] in c}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
