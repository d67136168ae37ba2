#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and exits non-zero:

1. Requires a CUDA device and prints the card's name and power limit.
2. Builds the port's CUDA kernels from ``realtimedepthdiffusion_tpu_torch/csrc``.
3. Holds each kernel against its plain torch version on the card, at the
   shapes the 1080p main path gives it, with inputs from a numpy seed:
   K1 on L0 and L1 and at k=1 against its default k, K2 on L4, K3 exact and
   approx. Every comparison must be exact (max abs difference 0).
4. Drives the main path: ``DepthPipeline(1080, 1920, device="cuda")`` and
   three ``solve_and_effect(EFFECT_DEFOCUS, ...)`` updates with a scribble
   added before the second. Checks finite depth, exact scribbles, the
   output's shape and type, that every kernel launched, that a frame equals
   the same frame computed by the plain versions on the card, and that a
   small solve on the card agrees with the CPU's.

The line before the last is a JSON object of the kernels; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

H, W = 1080, 1920
SEED = 0
TPU_SWEEP = "realtimedepthdiffusion_tpu/ops/pallas_sweep.py"
TPU_DEFOCUS = "realtimedepthdiffusion_tpu/ops/pallas_defocus.py"


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
        mask[y : y + 40, x : x + 60] = True
        value[y : y + 40, x : x + 60] = d
    return mask, value


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

    from realtimedepthdiffusion_tpu_torch import DepthPipeline, DiffusionConfig, ops
    from realtimedepthdiffusion_tpu_torch.core import effects as fx
    from realtimedepthdiffusion_tpu_torch.core.annotation import seed_depth
    from realtimedepthdiffusion_tpu_torch.core.color import rgb_to_gray
    from realtimedepthdiffusion_tpu_torch.core.multigrid import (
        build_annotation_pyramids, build_gray_pyramid)
    from realtimedepthdiffusion_tpu_torch.core.pyramid import pyr_up
    from realtimedepthdiffusion_tpu_torch.core.solver import abc_schedule
    from realtimedepthdiffusion_tpu_torch.core.weights import edge_weights
    from realtimedepthdiffusion_tpu_torch.ops import build, defocus, sweep

    # -- 1. the card ---------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc {build.build_seconds} s) "
          f"-> {build.library_path().name}")
    for line in build.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())

    # -- 3. kernels against their plain versions --------------------------------
    cfg = DiffusionConfig()
    rng = np.random.default_rng(SEED)
    rgb_np = seeded_image(rng, H, W)
    gray_pyr = build_gray_pyramid(rgb_to_gray(torch.from_numpy(rgb_np).to(dev)), cfg)
    n_levels = len(gray_pyr)
    L = n_levels - 1

    def level_case(level):
        h, w = gray_pyr[level].shape
        field = rng.random((h // 8 + 2, w // 8 + 2)) * 255.0
        depth = np.kron(field, np.ones((8, 8)))[:h, :w].astype(np.float32)
        mask = rng.random((h, w)) < 0.02
        value = rng.integers(0, 255, (h, w)).astype(np.uint8)
        depth_t = seed_depth(torch.from_numpy(depth).to(dev), torch.from_numpy(mask).to(dev),
                             torch.from_numpy(value).to(dev))
        mask_t = torch.from_numpy(mask).to(dev)
        wts = edge_weights(gray_pyr[level], depth_t, level, L, cfg)
        abc = abc_schedule(cfg.level_iterations(n_levels, level), cfg)
        return depth_t, mask_t, wts, abc

    def check_level(name, level, kernel_name, timed=False):
        depth_t, mask_t, wts, abc = level_case(level)
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
            line["plain_ms"] = time_ms(torch, lambda: sweep.solve_level_plain(depth_t, mask_t, wts, abc), 3)
        print(f"{name}: {json.dumps(line)}")
        return line

    k1_l0 = check_level("K1 L0", 0, "jc_sweep_tiles", timed=True)
    k1_l1 = check_level("K1 L1", 1, "jc_sweep_tiles", timed=True)
    # Jacobi gives the same result whatever the blocking: k=1 against the
    # default k checks the halo logic.
    depth_t, mask_t, wts, abc = level_case(1)
    one = sweep.solve_level_cuda(depth_t, mask_t, wts, abc, k=1)
    dflt = sweep.solve_level_cuda(depth_t, mask_t, wts, abc)
    torch.cuda.synchronize()
    k1_k = require_equal(torch, "K1 k=1 vs default k", one, dflt)
    print(f"K1 L1 k=1 vs k={sweep.TILE_SWEEPS}: max_abs_err {k1_k}")
    if not sweep.resident_fits(*gray_pyr[L].shape):
        raise AssertionError(f"L4 {tuple(gray_pyr[L].shape)} does not fit K2")
    k2 = check_level("K2 L4", L, "jc_sweep_resident", timed=True)

    ramp = np.linspace(0.0, 255.0, W, dtype=np.float32)[None, :].repeat(H, 0)
    ramp = np.clip(ramp + rng.normal(0.0, 6.0, (H, W)).astype(np.float32), 0.0, 255.0)
    depth_fx = torch.from_numpy(ramp).to(dev)
    rgb_t = torch.from_numpy(rgb_np).to(dev)
    halves = torch.unique(defocus.defocus_half_widths(depth_fx, H, W, cfg)).tolist()
    max_half = cfg.defocus_kernel_size(H, W) // 2
    if halves != list(range(max_half + 1)):
        raise AssertionError(f"K3 depth covers halves {halves}, not 0..{max_half}")
    k3 = {}
    for quality in ("exact", "approx"):
        qcfg = DiffusionConfig(pallas_defocus_quality=quality)
        got = defocus.defocus_box(rgb_t, depth_fx, qcfg)
        want = defocus.defocus_sat(rgb_t, depth_fx, qcfg)
        torch.cuda.synchronize()
        err = require_equal(torch, f"K3 {quality}", got, want)
        k3[quality] = {
            "max_abs_err": err,
            "ms": time_ms(torch, lambda: defocus.defocus_box(rgb_t, depth_fx, qcfg), 20),
            "plain_ms": time_ms(torch, lambda: defocus.defocus_sat(rgb_t, depth_fx, qcfg), 5),
        }
        print(f"K3 {quality} {H}x{W} max_half {max_half}: {json.dumps(k3[quality])}")

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
            mask_np[900:940, 1500:1560] = True
            value_np[900:940, 1500:1560] = 96
        mask_d = torch.from_numpy(mask_np).to(dev)
        value_d = torch.from_numpy(value_np).to(dev)
        depth0, state, out = pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, mask_d,
                                                   value_d, state)
        frames.append((depth0, out, mask_d, value_d))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    print(f"main path: 3 frames in {wall:.3f} s, launches {json.dumps(launches)}")
    for name, n in launches.items():
        if n == 0:
            raise AssertionError(f"main path never launched {name}")
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
    # kernel path's bit for bit: same glue, kernels equal to their twins.
    _, _, mask_d, value_d = frames[2]

    def plain_frame(st):
        masks, values = build_annotation_pyramids(mask_d, value_d, cfg)
        st = list(st)
        st[L] = seed_depth(st[L], masks[L], values[L])
        for level in range(L, -1, -1):
            wts = edge_weights(gpyr[level], st[level], level, L, cfg)
            abc = abc_schedule(cfg.level_iterations(n_levels, level), cfg)
            st[level] = sweep.solve_level_plain(st[level], masks[level], wts, abc)
            if level > 0:
                up = pyr_up(st[level], tuple(gpyr[level - 1].shape))
                st[level - 1] = seed_depth(up, masks[level - 1], values[level - 1])
        out = defocus.defocus_sat(rgb_d, torch.clamp(st[0], 0.0, 255.0), cfg)
        return st[0], tuple(st), out

    def kernel_frame(st):
        return pipe.solve_and_effect(fx.EFFECT_DEFOCUS, gpyr, rgb_d, mask_d, value_d, st)

    warm = state
    k_depth, _, k_out = kernel_frame(warm)
    p_depth, _, p_out = plain_frame(warm)
    torch.cuda.synchronize()
    frame_err = max(require_equal(torch, "frame depth", k_depth, p_depth),
                    require_equal(torch, "frame effect", k_out, p_out))
    frame_ms = time_ms(torch, lambda: kernel_frame(warm), 10)
    plain_frame_ms = time_ms(torch, lambda: plain_frame(warm), 3)
    print(f"frame {H}x{W} solve+defocus: kernels {frame_ms:.3f} ms, plain {plain_frame_ms:.3f} ms "
          f"per frame (CUDA events, median); kernel frame == plain frame "
          f"(max abs diff {frame_err})")

    # A small solve on the card against the CPU's plain path, which the CPU
    # tests hold against the JAX package. exp differs between the two
    # devices in the last bits, so the bar is the repo's RMSE <= 1e-3.
    hs, ws = 181, 243
    srgb = seeded_image(rng, hs, ws)
    smask, svalue = bench_scribbles(hs * 8, ws * 8)
    smask, svalue = smask[::8, ::8].copy(), svalue[::8, ::8].copy()
    depths = []
    for device in ("cuda", "cpu"):
        sp = DepthPipeline(hs, ws, cfg, device=device)
        _, sg = sp.prepare_image(srgb)
        d, _ = sp.solve(sg, torch.from_numpy(smask).to(device), torch.from_numpy(svalue).to(device),
                        sp.initial_state())
        depths.append(d.cpu().numpy())
    rmse = float(np.sqrt(np.mean(((depths[0] - depths[1]) / 255.0) ** 2)))
    print(f"small solve {hs}x{ws}: card vs CPU depth RMSE {rmse:.3e} (bar 1e-3)")
    if not rmse <= 1e-3:
        raise AssertionError(f"small solve: card vs CPU RMSE {rmse} > 1e-3")

    kernels = [
        {"name": "jc_sweep_tiles", "route": "cuda",
         "source": "realtimedepthdiffusion_tpu_torch/csrc/sweep.cu",
         "replaces": f"{TPU_SWEEP}:298", "launches": launches["jc_sweep_tiles"],
         "max_abs_err": max(k1_l0["max_abs_err"], k1_l1["max_abs_err"], k1_k),
         "ms": k1_l0["ms"], "plain_ms": k1_l0["plain_ms"]},
        {"name": "jc_sweep_resident", "route": "cuda",
         "source": "realtimedepthdiffusion_tpu_torch/csrc/sweep.cu",
         "replaces": f"{TPU_SWEEP}:111", "launches": launches["jc_sweep_resident"],
         "max_abs_err": k2["max_abs_err"], "ms": k2["ms"], "plain_ms": k2["plain_ms"]},
        {"name": "defocus_box", "route": "cuda",
         "source": "realtimedepthdiffusion_tpu_torch/csrc/defocus.cu",
         "replaces": f"{TPU_DEFOCUS}:234", "launches": launches["defocus_box"],
         "max_abs_err": max(v["max_abs_err"] for v in k3.values()),
         "ms": k3["exact"]["ms"], "plain_ms": k3["exact"]["plain_ms"]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
