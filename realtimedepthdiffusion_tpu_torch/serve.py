"""Offline batch serving (port of ``realtimedepthdiffusion_tpu/serve.py``):
solve depth maps for many (image, annotation) pairs, on the card unless
the caller asks for the CPU.

The reference is a strictly interactive desktop app; this module is the
framework's production-serving face: shape-bucketed pipelines, an optional
data-parallel + spatially-sharded multi-device path
(``parallel.sharded.batched_step``), and PNG export per pair.

    python -m realtimedepthdiffusion_tpu_torch.serve \\
        --pairs img1.png:ann1.png img2.png:ann2.png --out out/ [--effect h]

or directory mode (images matched to annotations by stem):

    python -m realtimedepthdiffusion_tpu_torch.serve \\
        --images dataset/images --annotations dataset/annotations --out out/

Multi-device mode (--multichip [--batch B]) drives the batched step over a
slot mesh of one slot per card (``parallel.mesh.make_mesh(device=...)``; on
one card a batch over one slot): pairs are shape-bucketed, assembled into
fixed-size batches (the last one padded), and each batch is one step.

Watch mode (--watch) turns the batch runner into a long-lived service: the
directories are polled (--poll-interval) and any new pair, or a pair whose
image or annotation mtime changed, is solved as it appears. Per-shape
pipelines stay resident across batches:

    python -m realtimedepthdiffusion_tpu_torch.serve \\
        --images inbox/images --annotations inbox/annotations \\
        --out out/ --watch [--idle-exit 300] [--report manifest.json]

The flags, messages and exit codes are the JAX server's, plus ``--device``
(cuda, the default; cuda:N; or cpu). Asking for a card where there is none
raises. ``--backend`` is parsed and validated, and routes nothing: the
device picks the kernels or their plain versions. The build cache of the
kernels is ``utils/cache.py``'s; eager torch compiles nothing ahead, so
there is no background compile to turn off.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .config import VALID_RESIDUAL_METRICS, DiffusionConfig
from .core import effects as fx
from .io import (
    depth_to_u8,
    depth_to_u16,
    image_size,
    imread_rgb,
    imwrite,
    load_annotation,
)

_EFFECT_BY_KEY = {"b": fx.EFFECT_DEFOCUS, "g": fx.EFFECT_DESATURATION, "h": fx.EFFECT_HAZE}


def device_arg(v: str) -> str:
    """argparse type of ``--device``: cpu, cuda or cuda:N, as the live CLI
    takes it."""
    from .live.cli import _is_device

    v = v.lower()
    if not _is_device(v):
        raise argparse.ArgumentTypeError(f"unknown --device {v!r} (choose from cuda, cuda:N, cpu)")
    return v


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises for a card where none is
    visible (nothing moves to the CPU by itself)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} asked for, but no CUDA device is visible")
    return dev


def discover_pairs(images_dir: str, annotations_dir: str) -> List[Tuple[str, str]]:
    """Match images to annotations by filename stem (the dataset layout,
    SURVEY.md C21)."""
    anns = {}
    for f in os.listdir(annotations_dir):
        stem, ext = os.path.splitext(f)
        if ext.lower() in (".png", ".jpg", ".jpeg"):
            anns[stem] = os.path.join(annotations_dir, f)
    pairs = []
    for f in sorted(os.listdir(images_dir)):
        stem, ext = os.path.splitext(f)
        if ext.lower() in (".png", ".jpg", ".jpeg") and stem in anns:
            pairs.append((os.path.join(images_dir, f), anns[stem]))
    return pairs


def _stem(path: str) -> str:
    return os.path.splitext(os.path.basename(path))[0]


def _outputs_done(a, img_path: str) -> bool:
    """True when EVERY output the run was asked for already exists in
    a.out — a resume that adds --effect (or --depth16) must re-solve pairs
    missing that output, not skip them on the depth PNG alone."""
    stem = _stem(img_path)
    if not os.path.exists(os.path.join(a.out, f"{stem}_depth.png")):
        return False
    if a.depth16 and not os.path.exists(
        os.path.join(a.out, f"{stem}_depth16.png")
    ):
        return False
    return not a.effect or os.path.exists(
        os.path.join(a.out, f"{stem}_effect.png")
    )


def _upload(arr: np.ndarray, dev: torch.device) -> torch.Tensor:
    """A host array on ``dev``. To a card it goes through pinned memory
    without waiting: a pageable copy would wait for the card to finish the
    pair before. (A decoder's read-only array is copied: torch takes
    writable arrays only.)"""
    t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
    if dev.type == "cuda":
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def _start_readback(tensors, dev: torch.device):
    """Start copying ``tensors`` (None entries pass through) to the host;
    returns (host tensors, event). On a card the copies go into pinned
    buffers without waiting, behind an event that ``event.synchronize()``
    waits on; on the CPU the tensors are already there and the event is
    None."""
    if dev.type != "cuda":
        return list(tensors), None
    host = []
    for t in tensors:
        if t is not None:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            t = h
        host.append(t)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(dev))
    return host, event


def solve_pairs(
    pairs: List[Tuple[str, str]],
    out_dir: str,
    cfg: DiffusionConfig = DiffusionConfig(),
    effect: Optional[int] = None,
    progress=None,
    io_workers: int = 4,
    prefetch: int = 2,
    keep_going: bool = False,
    png_level: Optional[int] = None,
    depth16: bool = False,
    stats_out: Optional[Dict[str, float]] = None,
    pipelines: Optional[Dict[Tuple[int, int], "DepthPipeline"]] = None,
    *,
    device="cuda",
) -> List[Optional[str]]:
    """Solve every pair on ``device``; returns the written depth-map paths
    in input order. One ``DepthPipeline`` per distinct image shape (shape
    bucketing). A long-running service can pass its own ``pipelines`` dict
    to keep the per-shape pipelines (and their device state) alive across
    calls instead of building them per batch.

    ``stats_out``, when given a dict, receives per-pair device latency in
    seconds keyed by image path: wall time from the pair's device work
    starting (pipeline build + image upload + solve dispatch) to the
    completed readback of its outputs. The first pair of a shape charges
    that shape's pipeline (and, in a fresh process, the kernels' build or
    load). Duplicate-stem losers (whose readback is skipped, last-wins)
    record no entry.

    ``depth16=True`` additionally writes ``{stem}_depth16.png`` — a 16-bit
    PNG at the solver's full precision (io.depth_to_u16), converted on
    device like the u8 map.

    ``keep_going=True`` turns per-pair host-IO failures (corrupt PNG,
    annotation/image shape mismatch, unwritable output) into a stderr
    warning and a ``None`` entry instead of aborting the whole run mid-way.
    Device errors still raise: they would affect every pair.

    The host IO rides an async pipeline: ``io_workers`` threads decode up
    to ``prefetch``+1 pairs ahead, and the readback of a solved pair is
    deferred until the next solve is dispatched: on a card its outputs are
    copied into pinned host buffers behind an event, and its device
    tensors are kept alive until that event is waited on. PNG encodes run
    on the same thread pool. Only this (the dispatching) thread touches the
    device; the pool decodes and encodes numpy arrays. ``prefetch=0,
    io_workers=1`` degrades to the strictly sequential order of
    operations. Outputs are bit-identical either way.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from .pipeline import DepthPipeline

    dev = require_device(device)
    os.makedirs(out_dir, exist_ok=True)
    pipes: Dict[Tuple[int, int], DepthPipeline] = (
        pipelines if pipelines is not None else {}
    )
    n = len(pairs)
    written: List[Optional[str]] = [None] * n
    io_workers = max(int(io_workers), 1)
    prefetch = max(int(prefetch), 0)
    # Output paths are keyed by stem; with threaded writes two pairs sharing
    # a stem could write the same file CONCURRENTLY (torn PNG). Preserve the
    # sequential loop's last-wins semantics: only the final occurrence of a
    # stem encodes; earlier duplicates just report the shared path.
    stems = [_stem(p) for p, _ in pairs]
    last_for_stem = {s: i for i, s in enumerate(stems)}

    with ThreadPoolExecutor(max_workers=io_workers) as pool:
        loads: deque = deque()  # (index, decode future)
        # (index, img_path, stem, device tensors, host tensors, event,
        # dispatch perf_counter)
        inflight: deque = deque()
        writes: deque = deque()  # (index, img_path, write future)
        # Duplicate-stem pairs don't encode (last-wins); their progress
        # callbacks fire only once the WINNING pair's PNG is on disk, so a
        # consumer that opens the reported path never sees a missing file.
        dup_waiters: Dict[int, List[Tuple[int, str]]] = {}
        failed: set = set()  # indices whose decode failed (keep_going only)
        next_load = 0

        def pump_loads():
            nonlocal next_load
            while next_load < n and len(loads) < prefetch + 1:
                img_path, ann_path = pairs[next_load]
                loads.append(
                    (next_load, pool.submit(_load_pair, img_path, ann_path, cfg))
                )
                next_load += 1

        def drain_solve():
            """Wait for the oldest solved pair's readback and hand it to a
            writer."""
            i, img_path, stem, _keep_alive, host, event, t_dispatch = inflight.popleft()
            if last_for_stem[stem] != i:
                if last_for_stem[stem] in failed:
                    # The stem's winning pair failed to decode (keep_going):
                    # this earlier duplicate's encode was going to be skipped
                    # in its favor — nothing will write the stem, so report
                    # nothing (re-running without the broken pair recovers).
                    print(
                        f"warning: {img_path}: skipped (duplicate of failed "
                        f"pair {pairs[last_for_stem[stem]][0]})",
                        file=sys.stderr,
                    )
                    return
                # A later pair writes this stem; skip the dead encode and
                # report the path the winner will write (last-wins). Progress
                # is deferred to the winner's write completion (drain order is
                # input order, so the winner always drains after this pair).
                written[i] = os.path.join(out_dir, f"{stem}_depth.png")
                dup_waiters.setdefault(last_for_stem[stem], []).append(
                    (i, img_path)
                )
                return
            if event is not None:
                event.synchronize()  # the pair's readback is complete
            if stats_out is not None:
                stats_out[img_path] = time.perf_counter() - t_dispatch
            depth_np, d16_np, art_np = (
                None if t is None else t.numpy() for t in host
            )

            def write():
                if art_np is not None:
                    imwrite(
                        os.path.join(out_dir, f"{stem}_effect.png"), art_np,
                        png_level=png_level,
                    )
                if d16_np is not None:
                    imwrite(
                        os.path.join(out_dir, f"{stem}_depth16.png"), d16_np,
                        png_level=png_level,
                    )
                dp = os.path.join(out_dir, f"{stem}_depth.png")
                imwrite(dp, depth_np, png_level=png_level)
                return dp

            writes.append((i, img_path, pool.submit(write)))

        def drain_writes(block: bool, keep: int = 0):
            while len(writes) > keep and (block or writes[0][2].done()):
                i, img_path, fut = writes.popleft()
                try:
                    written[i] = fut.result()
                except Exception as e:
                    if not keep_going:
                        raise
                    print(f"warning: {img_path}: write failed: {e}",
                          file=sys.stderr)
                    written[i] = None
                    for j, _p in dup_waiters.pop(i, ()):
                        written[j] = None
                    continue
                if progress:
                    progress(img_path, written[i])
                    for _j, dup_path in dup_waiters.pop(i, ()):
                        progress(dup_path, written[i])

        pump_loads()
        while loads:
            i, fut = loads.popleft()
            try:
                rgb, mask, value = fut.result()
            except Exception as e:
                if not keep_going:
                    raise
                print(f"warning: {pairs[i][0]}: skipped: {e}", file=sys.stderr)
                failed.add(i)
                # Duplicates that already deferred to this (now failed)
                # winner were never encoded — nothing owns their stem.
                for j, _p in dup_waiters.pop(i, ()):
                    written[j] = None
                pump_loads()
                continue
            pump_loads()  # keep the decode window full while we dispatch
            h, w = rgb.shape[:2]
            t_dispatch = time.perf_counter()  # charges pipeline build +
            # prepare + solve + readback (see stats_out docstring)
            if (h, w) in pipes and hasattr(pipes, "move_to_end"):
                # A long-lived service passes an OrderedDict so it can evict
                # least-recently-USED shapes (not least-recently-built);
                # record the use (see _trim_pipelines).
                pipes.move_to_end((h, w))
            if (h, w) not in pipes:
                pipes[(h, w)] = DepthPipeline(h, w, cfg, device=dev)
            pipe = pipes[(h, w)]
            rgb_d, gpyr = pipe.prepare_image(_upload(rgb, dev))
            state = pipe.initial_state()
            mask_d, value_d = _upload(mask, dev), _upload(value, dev)
            stem = stems[i]
            if effect is None:
                depth, _ = pipe.solve(gpyr, mask_d, value_d, state)
                art = None
            else:
                depth, _, art = pipe.solve_and_effect(
                    effect, gpyr, rgb_d, mask_d, value_d, state
                )
            # depth is converted to u8 ON DEVICE (pipe.depth_u8, bit-equal
            # to io.depth_to_u8): a 4x smaller readback than f32.
            outs = (pipe.depth_u8(depth),
                    pipe.depth_u16(depth) if depth16 else None, art)
            host, event = _start_readback(outs, dev)
            inflight.append((i, pairs[i][0], stem, outs, host, event, t_dispatch))
            # Keep up to min(prefetch, 2) solves in flight beyond the one
            # just queued: their readback overlaps the host dispatching
            # this one. prefetch=0 drains immediately (strictly sequential).
            while len(inflight) > min(prefetch, 2):
                drain_solve()
            drain_writes(block=False)
            # Bound host memory: if PNG encode is the bottleneck, block on
            # the oldest writes instead of accumulating encoded frames.
            drain_writes(block=True, keep=2 * io_workers + 4)
        while inflight:
            drain_solve()
        drain_writes(block=True)
    return written


def _load_pair(img_path: str, ann_path: str, cfg: DiffusionConfig):
    rgb = imread_rgb(img_path)
    mask, value = load_annotation(ann_path, cfg)
    h, w = rgb.shape[:2]
    if mask.shape != (h, w):
        raise ValueError(f"{ann_path}: shape {mask.shape} != image {(h, w)}")
    return rgb, mask, value


def solve_pairs_multichip(
    pairs: List[Tuple[str, str]],
    out_dir: str,
    cfg: DiffusionConfig = DiffusionConfig(),
    effect: Optional[int] = None,
    batch: Optional[int] = None,
    mesh=None,
    progress=None,
    keep_going: bool = False,
    png_level: Optional[int] = None,
    depth16: bool = False,
    io_workers: int = 4,
    stats_out: Optional[Dict[str, float]] = None,
    *,
    device="cuda",
) -> List[str]:
    """Multi-device batch serving: shape-buckets the pairs, then drives the
    data-parallel + spatially-sharded batched step (parallel/sharded.py)
    over the ('batch','dy','dx') slot mesh — one step solves a whole batch
    of images. ``mesh`` defaults to ``make_mesh(device=device)``, one slot
    per card. The last batch of a bucket is padded (by repeating its final
    pair) so every step of a shape takes the same batch; pad outputs are
    dropped. Per-pair depth and defocus equal the single-device path's
    bit for bit on the card.

    Host IO is async like the single-device path: ``io_workers`` pool
    threads decode the NEXT batch while the device runs the current one,
    and PNG encodes are submitted to the same pool, with the write backlog
    bounded so host memory stays ~two batches. Pixels are untouched by the
    pipelining (bit-identical outputs; only host scheduling changes).

    Duplicate stems keep the single-device last-wins contract: only the
    final occurrence of a stem (in input order) encodes; earlier duplicates
    report the winner's path once it is on disk.

    Returns the written depth-map paths in global input order.
    ``keep_going=True`` drops pairs whose decode fails (stderr warning)
    instead of aborting the run; a batch re-packs with the survivors.
    ``stats_out`` matches the single-device contract (see ``solve_pairs``),
    with each pair charged an equal share of its batch's dispatch-to-
    readback wall.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from .core.multigrid import initial_depth_state
    from .parallel import sharded
    from .parallel.mesh import make_mesh

    os.makedirs(out_dir, exist_ok=True)
    if mesh is None:
        mesh = make_mesh(device=device)
    home = mesh.home
    b_mesh = mesh.shape["batch"]
    if batch is None:
        batch = max(b_mesh, 1)
    batch = -(-max(batch, 1) // b_mesh) * b_mesh  # divisible by the mesh axis
    eff = fx.EFFECT_NONE if effect is None else effect
    io_workers = max(int(io_workers), 1)

    stems = [_stem(p) for p, _ in pairs]
    last_for_stem = {s: i for i, s in enumerate(stems)}

    # Shape-bucket by the image HEADER alone (io.image_size — no pixel
    # decode): host RAM is bounded at ~two decoded batches regardless of how
    # many thousand pairs are queued. Items carry their global input index
    # for the last-wins bookkeeping (a stem's winner may sit in another
    # bucket).
    buckets: Dict[Tuple[int, int], List[Tuple[int, str, str]]] = {}
    failed: set = set()  # global indices whose decode failed (keep_going)
    for i, (img_path, ann_path) in enumerate(pairs):
        try:
            size = image_size(img_path)
        except Exception as e:
            if not keep_going:
                raise
            print(f"warning: {img_path}: skipped: {e}", file=sys.stderr)
            failed.add(i)
            continue
        buckets.setdefault(size, []).append((i, img_path, ann_path))

    results: Dict[int, str] = {}
    writes: deque = deque()  # (global index, img_path, write future)
    # Non-winning duplicates waiting on the winner's write: winner index ->
    # [(dup index, dup img_path)]. Their progress fires only once the
    # winner's PNG is on disk (same contract as the single-device path).
    dup_waiters: Dict[int, List[Tuple[int, str]]] = {}

    def drain_writes(block: bool, keep: int = 0):
        while len(writes) > keep and (block or writes[0][2].done()):
            i, img_path, fut = writes.popleft()
            try:
                dp = fut.result()
            except Exception as e:
                if not keep_going:
                    raise
                print(f"warning: {img_path}: write failed: {e}",
                      file=sys.stderr)
                dup_waiters.pop(i, None)  # waiters report nothing
                continue
            results[i] = dp
            if progress:
                progress(img_path, dp)
            for j, dup_path in dup_waiters.pop(i, ()):
                results[j] = dp
                if progress:
                    progress(dup_path, dp)

    with ThreadPoolExecutor(max_workers=io_workers) as pool:
        for (h, w), items in buckets.items():
            fn, _ = sharded.batched_step(mesh, h, w, cfg, effect=eff)
            state0 = initial_depth_state(h, w, cfg, home)
            # One fresh state per bucket, broadcast over the batch as a view
            # (expand, not a copy): no route writes its input state, the
            # cascade reads only the coarsest level, through seed_depth's
            # torch.where, and builds every later state anew.
            state = tuple(s.expand((batch,) + tuple(s.shape)) for s in state0)
            starts = list(range(0, len(items), batch))

            def decode(chunk):
                # One future per pair (not pool.map: its iterator dies at the
                # first decode error, taking the rest of the batch with it).
                return [
                    (it, pool.submit(
                        lambda p: _load_pair(p[1], p[2], cfg), it
                    ))
                    for it in chunk
                ]

            def gather(futs):
                out = []
                for it, f in futs:
                    try:
                        out.append((it, f.result()))
                    except Exception as e:
                        if not keep_going:
                            raise
                        print(f"warning: {it[1]}: skipped: {e}",
                              file=sys.stderr)
                        failed.add(it[0])
                return out

            pending = decode(items[starts[0] : starts[0] + batch])
            for bi, lo in enumerate(starts):
                chunk = gather(pending)  # block for this batch's decodes
                if bi + 1 < len(starts):  # decode ahead (bounded: one batch)
                    lo2 = starts[bi + 1]
                    pending = decode(items[lo2 : lo2 + batch])
                if not chunk:  # every pair in the batch failed (keep_going)
                    continue
                n = len(chunk)
                fill = [chunk[-1]] * (batch - n)
                rgbs = np.stack([it[1][0][..., :3] for it in chunk + fill])
                masks = np.stack([it[1][1].astype(bool) for it in chunk + fill])
                values = np.stack([it[1][2] for it in chunk + fill])
                t_dispatch = time.perf_counter()
                depth, _, art = fn(
                    torch.from_numpy(rgbs).to(home), torch.from_numpy(masks).to(home),
                    torch.from_numpy(values).to(home), state,
                )
                depth_np = depth.cpu().numpy()
                art_np = art.cpu().numpy() if effect is not None else None
                if stats_out is not None:
                    # Batched dispatch: each RECORDED pair carries an equal
                    # share of the batch's dispatch-to-readback wall.
                    # Duplicate-stem losers record NO entry (single-device
                    # contract: no output of their own backs a latency), so
                    # the wall divides by the number of winners — recorded
                    # shares sum back to the batch's actual wall even in
                    # loser-heavy batches.
                    winners = [
                        img_path
                        for (i, img_path, _ann), _data in chunk
                        if last_for_stem[stems[i]] == i
                    ]
                    share = (time.perf_counter() - t_dispatch) / max(
                        len(winners), 1
                    )
                    for img_path in winners:
                        stats_out[img_path] = share
                for k, ((i, img_path, _ann), _data) in enumerate(chunk):
                    stem = stems[i]
                    win = last_for_stem[stem]
                    if win != i:
                        # A later pair owns this stem (last-wins): skip the
                        # dead encode. Report the winner's path — now if its
                        # write already landed (its bucket may have run
                        # first), otherwise when it does.
                        if win in failed:
                            print(
                                f"warning: {img_path}: skipped (duplicate "
                                f"of failed pair {pairs[win][0]})",
                                file=sys.stderr,
                            )
                        elif win in results:
                            results[i] = results[win]
                            if progress:
                                progress(img_path, results[win])
                        else:
                            dup_waiters.setdefault(win, []).append(
                                (i, img_path)
                            )
                        continue
                    d_np = depth_np[k]
                    a_np = art_np[k] if art_np is not None else None

                    def write(d_np=d_np, a_np=a_np, stem=stem):
                        if a_np is not None:
                            imwrite(
                                os.path.join(out_dir, f"{stem}_effect.png"),
                                a_np, png_level=png_level,
                            )
                        if depth16:
                            imwrite(
                                os.path.join(out_dir, f"{stem}_depth16.png"),
                                depth_to_u16(d_np), png_level=png_level,
                            )
                        dp = os.path.join(out_dir, f"{stem}_depth.png")
                        imwrite(dp, depth_to_u8(d_np), png_level=png_level)
                        return dp

                    writes.append((i, img_path, pool.submit(write)))
                drain_writes(block=False)
                # Bound host memory: if PNG encode is the bottleneck, block
                # on the oldest writes instead of accumulating batches.
                drain_writes(block=True, keep=2 * io_workers + 4)
        drain_writes(block=True)
    for win, waiters in dup_waiters.items():
        # The stem's winner never produced a file (its decode failed under
        # keep_going after the duplicate had already deferred to it).
        for _j, dup_path in waiters:
            print(
                f"warning: {dup_path}: skipped (duplicate of failed pair "
                f"{pairs[win][0]})",
                file=sys.stderr,
            )
    return [results[i] for i in sorted(results)]


def config_from_args(a, error=None) -> DiffusionConfig:
    """Resolve the CLI namespace into a DiffusionConfig.

    The shared solver surface (profiles, early exit, SOR tuning, defocus
    quality — identical semantics across every CLI) resolves in
    flags.resolve_solver_flags; serving layers only --iterations on top.
    Factored out of main() so tests can assert a flag set resolves to the
    intended config without running a solve.
    """
    from .flags import resolve_solver_flags

    def fail(msg: str):
        if error is not None:
            error(msg)  # argparse .error: prints usage + exits 2
        raise ValueError(msg)

    kw = resolve_solver_flags(a, fail)
    if a.iterations is not None:
        kw["max_iterations"] = max(int(a.iterations), 1)
    return DiffusionConfig(**kw)


def _trim_pipelines(pipelines, cap: int) -> List[Tuple[int, int]]:
    """Evict least-recently-used per-shape pipelines beyond ``cap`` (watch
    mode's resident-memory bound: each DepthPipeline keeps its shape's
    device state, so a service fed arbitrarily many distinct image shapes
    would otherwise grow without bound). ``pipelines`` is an OrderedDict
    maintained in least-recently-USED-first order (solve_pairs
    move_to_end's a shape on every use). Returns the evicted shape keys
    (for the log line). Evicted shapes get a new pipeline on next sight."""
    evicted = []
    while len(pipelines) > max(cap, 1):
        shape, _pipe = pipelines.popitem(last=False)
        evicted.append(shape)
    return evicted


def _watch(a, cfg, eff, t_run0) -> int:
    """--watch service loop: poll the pair directories, solve what's new.

    A pair is DUE when its (image mtime, annotation mtime) signature
    differs from the last signature it was solved at — so both brand-new
    pairs and edits to either file of an existing pair re-solve; the
    signature is captured BEFORE the solve, so a file updated mid-solve is
    simply due again on the next scan (no lost updates). Decode/write
    failures never kill the service: the pair retries on later scans (the
    common cause is a file still being copied in) and is recorded 'failed'
    after _WATCH_MAX_ATTEMPTS consecutive failures of the SAME signature —
    touching the file re-arms it. Giving up removes the pair's outputs from
    --out, unless another image of the same stem stands solved: they are
    its outputs then. Per-shape pipelines persist across batches
    (solve_pairs' ``pipelines``), so steady-state latency is the warm path.
    Exits 0 on --idle-exit, Ctrl-C, or SIGTERM (the service-manager stop
    signal, handled like Ctrl-C so the final manifest is still written); 1
    if any pair was in the given-up failed state at exit. --report rewrites
    the manifest after every batch and on exit, one entry per pair ever
    seen (latest status), so an external pipeline can consume it while the
    service runs.
    """
    import signal

    def _term(_signum, _frame):
        raise KeyboardInterrupt  # exit through the Ctrl-C path

    try:
        # signal.signal works only on the main thread; embedded callers
        # (tests driving _watch from a worker thread) keep their process's
        # default SIGTERM handling.
        prev_term = signal.signal(signal.SIGTERM, _term)
    except ValueError:
        prev_term = None

    from collections import OrderedDict

    # Least-recently-used-first: solve_pairs records uses (move_to_end) and
    # _trim_pipelines bounds resident shapes at --max-shapes after each batch.
    pipelines: "OrderedDict[Tuple[int, int], object]" = OrderedDict()
    outputs: Dict[str, str] = {}
    stats: Dict[str, float] = {}
    # All bookkeeping is keyed by IMAGE PATH, not stem: two images sharing a
    # stem (a.jpg + a.png matching the same annotation) are distinct pairs
    # to the scanner — keying by stem would make their alternating
    # signatures re-solve each other forever.
    snapshot: Dict[str, Tuple[float, float]] = {}  # img -> settled signature
    # img -> (signature it failed at, consecutive failures at it). One entry
    # per image (not per signature): a file that keeps changing mtime while
    # broken must not leak an entry per signature it ever failed at.
    fails: Dict[str, Tuple[Tuple[float, float], int]] = {}
    given_up: set = set()  # imgs recorded 'failed' at their current sig
    pair_by_img: Dict[str, str] = {}  # img -> ann, first-seen order
    skipped_existing: set = set()
    last_work = time.monotonic()
    first_scan = True

    def write_report():
        if a.report:
            _write_report(a, cfg, list(pair_by_img.items()), outputs,
                          skipped_existing, t_run0, stats)

    def progress(src, dst):
        outputs[src] = dst
        print(f"{src} -> {dst}")

    print(f"watching {a.images} + {a.annotations} "
          f"(poll {a.poll_interval:g}s"
          + (f", idle-exit {a.idle_exit:g}s" if a.idle_exit else "")
          + ")", file=sys.stderr)
    try:
        while True:
            due: List[Tuple[str, str]] = []
            sigs: Dict[str, Tuple[float, float]] = {}
            for img, ann in discover_pairs(a.images, a.annotations):
                try:
                    sig = (os.path.getmtime(img), os.path.getmtime(ann))
                except OSError:
                    continue  # deleted between listdir and stat
                pair_by_img.setdefault(img, ann)
                if snapshot.get(img) == sig:
                    continue
                if first_scan and a.skip_existing and _outputs_done(a, img):
                    snapshot[img] = sig
                    skipped_existing.add(img)
                    continue
                sigs[img] = sig
                due.append((img, ann))
            first_scan = False
            if due:
                written = solve_pairs(
                    due, a.out, cfg, eff, progress=progress,
                    io_workers=a.io_workers, prefetch=a.prefetch,
                    keep_going=True,  # a service outlives one bad file
                    png_level=a.png_level, depth16=a.depth16,
                    stats_out=stats, pipelines=pipelines, device=a.device,
                )
                for (img, _ann), w in zip(due, written):
                    sig = sigs[img]
                    if w:
                        snapshot[img] = sig
                        given_up.discard(img)
                        fails.pop(img, None)
                    else:
                        prev_sig, prev_k = fails.get(img, (None, 0))
                        k = prev_k + 1 if prev_sig == sig else 1
                        fails[img] = (sig, k)
                        if k >= _WATCH_MAX_ATTEMPTS:
                            # Stop retrying this signature; a touch re-arms.
                            snapshot[img] = sig
                            given_up.add(img)
                            # The manifest reports the LATEST status: an
                            # output from an earlier signature must not keep
                            # this pair 'solved' (with a stale path and
                            # solve_s) while the service gives up on its
                            # current contents and exits 1.
                            outputs.pop(img, None)
                            stats.pop(img, None)
                            print(f"watch: giving up on {img} after {k} attempts (touch it to "
                                  f"retry; {_remove_stale_outputs(a.out, img, outputs)})",
                                  file=sys.stderr)
                evicted = _trim_pipelines(pipelines, a.max_shapes)
                if evicted:
                    print(f"watch: evicted {len(evicted)} resident shape "
                          f"pipeline(s) over --max-shapes={a.max_shapes}: "
                          + ", ".join(f"{h}x{w}" for h, w in evicted),
                          file=sys.stderr)
                write_report()
                # Idle counts from the END of the batch: a first batch
                # longer than --idle-exit (builds) must not read as idle.
                last_work = time.monotonic()
            if (a.idle_exit is not None
                    and time.monotonic() - last_work >= a.idle_exit):
                print(f"watch: idle for {a.idle_exit:g}s, exiting",
                      file=sys.stderr)
                break
            time.sleep(a.poll_interval)
    except KeyboardInterrupt:
        print("watch: interrupted, exiting", file=sys.stderr)
    finally:
        if prev_term is not None:
            signal.signal(signal.SIGTERM, prev_term)
        write_report()
    return 1 if given_up else 0


_WATCH_MAX_ATTEMPTS = 3


def _remove_stale_outputs(out_dir: str, img: str, outputs: Dict[str, str]) -> str:
    """Unlink the outputs of ``img``'s stem from ``out_dir``, so that the
    disk agrees with a manifest that no longer reports the pair solved,
    unless another image of that stem stands solved in ``outputs``: the
    files are then that image's, and the manifest reports them. (The JAX
    server unlinks by stem alone and so deletes a solved ``a.png``'s
    outputs when it gives up on a broken ``a.jpg``.) Returns what it did,
    for the log line."""
    stem = _stem(img)
    owner = next((src for src in outputs if _stem(src) == stem), None)
    if owner is not None:
        return f"outputs kept: {owner} stands solved under stem {stem!r}"
    for suffix in ("_depth.png", "_depth16.png", "_effect.png"):
        try:
            os.unlink(os.path.join(out_dir, stem + suffix))
        except OSError:
            pass
    return "stale outputs removed"


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(prog="rtdd-serve-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--pairs", nargs="*", default=[],
                   help="image:annotation path pairs")
    p.add_argument("--images", help="directory of images")
    p.add_argument("--annotations", help="directory of annotations")
    p.add_argument("--out", required=True)
    p.add_argument("--effect", choices=list(_EFFECT_BY_KEY), default=None)
    p.add_argument("--backend", default="auto",
                   help="validated, routes nothing: the device picks the kernels")
    p.add_argument("--device", type=device_arg, default="cuda",
                   help="cuda (default), cuda:N or cpu: where the pairs are "
                        "solved; a card asked for where there is none raises")
    p.add_argument("--solver", default=None,
                   choices=["jacobi_chebyshev", "jacobi", "red_black"],
                   help="solver variant (default jacobi_chebyshev, the "
                        "reference algorithm; a --profile may change it)")
    p.add_argument("--iterations", type=int, default=None,
                   help="coarsest-level iteration budget (default 1000, the "
                        "reference schedule); a quality/latency knob")
    p.add_argument("--profile", choices=["faithful", "fast"], default=None,
                   help="named solver profile: 'faithful' = the reference "
                        "schedule (today's defaults); 'fast' = red_black + "
                        "RMS residual early exit at tolerance 1e-3. Explicit "
                        "solver flags override the profile's choices")
    p.add_argument("--multigrid", choices=["cascadic", "vcycle"],
                   default=None,
                   help="multigrid scheme (default cascadic, the reference "
                        "coarse-to-fine pass; vcycle adds polishing cycles)")
    p.add_argument("--early-exit", action="store_true",
                   help="stop a level once the residual drops below the "
                        "tolerance (every solver honors it; the reference "
                        "declares a tolerance and ignores it)")
    p.add_argument("--tolerance", type=float, default=None,
                   help="residual tolerance; implies --early-exit (default "
                        "1e-5, the value the reference declares but never "
                        "uses)")
    p.add_argument("--residual-metric", choices=list(VALID_RESIDUAL_METRICS),
                   default=None,
                   help="early-exit residual functional (default rms; the "
                        "max-norm cannot fire at fine levels)")
    p.add_argument("--rb-rho", type=float, default=None,
                   help="spectral-radius estimate for the red-black "
                        "cyclic-Chebyshev omegas (default 0.9999)")
    p.add_argument("--rb-plain", action="store_true",
                   help="plain Gauss-Seidel red-black (disable the SOR "
                        "omegas)")
    p.add_argument("--defocus-quality", choices=["auto", "exact", "approx"],
                   default=None,
                   help="refocus window-half candidate set (default auto: "
                        "exact through ~1440p apertures and bounded-error "
                        "approx at 4K+, loudly reported; 'approx' snaps blur "
                        "windows larger than 16 px to a stride grid)")
    p.add_argument("--defocus-stride", type=int, default=None, metavar="N",
                   help="approx candidate stride (default 4; implies "
                        "--defocus-quality approx)")
    p.add_argument("--multichip", action="store_true",
                   help="batched serving over a slot mesh of one slot per "
                        "card (data parallel x 2-D spatial sharding)")
    p.add_argument("--batch", type=int, default=None,
                   help="images per multi-device step (rounded up to the "
                        "mesh batch axis; default = the mesh batch axis)")
    p.add_argument("--io-workers", type=int, default=4,
                   help="host threads for PNG decode/encode (both paths; "
                        "1 disables IO parallelism)")
    p.add_argument("--prefetch", type=int, default=2,
                   help="pairs decoded ahead of the device (single-device "
                        "path; 0 = strictly sequential)")
    p.add_argument("--keep-going", action="store_true",
                   help="skip pairs whose decode/write fails (stderr "
                        "warning; exit code 1 if any were skipped) instead "
                        "of aborting the whole run")
    p.add_argument("--depth16", action="store_true",
                   help="also write {stem}_depth16.png: a 16-bit PNG at the "
                        "solver's full precision (u16 = depth x 257)")
    p.add_argument("--png-level", type=int, default=None, metavar="0-9",
                   help="PNG zlib effort for outputs (codec default 6; "
                        "1 encodes several times faster at a modest size "
                        "cost)")
    p.add_argument("--skip-existing", action="store_true",
                   help="skip pairs whose depth map already exists in --out "
                        "(cheap resume after a partial/--keep-going run; "
                        "with --watch, applies to the initial scan)")
    p.add_argument("--watch", action="store_true",
                   help="run as a long-lived service: poll --images/"
                        "--annotations and solve every new pair — or pair "
                        "whose image/annotation changed on disk — as it "
                        "appears; per-shape pipelines stay resident across "
                        "batches. Exit with Ctrl-C or --idle-exit")
    p.add_argument("--max-shapes", type=int, default=8, metavar="N",
                   help="--watch: resident per-shape pipeline bound — the "
                        "N most-recently-used image shapes stay resident; "
                        "older shapes are evicted after each batch and "
                        "rebuilt when seen again (default 8)")
    p.add_argument("--poll-interval", type=float, default=2.0, metavar="S",
                   help="--watch directory scan period in seconds "
                        "(default 2)")
    p.add_argument("--idle-exit", type=float, default=None, metavar="S",
                   help="--watch: exit 0 after S seconds with no new work "
                        "(default: run until Ctrl-C)")
    p.add_argument("--report", metavar="FILE",
                   help="write a JSON run manifest: per-pair status "
                        "(solved path / skipped_existing / failed), counts, "
                        "wall time and the run configuration")
    a = p.parse_args(argv)
    t_run0 = time.perf_counter()
    cfg = config_from_args(a, p.error)  # resolve/validate flags up front
    # Validate BEFORE the --watch branch: an invalid level there would only
    # surface as a per-write zlib error inside the writer pool — the watch
    # loop would retry and give up on every pair while the service "runs".
    if a.png_level is not None and not 0 <= a.png_level <= 9:
        p.error("--png-level must be in 0..9")

    from .utils.cache import enable_compilation_cache

    if a.watch:
        if not (a.images and a.annotations):
            p.error("--watch requires --images and --annotations "
                    "(directories to poll)")
        if a.pairs:
            p.error("--watch polls directories; --pairs makes no sense")
        if a.multichip:
            p.error("--watch is single-chip (resident per-shape pipelines); "
                    "use batch --multichip runs for mesh serving")
        if a.poll_interval <= 0:
            p.error("--poll-interval must be > 0")
        if a.idle_exit is not None and a.idle_exit < 0:
            p.error("--idle-exit must be >= 0")
        if a.max_shapes < 1:
            p.error("--max-shapes must be >= 1")
        require_device(a.device)
        enable_compilation_cache()
        eff = _EFFECT_BY_KEY.get(a.effect) if a.effect else None
        os.makedirs(a.out, exist_ok=True)
        return _watch(a, cfg, eff, t_run0)

    pairs: List[Tuple[str, str]] = []
    for pr in a.pairs:
        img, ann = pr.split(":", 1)
        pairs.append((img, ann))
    if a.images and a.annotations:
        pairs.extend(discover_pairs(a.images, a.annotations))
    if not pairs:
        print("no input pairs", file=sys.stderr)
        return 2
    all_pairs = list(pairs)
    skipped_existing: set = set()
    if a.skip_existing:
        done = [_outputs_done(a, pr[0]) for pr in pairs]
        skipped_existing = {pr[0] for pr, d in zip(pairs, done) if d}
        pairs = [pr for pr, d in zip(pairs, done) if not d]
        if skipped_existing:
            print(f"skipping {len(skipped_existing)} already-solved pair(s)",
                  file=sys.stderr)
        if not pairs:
            print("solved 0 of 0 pair(s)")
            if a.report:
                _write_report(a, cfg, all_pairs, {}, skipped_existing, t_run0)
            return 0

    require_device(a.device)
    enable_compilation_cache()
    eff = _EFFECT_BY_KEY.get(a.effect) if a.effect else None
    runner = solve_pairs_multichip if a.multichip else solve_pairs
    kwargs = (
        {"batch": a.batch, "io_workers": a.io_workers}
        if a.multichip
        else {"io_workers": a.io_workers, "prefetch": a.prefetch}
    )
    outputs: Dict[str, str] = {}
    stats: Dict[str, float] = {}

    def progress(src, dst):
        outputs[src] = dst
        print(f"{src} -> {dst}")

    try:
        written = runner(
            pairs, a.out, cfg, eff,
            progress=progress,
            keep_going=a.keep_going,
            png_level=a.png_level,
            depth16=a.depth16,
            stats_out=stats,
            device=a.device,
            **kwargs,
        )
    except BaseException:
        # A run aborted mid-way (decode/write/device error without
        # --keep-going, or Ctrl-C) still writes the manifest: pairs not yet
        # solved report status 'failed', honoring _write_report's contract.
        if a.report:
            _write_report(a, cfg, all_pairs, outputs, skipped_existing,
                          t_run0, stats)
        raise
    ok = [w for w in written if w]
    print(f"solved {len(ok)} of {len(pairs)} pair(s)")
    if a.report:
        _write_report(a, cfg, all_pairs, outputs, skipped_existing, t_run0,
                      stats)
    return 0 if len(ok) == len(pairs) else 1


def _write_report(a, cfg, all_pairs, outputs, skipped_existing, t_run0,
                  stats=None) -> None:
    """JSON run manifest (--report): one entry per INPUT pair in input
    order — status 'solved' (with the written depth path), 'skipped_existing'
    (resume found every requested output), or 'failed' (decode/write error
    under --keep-going, or aborted before this pair) — plus counts, wall
    time, throughput over the solved set, per-pair device latency
    ('solve_s': dispatch-to-readback wall; the first pair of a shape charges
    its pipeline), and the knobs that shaped the run, the device among
    them."""
    import json

    stats = stats or {}
    wall_s = time.perf_counter() - t_run0
    entries = []
    for img, ann in all_pairs:
        if img in skipped_existing:
            entries.append({
                "image": img, "annotation": ann, "status": "skipped_existing",
                "depth": os.path.join(a.out, f"{_stem(img)}_depth.png"),
            })
        elif img in outputs:
            entries.append({
                "image": img, "annotation": ann, "status": "solved",
                "depth": outputs[img],
                "solve_s": (round(stats[img], 4) if img in stats else None),
            })
        else:
            entries.append({"image": img, "annotation": ann,
                            "status": "failed", "depth": None})
    n_solved = sum(e["status"] == "solved" for e in entries)
    report = {
        "out_dir": a.out,
        "pairs": entries,
        "counts": {
            "total": len(entries),
            "solved": n_solved,
            "skipped_existing": len(skipped_existing),
            "failed": len(entries) - n_solved - len(skipped_existing),
        },
        "wall_s": round(wall_s, 3),
        "images_per_s": round(n_solved / wall_s, 3) if wall_s > 0 else None,
        # RESOLVED solver knobs (profile already applied), not the raw argv:
        # the manifest must say what actually ran.
        "config": {
            "profile": a.profile, "backend": cfg.backend,
            "solver": cfg.solver, "iterations": cfg.max_iterations,
            "multigrid": cfg.multigrid, "early_exit": cfg.early_exit,
            "tolerance": cfg.tolerance,
            "residual_metric": cfg.residual_metric,
            "rb_chebyshev": cfg.rb_chebyshev, "rb_rho": cfg.rb_rho,
            "effect": a.effect, "multichip": a.multichip, "batch": a.batch,
            "depth16": a.depth16, "png_level": a.png_level,
            "device": a.device,
        },
    }
    with open(a.report, "w") as f:
        json.dump(report, f, indent=2)
    print(f"report written: {a.report}", file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
