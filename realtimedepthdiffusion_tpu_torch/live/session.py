"""Interactive editing session (port of ``realtimedepthdiffusion_tpu/live/session.py``).

Brush strokes hit host annotation planes through the native C++ rasterizer
(dirty-rect tracked, no device round trip at stroke latency), and the
annotation planes, the gray pyramid and the depth-state pyramid stay on the
session's device for its whole life. A solve sends the device only what the
pending dirty rects changed: both whole planes where none are on the device
yet (the first solve, a resumed checkpoint) or a rect covers the whole
image (``mark_all_dirty``, an annotation load); each rect's window on the
windowed path; else each rect's own crop, written into the resident planes.

Key/mode semantics (the reference's ``src/main.cpp:20-27, 180-334``):
- digits '0'..'4' -> scribble depth min(d * 64, 254)
- '+'/'-'         -> brush radius +-2 (clamped at 0)
- 'd'             -> solve; --live solves every frame
- 'b'/'g'/'h'     -> sticky refocus/desaturation/haze (mutually exclusive)
- 's'             -> save AnnotatedImage.png, DepthMap.png, ArtisticEffect.png
- 't'             -> report last solve wall time

The session drives the pipeline's program layer as the reference's does:
``prewarm_async`` in the constructor, so the build, the card queries and
the tables overlap the image's upload; under ``fast_start`` the second full
solve of a pipeline captures its CUDA graph and later ones replay it
(``pipeline.py``). The windowed path is gated on ``incremental_ready`` and
its kick deferred past the frame, as in the reference: under
``fast_start`` the first small edit takes the full warm re-solve and then
captures the windowed re-solve's graph, and later edits replay it at their
own centres. A replay returns fresh tensors, so the ``depth0`` and
``depth_state`` the session keeps from frame to frame never change under a
later one.

The session's ``timer`` (``utils/timing.py:StageTimer``) holds its stages
``upload`` and ``solve`` (host clock ending at a device sync; on a
profiler's timeline ``session.upload`` and ``session.solve``, each with
the solve's number as its argument), its spans ``session.mask`` (the
host's scribble compare, or its copy of the rects' crops into the staging
buffer), ``session.window_solve`` (an update's windowed
re-solves) and ``session.u8_readback`` (the wait for the solve and the u8
map's copy), and its pipelines' program spans and the V-cycle's
``vcycle.polish`` (``pipeline.py``). While a
profiler runs, the solve's early exit is read after the readback, with
copies alone, into the counters ``exit.chunks_issued`` (every chunk of
each level's cap, as a card issues them), ``exit.chunks_live`` (those
whose probe ran before the exit), ``exit.px`` (the pixels of each level or
window solved), ``exit.px_iters_run`` (pixels times iterations run) and,
where the probes are the kernel ``residual_probe`` (on a card),
``exit.probes_kernel`` (the issued chunks whose probe is the kernel).
Also while a profiler runs, after the readback, the counters of the K6
route (``ops/dispatch.py:fused_route``, decided on the host per level
call, ``DepthPipeline.level_calls``): ``sweep.fused_levels`` (the level
calls routed to K6), ``sweep.fused_px`` (their pixels) and
``sweep.fused_px_sweeps`` (pixels times sweeps: the iterations each ran
under the early exit, else its count); and of K2's route
(``ops/dispatch.py:resident_work``): ``sweep.resident_sweeps`` (the sweeps
of the level calls routed to K2) and ``sweep.resident_exchanges`` (how
often their launches read the band edges: once per block of
``ops/sweep.py:resident_plan``'s sweeps, so the ratio is the mean number
of sweeps per exchange); and, where a full solve runs the V-cycle, of its
polish (``core/multigrid.py:vcycle_work``, from the levels' shapes and the
config): ``vcycle.cycles`` (the cycles run), ``vcycle.px_sweeps`` (pixels
times sweeps of every smoothing, pre, post and coarse, at every level of
every cycle) and ``vcycle.px`` (the pixels of every level visit); and
``vcycle.smooth_kernel``, the smoothing passes of the solve that took the
kernel route (``ops/dispatch.py:smooth_passes``, recorded as each pass was
issued, eagerly or into the replayed graph's capture: 18 a 1080p solve on a
card, 0 on the CPU). Also while a profiler runs, after every solve, the
defocus renders that the solve issued or replayed
(``ops/defocus.py:render_counts``, counted in K3's wrapper and in
``defocus_sat`` alike): ``defocus.renders`` (each whole-image render) and
``defocus.approx`` (those whose half-widths were snapped: the quality
resolved to 'approx', as 'auto' does above ``pallas_defocus_auto_max_half``).
Also while a profiler runs, the upload's counters:
``upload.full`` (solves that sent both whole planes), ``upload.rects``
(rects whose crops were written into the resident planes) and ``upload.px``
(pixels whose mask and value bytes crossed, on any path: half of
``last_upload_bytes``).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DiffusionConfig
from ..core import effects as fx
from ..core.multigrid import vcycle_work
from ..core.solver import read_exit_log
from ..io import depth_to_u8, depth_to_u16, imwrite, load_annotation, save_annotation
from ..native.runtime import Arena, NativeRuntime
from ..ops import dispatch
from ..ops.defocus import render_counts
from ..pipeline import DepthPipeline
from ..utils.timing import StageTimer, profiling

_KEY_EFFECT = {"b": fx.EFFECT_DEFOCUS, "g": fx.EFFECT_DESATURATION, "h": fx.EFFECT_HAZE}


def _tallies() -> collections.Counter:
    """The tallies that count as work is issued and grow again at each
    replay (``utils/program.py``), under their counters' names."""
    return collections.Counter({"vcycle.smooth_kernel": dispatch.smooth_passes["kernel"],
                                "defocus.renders": render_counts["renders"],
                                "defocus.approx": render_counts["approx"]})


def window_origin(c: int, lo: int, hi: int, n: int, s: int) -> int:
    """Start of the s-pixel upload window of a dirty rect spanning [lo, hi]
    with centre c on an axis of n pixels: near the centre, clamped so that
    the window covers the whole rect ([hi + 1 - s, lo]) and stays inside.
    A centred start alone can miss the rect's last row or column when the
    rect spans exactly s pixels."""
    return min(max(c - s // 2, hi + 1 - s, 0), lo, n - s)


class DepthSession:
    """One image-editing session (the lifetime of the reference's main())
    on the ``device`` the caller names. Asking for a CUDA device where there
    is none raises: the session never moves to the CPU by itself."""

    def __init__(self, rgb: np.ndarray, cfg: DiffusionConfig = DiffusionConfig(), *, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"DepthSession: device {str(device)!r} asked for, "
                               "but no CUDA device is visible")
        self.cfg = cfg
        self.rows, self.cols = rgb.shape[:2]
        self.rgb_np = np.array(rgb[..., :3], dtype=np.uint8, order="C")  # the session's own copy
        self.timer = StageTimer(device=self.device, prefix="session.")
        self.pipe = self._pipeline(cfg)
        # fast_start: the first solve's preparation (the build, the card
        # queries, the tables) runs on a thread while the image uploads and
        # its gray pyramid is built; the first solve joins it.
        self.pipe.prewarm_async()
        self.rgb, self.gray_pyr = self.pipe.prepare_image(self.rgb_np)
        # Annotation planes live on the host and are painted by the native
        # runtime's brush rasterizer (dirty-rect tracked); they upload to the
        # device once per solve.
        self.native = NativeRuntime()
        # All host frame buffers of the session come from one arena slab:
        # the two annotation planes plus the edited-image compositing buffer
        # the GUI redraws every tick. Views stay valid for the session's
        # lifetime (the session owns the arena).
        self.arena = Arena(2 * self.rows * self.cols + 3 * self.rows * self.cols + 4 * 64)
        self.mask_np = self.arena.alloc_u8((self.rows, self.cols))
        self.value_np = self.arena.alloc_u8((self.rows, self.cols))
        self._edited_buf = self.arena.alloc_u8((self.rows, self.cols, 3))
        # Pending edits as a list of disjoint dirty rects (y0, x0, y1, x1):
        # up to cfg.incremental_max_rects simultaneous distant strokes each
        # take the windowed incremental path.
        self.dirty_rects: list = []
        self._mask_d: Optional[torch.Tensor] = None  # device annotation cache
        self._value_d: Optional[torch.Tensor] = None
        # Where a full re-solve's dirty-rect crops of both planes wait for
        # their copy to the device: host memory that the card's copy engine
        # reads directly (pinned) on a card, as a numpy view.
        self._staging = torch.empty(2 * self.rows * self.cols, dtype=torch.uint8,
                                    pin_memory=self.device.type == "cuda").numpy()
        self.depth_state = self.pipe.initial_state()
        self.depth0 = self.depth_state[0]
        self.artistic: Optional[torch.Tensor] = None
        self.effect = fx.EFFECT_NONE
        self.scribble_color = 0
        self.scribble_radius = cfg.brush_radius(self.rows, self.cols)
        # Export preference (--depth16): consulted by save() when the caller
        # does not pass depth16 explicitly, so the GUI 's' key honors the
        # flag the session was launched with.
        self.save_depth16 = False
        self.last_solve_ms = 0.0
        self.last_upload_bytes = 0  # what the last solve() sent to the device
        self.solve_count = 0
        # Incremental pipeline: a reduced budget for warm full re-solves
        # (cfg.incremental_iterations > 0). The depth-state warm start makes
        # a small budget sufficient after the first solve.
        self._inc_pipe: Optional[DepthPipeline] = None
        if cfg.incremental_iterations > 0:
            inc_cfg = dataclasses.replace(cfg, max_iterations=cfg.incremental_iterations)
            self._inc_pipe = self._pipeline(inc_cfg)

    def _pipeline(self, cfg: DiffusionConfig) -> DepthPipeline:
        """A pipeline that records into the session's timer and leaves the
        early exit's counts to the session's own read."""
        pipe = DepthPipeline(self.rows, self.cols, cfg, device=self.device, timer=self.timer)
        pipe.exit_wait = False
        return pipe

    # ------------------------------------------------------------ annotation
    def load_annotation_file(self, path: str) -> None:
        """-a flag: resume a session from an annotation PNG (the checkpoint
        format, src/main.cpp:160-170)."""
        mask, value = load_annotation(path, self.cfg)
        if mask.shape != (self.rows, self.cols):
            raise ValueError(
                f"annotation {mask.shape} does not match image "
                f"{(self.rows, self.cols)}"
            )
        # copy into the arena-backed planes (they must keep their storage)
        np.copyto(self.mask_np, mask.astype(np.uint8))
        np.copyto(self.value_np, value)
        self.mark_all_dirty()

    def set_color_key(self, digit: int) -> None:
        """Keys '0'..'4' (src/main.cpp:38-44)."""
        if 0 <= digit <= 4:
            self.scribble_color = min(digit * 64, 254)

    def adjust_radius(self, delta: int) -> None:
        self.scribble_radius = max(self.scribble_radius + delta, 0)

    @property
    def dirty(self) -> Optional[Tuple[int, int, int, int]]:
        """Bounding box of all pending dirty rects, read-only (the rects
        themselves are ``dirty_rects``; ``mark_all_dirty`` marks the whole
        image). The reference also lets callers assign it, which collapses
        every pending rect into one."""
        if not self.dirty_rects:
            return None
        ys0, xs0, ys1, xs1 = zip(*self.dirty_rects)
        return (min(ys0), min(xs0), max(ys1), max(xs1))

    def mark_all_dirty(self) -> None:
        """The whole image is pending: the next solve uploads both planes
        and re-solves in full."""
        self.dirty_rects = [(0, 0, self.rows - 1, self.cols - 1)]

    def _add_dirty(self, rect, gap: int = 8) -> None:
        """Insert a paint rect: merge with every pending rect it overlaps
        or sits within ``gap`` px of (consecutive events of one stroke
        coalesce into one rect; distant simultaneous strokes stay
        separate). Overflow beyond cfg.incremental_max_rects merges the
        two nearest rects, so the list is bounded and the worst case
        degrades to a single bounding rect."""
        def near(a, b):
            return not (a[2] + gap < b[0] or b[2] + gap < a[0]
                        or a[3] + gap < b[1] or b[3] + gap < a[1])

        def union(a, b):
            return (min(a[0], b[0]), min(a[1], b[1]),
                    max(a[2], b[2]), max(a[3], b[3]))

        rects = self.dirty_rects
        cur = tuple(rect)
        merged = True
        while merged:
            merged = False
            for i, r in enumerate(rects):
                if near(cur, r):
                    cur = union(cur, r)
                    rects.pop(i)
                    merged = True
                    break
        rects.append(cur)
        kmax = max(int(self.cfg.incremental_max_rects), 1)
        while len(rects) > kmax:
            best = None
            for i in range(len(rects)):
                for j in range(i + 1, len(rects)):
                    a, b = rects[i], rects[j]
                    d = (abs((a[0] + a[2]) - (b[0] + b[2]))
                         + abs((a[1] + a[3]) - (b[1] + b[3])))
                    if best is None or d < best[0]:
                        best = (d, i, j)
            _, i, j = best
            rects[i] = union(rects[i], rects[j])
            rects.pop(j)

    def paint(self, x: int, y: int) -> None:
        """Mouse-drag brush stroke (square brush): native rasterizer into
        the host planes, accumulating dirty rects."""
        rect = self.native.paint(
            self.mask_np, self.value_np, x, y, self.scribble_color,
            self.scribble_radius,
        )
        if rect is not None:
            self._add_dirty(rect)

    # ----------------------------------------------------------------- solve
    def solve(self) -> np.ndarray:
        """One solve; returns the uint8 depth map on the host. Warm-starts
        from the previous depth-state pyramid.

        Incremental mode (cfg.incremental_iterations > 0): after the first
        full solve, edits whose dirty rects each fit the incremental window
        take the local path: the host uploads only the dirty windows of the
        annotation planes (``update_annotation_window``) and the solver
        re-solves a window around each edit at the fine levels
        (``core/incremental.py``), one rect after another (up to
        cfg.incremental_max_rects simultaneous distant strokes). Larger
        edits (annotation loads, rect overflow past the window) take the
        full warm re-solve. Where nothing is on the device yet (a session
        resumed from a checkpoint with pending rects), both planes upload
        first and the pending rects still take the local path.

        The upload follows the rects alone: both whole planes where nothing
        is on the device yet or a pending rect covers the whole image; on
        the windowed path each rect's window; on a full re-solve (every
        solve where ``incremental_iterations`` is 0) each rect's crop,
        ``y0:y1 + 1, x0:x1 + 1``, of both planes, copied to the device in
        one piece through a pinned buffer and written into the resident
        planes, so ``last_upload_bytes`` is twice the rects' area. Either
        way the device planes equal ``mask_np != 0`` and ``value_np`` after
        the upload.
        """
        t0 = time.perf_counter()
        pipe = self.pipe
        if self._inc_pipe is not None and self.solve_count > 0:
            pipe = self._inc_pipe

        rects = list(self.dirty_rects)
        s_win = min(self.cfg.incremental_window, self.rows, self.cols)
        kmax = max(int(self.cfg.incremental_max_rects), 1)
        use_local = (
            self._inc_pipe is not None
            and self.solve_count > 0
            and bool(rects)
            and len(rects) <= kmax
            and all(r[2] - r[0] + 1 <= s_win and r[3] - r[1] + 1 <= s_win for r in rects)
        )
        # The reference's gate: never block a frame on the incremental
        # program; peek now, kick after this frame's solve.
        fx_key = self.effect if self.effect != fx.EFFECT_NONE else None
        inc_kick_wanted = use_local and not self.pipe.incremental_ready(fx_key, kick=False)
        use_local = use_local and not inc_kick_wanted
        centers = [((r[0] + r[2]) // 2, (r[1] + r[3]) // 2) for r in rects] if use_local else []
        self.last_upload_bytes = 0
        exit_log = [] if self.cfg.early_exit and profiling() else None
        number = str(self.solve_count)
        tallied = _tallies()
        with self.timer.stage("upload", number):
            # The dirty rects gate (and crop) the host->device annotation
            # transfer: under --live the solve runs every frame, but
            # unchanged annotations reuse the device copies, and an edit
            # uploads only its rects' (or windows') bytes.
            whole = (0, 0, self.rows - 1, self.cols - 1)
            full = self._mask_d is None or (not use_local and whole in rects)
            rect_writes = 0
            if full:
                # torch.tensor copies: a later stroke on the arena-backed
                # planes does not reach the device copy, even on the CPU.
                with self.timer.span("session.mask"):
                    mask_np = self.mask_np != 0
                self._mask_d = torch.tensor(mask_np, device=self.device)
                self._value_d = torch.tensor(self.value_np, device=self.device)
                self.last_upload_bytes = 2 * self.rows * self.cols
            elif rects and not use_local:
                # Outside the pending rects the resident planes already hold
                # the host's bytes, so each rect writes its crops in place
                # (after the last replay's copy of the planes, in stream
                # order). Both crops cross in one blocking copy from the
                # pinned staging buffer, so the next rect may reuse it; the
                # cast to bool on the device is the mask's != 0.
                for y0, x0, y1, x1 in rects:
                    rows, cols = slice(y0, y1 + 1), slice(x0, x1 + 1)
                    h, w = y1 - y0 + 1, x1 - x0 + 1
                    crops = self._staging[:2 * h * w].reshape(2, h, w)
                    with self.timer.span("session.mask"):
                        crops[0] = self.mask_np[rows, cols]
                        crops[1] = self.value_np[rows, cols]
                    crops = torch.from_numpy(crops).to(self.device)
                    self._mask_d[rows, cols] = crops[0]
                    self._value_d[rows, cols] = crops[1]
                    self.last_upload_bytes += 2 * h * w
                rect_writes = len(rects)
            elif use_local:
                for rect, (cy, cx) in zip(rects, centers):
                    oy = window_origin(cy, rect[0], rect[2], self.rows, s_win)
                    ox = window_origin(cx, rect[1], rect[3], self.cols, s_win)
                    rows, cols = slice(oy, oy + s_win), slice(ox, ox + s_win)
                    # Both windows are copies of the arena's bytes.
                    with self.timer.span("session.mask"):
                        mw = torch.from_numpy(self.mask_np[rows, cols] != 0)
                        vw = torch.from_numpy(self.value_np[rows, cols].copy())
                    self._mask_d, self._value_d = self.pipe.update_annotation_window(
                        self._mask_d, self._value_d, mw, vw, (oy, ox))
                    self.last_upload_bytes += 2 * s_win * s_win
            mask_d, value_d = self._mask_d, self._value_d
            self.dirty_rects = []
            if profiling():
                self.timer.count("upload.full", int(full))
                self.timer.count("upload.rects", rect_writes)
                self.timer.count("upload.px", self.last_upload_bytes // 2)
        with self.timer.stage("solve", number):
            if use_local:
                # One windowed re-solve per rect; the active effect renders
                # once, with the last window's solve (it sees every rect's
                # updated state).
                with self.timer.span("session.window_solve"):
                    for i, center in enumerate(centers):
                        if self.effect == fx.EFFECT_NONE or i < len(centers) - 1:
                            self.depth0, self.depth_state = self.pipe.solve_incremental(
                                self.gray_pyr, mask_d, value_d, self.depth_state, center,
                                exit_log)
                        else:
                            self.depth0, self.depth_state, self.artistic = (
                                self.pipe.solve_incremental_and_effect(
                                    self.effect, self.gray_pyr, self.rgb, mask_d, value_d,
                                    self.depth_state, center, exit_log))
            elif self.effect == fx.EFFECT_NONE:
                self.depth0, self.depth_state = pipe.solve(
                    self.gray_pyr, mask_d, value_d, self.depth_state, exit_log)
            else:
                self.depth0, self.depth_state, self.artistic = pipe.solve_and_effect(
                    self.effect, self.gray_pyr, self.rgb, mask_d, value_d, self.depth_state,
                    exit_log)
            with self.timer.span("session.u8_readback"):
                u8 = self.pipe.depth_u8(self.depth0).cpu().numpy()
            if exit_log:
                self._count_exits(read_exit_log(exit_log))
            if profiling():
                self._count_routes(self.pipe if use_local else pipe, use_local,
                                   max(len(centers), 1), exit_log, _tallies() - tallied)
        if inc_kick_wanted:
            self.pipe.incremental_ready(fx_key)
        self.solve_count += 1
        self.last_solve_ms = (time.perf_counter() - t0) * 1000.0
        return u8

    def _count_exits(self, exit_log) -> None:
        """The early exit's counters (the module's docstring) over the
        levels of one solve's ``exit_log``."""
        chunk = max(int(self.cfg.residual_check_every), 1)
        for e in exit_log:
            px = e["shape"][0] * e["shape"][1]
            issued = -(-e["cap"] // chunk)
            self.timer.count("exit.chunks_issued", issued)
            if e["probe"] == "kernel":
                self.timer.count("exit.probes_kernel", issued)
            self.timer.count("exit.chunks_live", len(e["probes"]))
            self.timer.count("exit.px", px)
            self.timer.count("exit.px_iters_run", px * e["iters"])

    def _count_routes(self, pipe: DepthPipeline, windowed: bool, solves: int,
                      exit_log, grown: collections.Counter) -> None:
        """The counters ``sweep.fused_*``, ``sweep.resident_*``,
        ``defocus.*`` and, after a full V-cycle solve, ``vcycle.*`` (the
        module's docstring) over the level calls of ``solves`` solves of
        ``pipe``; ``exit_log``, read, holds one entry per call under the
        early exit, whose launches run ``residual_check_every`` sweeps.
        ``grown``: what the solve issued or replayed of ``_tallies``."""
        calls = pipe.level_calls(windowed) * solves
        iters = [e["iters"] for e in exit_log] if exit_log is not None else [c[2] for c in calls]
        fused = [(h * w, n) for (h, w, _, k6), n in zip(calls, iters) if k6]
        self.timer.count("sweep.fused_levels", len(fused))
        self.timer.count("sweep.fused_px", sum(px for px, _ in fused))
        self.timer.count("sweep.fused_px_sweeps", sum(px * n for px, n in fused))
        chunk = max(int(self.cfg.residual_check_every), 1) if exit_log is not None else 0
        resident = [dispatch.resident_work(h, w, pipe.device, pipe.cfg.solver, n, chunk)
                    for (h, w, _, k6), n in zip(calls, iters) if not k6]
        self.timer.count("sweep.resident_sweeps", sum(n for n, _ in resident))
        self.timer.count("sweep.resident_exchanges", sum(x for _, x in resident))
        self.timer.count("defocus.renders", grown["defocus.renders"])
        self.timer.count("defocus.approx", grown["defocus.approx"])
        if not windowed and pipe.cfg.multigrid == "vcycle":
            sizes = [pipe.cfg.level_size(pipe.rows, pipe.cols, lv) for lv in range(pipe.levels)]
            for name, n in zip(("cycles", "px_sweeps", "px"), vcycle_work(sizes, pipe.cfg)):
                self.timer.count("vcycle." + name, n * solves)
            self.timer.count("vcycle.smooth_kernel", grown["vcycle.smooth_kernel"])

    # --------------------------------------------------------------- effects
    def set_effect_key(self, key: str) -> None:
        """'b'/'g'/'h': sticky, mutually exclusive (src/main.cpp:190-230)."""
        eff = _KEY_EFFECT.get(key.lower())
        if eff is not None:
            self.effect = eff

    def render_effect(self) -> Optional[np.ndarray]:
        """Render the active effect from the current depth map."""
        if self.effect == fx.EFFECT_NONE:
            return None
        with self.timer.stage("effect"):
            depth = torch.clamp(self.depth0, 0.0, 255.0)
            self.artistic = self.pipe.effect(self.effect, self.rgb, self.gray_pyr[0], depth)
            return self.artistic.cpu().numpy()

    # --------------------------------------------------------------- display
    def edited_image(self) -> np.ndarray:
        """The scribble overlay view (the reference's 'Edited Image'),
        composited into the arena-backed display buffer (redrawn every GUI
        tick; reusing one slab avoids ~6 MB/frame of allocator churn)."""
        np.copyto(self._edited_buf, self.rgb_np)
        m = self.mask_np != 0
        self._edited_buf[m] = self.value_np[m][:, None]
        return self._edited_buf

    def depth_image(self) -> np.ndarray:
        return self.pipe.depth_u8(self.depth0).cpu().numpy()

    # ------------------------------------------------------------------ save
    def save(self, out_dir: str = ".",
             depth16: Optional[bool] = None) -> Tuple[str, ...]:
        """'s' key: the reference's three PNGs (src/main.cpp:297-318) and
        Annotation.png, the resumable checkpoint in the sentinel encoding.
        ``depth16`` also writes DepthMap16.png, a 16-bit PNG at the solver's
        full precision (io.depth_to_u16); None defers to the session's
        ``save_depth16`` preference (the --depth16 flag)."""
        if depth16 is None:
            depth16 = self.save_depth16
        with self.timer.stage("save"):
            os.makedirs(out_dir, exist_ok=True)
            mask_np = self.mask_np.astype(bool)
            value_np = self.value_np
            depth = self.depth0.cpu().numpy()
            p1 = os.path.join(out_dir, "AnnotatedImage.png")
            imwrite(p1, np.where(mask_np[..., None], value_np[..., None], self.rgb_np))
            save_annotation(
                os.path.join(out_dir, "Annotation.png"), mask_np, value_np, self.cfg
            )
            p2 = os.path.join(out_dir, "DepthMap.png")
            d8 = depth_to_u8(depth)
            imwrite(p2, np.repeat(d8[..., None], 3, axis=2))
            p3 = os.path.join(out_dir, "ArtisticEffect.png")
            art = self.render_effect()
            imwrite(p3, art if art is not None else np.zeros_like(self.rgb_np))
            paths = (p1, p2, p3)
            if depth16:
                p4 = os.path.join(out_dir, "DepthMap16.png")
                imwrite(p4, depth_to_u16(depth))
                paths = paths + (p4,)
        return paths

    # ------------------------------------------------------------ checkpoint
    def save_checkpoint(self, path: str) -> None:
        """Full session checkpoint: annotation planes, the warm depth-state
        pyramid, cursor state and the pending dirty rects. The keys are the
        reference's, plus ``dirty_rects`` (an (n, 4) int32 array), which the
        reference's loader ignores: a checkpoint of either package loads in
        the other."""
        arrays = {
            "mask": self.mask_np,
            "value": self.value_np,
            "scribble_color": np.int32(self.scribble_color),
            "scribble_radius": np.int32(self.scribble_radius),
            "effect": np.int32(self.effect),
            "solve_count": np.int32(self.solve_count),
            "dirty_rects": np.asarray(self.dirty_rects, np.int32).reshape(-1, 4),
        }
        for i, d in enumerate(self.depth_state):
            arrays[f"depth_{i}"] = d.cpu().numpy()
        np.savez_compressed(path, **arrays)

    def load_checkpoint(self, path: str) -> None:
        """Resume from ``save_checkpoint``'s file (or the reference's). The
        pending rects come back as they were saved; a checkpoint without
        them marks the whole image. Both planes upload at the next solve."""
        with np.load(path) as data:
            if data["mask"].shape != (self.rows, self.cols):
                raise ValueError(
                    f"checkpoint shape {data['mask'].shape} != image "
                    f"{(self.rows, self.cols)}"
                )
            np.copyto(self.mask_np, data["mask"].astype(np.uint8))
            np.copyto(self.value_np, data["value"].astype(np.uint8))
            self.scribble_color = int(data["scribble_color"])
            self.scribble_radius = int(data["scribble_radius"])
            self.effect = int(data["effect"])
            self.solve_count = int(data["solve_count"])
            self.depth_state = tuple(
                torch.tensor(data[f"depth_{i}"], dtype=torch.float32, device=self.device)
                for i in range(len(self.depth_state))
            )
            if "dirty_rects" in data:
                self.dirty_rects = [tuple(int(v) for v in r) for r in data["dirty_rects"]]
            else:
                self.mark_all_dirty()
        self.depth0 = self.depth_state[0]
        self._mask_d = self._value_d = None

    def residual_report(self) -> str:
        """Per-level residual norms of the current depth state."""
        res = self.pipe.residuals(
            self.gray_pyr,
            torch.tensor(self.mask_np != 0, device=self.device),
            torch.tensor(self.value_np, device=self.device),
            self.depth_state,
        ).cpu().numpy()
        parts = [
            f"L{l}=max {mx:.4f}/rms {rm:.4f}"
            for l, (mx, rm) in enumerate(zip(res[0], res[1]))
        ]
        return "Residual (per level): " + "  ".join(parts)

    def timing_report(self) -> str:
        """'t' key: the last solve's wall time + per-stage breakdown."""
        return (
            f"Processing Time: {self.last_solve_ms:.2f} ms\n{self.timer.report()}"
        )
