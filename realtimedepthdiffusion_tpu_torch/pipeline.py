"""The solve and effect pipeline for one image size, and its program layer
(port of ``realtimedepthdiffusion_tpu/pipeline.py``).

Every tensor lives on the pipeline's ``device``; on a CUDA device the
sweeps and the defocus run the port's kernels, on the CPU their plain
versions. Every solver of ``cfg.solver`` runs, with or without the
residual early exit, under both multigrid schemes (``cfg.multigrid``: the
cascade or the V-cycle), and the windowed incremental re-solve of the live
loop (``core/incremental.py``).

Where the JAX package compiles one XLA program per solve (``solve``, and
``solve_and_effect`` per effect), the port captures the whole solve into a
CUDA graph and replays it (``Program``): one graph launch in place of the
~480 kernel and glue launches of a 1080p frame, which the host paces one
by one. Where the
JAX package's ``fast_start`` runs its staged per-level programs, the port
runs its eager path. A graph replays the same kernels on the same data, so
the two give the same bits, and a session switches between them unseen
(``tests/test_torch_fast_start.py``). The routing is the JAX package's
(``realtimedepthdiffusion_tpu/pipeline.py:609-663``):

- ``fast_start`` on: the first solve runs eagerly; the second runs eagerly
  and then captures its program (the "kick", deferred as JAX defers its
  background compile); later solves replay it.
- ``fast_start`` off, and every V-cycle (JAX's ``_fast`` is False there):
  the first call of a program runs eagerly and captures it at its end;
  later calls replay.
- ``fast_start`` on with ``background_compile`` False (one-shot CLI runs,
  the directory server): eager for good, as the JAX package stays staged.

The windowed incremental re-solve has its programs too, ``("inc",)`` and
``("inc_fx", effect)``, as in the JAX pipeline (``pipeline.py:546-589,
665-682``): its centre is a (2,) int32 tensor on the card and each window's
origin is computed there (``core/incremental.py``), so one graph serves
every centre. A call replays the program where it exists and matches;
else it runs eagerly, and where no program exists yet captures it at its
end, as JAX's ``solve_incremental`` compiles its plain ``jit`` at the first
call. ``incremental_ready`` has the JAX gate's contract: True with
``fast_start`` or background compiles off, or once the program exists;
else False, and its kick captures the program (from stand-in tensors of
the pipeline's shapes, after one eager run on them), so that the live loop
never waits on a first call's capture.

The first call of a program always runs eagerly, so the nvcc build, the
card queries and the iteration tables on the card exist before a capture
(``prewarm_async`` starts them on a thread). A call whose tensors differ in
shape, dtype or device from the captured ones runs eagerly, as JAX sends
them to plain ``jit``. The residual early exit captures like any other
config: its loop is decided on the card (``core/solver.py:
_chunked_early_exit``), and a list given as ``exit_log`` is filled from the
replay's own counts, read once after it (with ``exit_wait`` off, only
copied: the caller's ``read_exit_log`` completes it). The sharded step
keeps programs of its own, one per argument signature
(``parallel/sharded.py:batched_step``), on the same ``Program``
(``utils/program.py``). On the CPU nothing is captured: a program is the
eager function itself, so the routing runs in the CPU tests. A capture
that fails raises in the caller's frame.

The program layer's spans (``utils/timing.py``) go into the ``timer`` a
pipeline is given (the session's), and onto a running profiler's timeline
with or without one: ``program.call`` from a route's decision to its
return, ``program.eager`` around an eager run, and ``Program``'s own
(``program.capture``, ``program.copy_in``, ``program.replay``,
``program.copy_out``). The counts of ``program.replay`` and
``program.eager`` are the replayed and the eager solves.
"""

from __future__ import annotations

import atexit
import functools
import logging
import os
import threading
import time
import weakref
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .config import DiffusionConfig
from .core import effects as fx
from .core.color import rgb_to_gray
from .core.incremental import clamp_origin, device_yx, host_yx, solve_incremental
from .core.multigrid import (build_annotation_pyramids, build_gray_pyramid,
                             initial_depth_state, solve_cascade, solve_vcycle,
                             vcycle_warm_config)
from .core.solver import level_schedule, read_exit_log, residual_norm, residual_rms
from .core.weights import edge_weights
from .ops import build, dispatch, sweep
from .utils.program import Program, signature
from .utils.timing import span

# prewarm_async's threads are daemons, so nothing during a session waits on
# them; but one still inside the nvcc build or a CUDA call when the
# interpreter finalizes would be killed mid-call. The atexit hook, which
# runs on the main thread before finalization, joins them, within 600 s in
# all, as the JAX package joins its background compiles.
_LIVE_PREWARM_THREADS: "weakref.WeakSet" = weakref.WeakSet()


def _join_prewarm_threads() -> None:
    pending = [t for t in _LIVE_PREWARM_THREADS if t.is_alive()]
    if not pending:
        return
    logging.getLogger(__name__).info("exit: waiting for %d prewarm thread(s)", len(pending))
    deadline = time.monotonic() + 600.0
    for t in pending:
        t.join(timeout=max(deadline - time.monotonic(), 0.0))


atexit.register(_join_prewarm_threads)


class DepthPipeline:
    """Solve and effect for one (rows, cols, cfg) on one ``device``, which
    the caller names: nothing here picks the CPU or a card by itself.

    Callers carry the depth-state pyramid from solve to solve; it
    warm-starts the next solve. ``depth_u8`` and ``depth_u16`` read a depth
    out as integers, and ``residuals`` shows how far each level of a depth
    state is from converged.

    ``solve``, ``solve_and_effect``, ``solve_incremental`` and
    ``solve_incremental_and_effect`` run through the program layer (the
    module's docstring): ``prewarm_async``, ``wait_fused``,
    ``incremental_ready`` and ``background_compile`` are the JAX
    pipeline's hooks, with its contracts.

    ``timer``, a ``utils/timing.py:StageTimer``, receives the program
    layer's spans (the module's docstring). ``exit_wait`` False: a solve
    given an ``exit_log`` only starts its counts' copies to the host, and
    the caller completes them with ``read_exit_log`` after a wait of its
    own (the session, which reads them after its depth map's readback).
    """

    def __init__(self, rows: int, cols: int, cfg: DiffusionConfig = DiffusionConfig(), *,
                 device, timer=None):
        dispatch.check_supported(cfg)
        self.timer = timer
        self.exit_wait = True
        self.rows, self.cols, self.cfg = rows, cols, cfg
        self.device = torch.device(device)
        self.levels = cfg.num_levels(rows, cols)
        self._scheme = solve_vcycle if cfg.multigrid == "vcycle" else solve_cascade
        # The program layer. _aot holds each program by key, ("solve",),
        # ("solve_fx", effect), ("inc",) and ("inc_fx", effect), as the JAX
        # pipeline holds its executables.
        self._aot: dict = {}
        self._fast = cfg.fast_start and cfg.multigrid != "vcycle"
        self._staged = False  # the first solve's preparation is done
        self._staged_thread: Optional[threading.Thread] = None
        self._staged_solves = 0
        self._pool = self._stream = None
        # One-shot processes (headless --solve) and the directory server
        # set this False: under fast_start their solves then stay eager, as
        # the JAX package's stay staged. RTDD_BACKGROUND_COMPILE=0 sets it
        # for the whole process, read as the JAX package reads it.
        self.background_compile = os.environ.get(
            "RTDD_BACKGROUND_COMPILE", "1").lower() not in ("0", "false")

    # -- the program layer ---------------------------------------------------
    def _prepare(self) -> None:
        """What a first solve does before its first launch, and a capture
        must find done: the kernels' build (or load), the card queries the
        routes make (K2's largest cluster, the L2 size) and each level's
        iteration table, on the card."""
        if self.device.type == "cuda":
            build.load_library()
            sweep.resident_max_cluster(self.device)
            dispatch.l2_bytes(self.device)
        for level in range(self.levels):
            iters = self.cfg.level_iterations(self.levels, level)
            if iters > 0:
                table = level_schedule(iters, self.cfg)
                if self.device.type == "cuda":
                    sweep.device_table(table, self.device)

    def _ensure_staged(self) -> None:
        """Join prewarm_async's thread, or prepare on this thread where it
        did not run or failed, so that a failure raises here."""
        t = self._staged_thread
        if t is not None and t.is_alive():
            t.join()
        if not self._staged:
            self._prepare()
            self._staged = True

    def prewarm_async(self) -> None:
        """fast_start: start the first solve's preparation (``_prepare``:
        the nvcc build or its load, the card queries, the tables) on a
        background thread now, so that the rest of session setup (the
        image's upload and gray pyramid, the annotation) overlaps it. The
        first solve joins it (``_ensure_staged``); a failure there is logged
        and raises again in the first solve. Idempotent; a no-op when
        fast_start is off. Not gated by ``background_compile``: the first
        solve needs the preparation either way."""
        if not self._fast or self._staged:
            return
        if self._staged_thread is not None and self._staged_thread.is_alive():
            return

        def work():
            try:
                self._prepare()
                self._staged = True
            except Exception:
                logging.getLogger(__name__).exception(
                    "prewarm failed (the first solve will retry and surface the error)")

        t = threading.Thread(target=work, daemon=True, name="rtdd-prewarm")
        self._staged_thread = t
        _LIVE_PREWARM_THREADS.add(t)  # joined by the atexit hook above
        t.start()

    def _graph_pool(self):
        """The pipeline's memory pool and capture stream, shared by all its
        graphs (none on the CPU): they replay one after another on one
        stream, and each copies its outputs out before the next can run."""
        if self._pool is None and self.device.type == "cuda":
            self._pool = torch.cuda.graph_pool_handle()
            self._stream = torch.cuda.Stream(self.device)
        return self._pool, self._stream

    def _program_of(self, key):
        """The eager function of the program ``key``: ("solve",),
        ("solve_fx", effect), ("inc",) or ("inc_fx", effect)."""
        if key[0] == "solve":
            return self._solve_eager
        if key[0] == "solve_fx":
            return functools.partial(self._solve_fx_eager, key[1])
        if key[0] == "inc":
            return self._inc_eager
        return functools.partial(self._inc_fx_eager, key[1])

    @staticmethod
    def _key(kind: str, effect: Optional[int]):
        return (kind,) if effect is None else (kind + "_fx", effect)

    def _capture(self, key, args) -> Optional[float]:
        """Capture the program ``key`` for ``args`` unless it exists;
        returns its capture and instantiation seconds (0 on the CPU), or
        None where an argument is not a tensor."""
        if signature(args) is None:
            return None
        if key not in self._aot:
            self._aot[key] = Program(self._program_of(key), args, self.device,
                                     *self._graph_pool(), timer=self.timer)
        return self._aot[key].capture_s

    def capture(self, effect: Optional[int], *args) -> Optional[float]:
        """Capture now, on this thread, the program of ``solve`` (``effect``
        None; ``args`` as ``solve`` takes them) or of ``solve_and_effect``
        for ``effect`` (``args`` as it takes them after the effect), unless
        it exists. Returns its capture and instantiation seconds (0 on the
        CPU). The kick and ``warmup.warm_shape`` call it; a capture that
        fails raises."""
        return self._capture(self._key("solve", effect), args)

    def capture_incremental(self, effect: Optional[int], *args) -> Optional[float]:
        """``capture`` for ``solve_incremental`` (``effect`` None) or
        ``solve_incremental_and_effect``, ``args`` as they take them (the
        centre in any form ``core/incremental.py:device_yx`` takes)."""
        return self._capture(self._key("inc", effect), self._inc_args(args))

    def _kick(self, effect: Optional[int], args) -> None:
        """fast_start's kick: capture the program unless background
        compiles are off. Where the JAX package starts a compile on a
        thread, the capture runs here, synchronously: the caller's thread
        is the one that may launch into the capture stream."""
        if self.background_compile:
            self.capture(effect, *args)

    def _standins(self, effect: Optional[int]):
        """Zero tensors of the pipeline's shapes and dtypes, as
        ``solve_incremental`` (``effect`` None) or
        ``solve_incremental_and_effect`` takes them after the effect: the
        JAX pipeline's ShapeDtypeStructs of its incremental programs."""
        dev, plane = self.device, (self.rows, self.cols)
        sizes = [self.cfg.level_size(self.rows, self.cols, lv) for lv in range(self.levels)]
        gp = tuple(torch.zeros(s, dtype=torch.uint8, device=dev) for s in sizes)
        mv = (torch.zeros(plane, dtype=torch.bool, device=dev),
              torch.zeros(plane, dtype=torch.uint8, device=dev))
        st = tuple(torch.zeros(s, dtype=torch.float32, device=dev) for s in sizes)
        center = torch.zeros(2, dtype=torch.int32, device=dev)
        rgb = () if effect is None else (torch.zeros(plane + (3,), dtype=torch.uint8,
                                                     device=dev),)
        return (gp, *rgb, *mv, st, center)

    def incremental_ready(self, effect: Optional[int] = None, kick: bool = True) -> bool:
        """The live loop's gate (``realtimedepthdiffusion_tpu/pipeline.py:
        564-589``): whether the windowed re-solve's program for ``effect``
        exists. True when ``fast_start`` or background compiles are off (a
        first call then runs eagerly and captures the program itself), and
        once the program exists; else False,
        and with ``kick`` its capture runs now, on this thread, as the
        solve's kick does: one eager run on stand-in tensors of the
        pipeline's shapes, which puts the incremental budgets' iteration
        tables on the card, then the capture from them. ``kick=False``
        only peeks: the live loop peeks before its frame and kicks after
        it."""
        if not self._fast or not self.background_compile:
            return True
        key = self._key("inc", effect)
        if key in self._aot:
            return True
        if kick:
            self._ensure_staged()
            args = self._standins(effect)
            if self.device.type == "cuda":
                self._program_of(key)(*args)
            self._capture(key, args)
        return False

    def wait_fused(self, timeout: Optional[float] = None) -> bool:
        """Block until pending background programs land (warmup and test
        hook); True when none is still pending. The kick captures on the
        caller's thread before it returns, so none ever is."""
        return True

    def _eager(self, fn, args, exit_log):
        with span("program.eager", self.timer):
            out = fn(*args, exit_log)
            if exit_log is not None:
                read_exit_log(exit_log, self.exit_wait)
            return out

    def _route(self, effect: Optional[int], args, exit_log):
        """``realtimedepthdiffusion_tpu/pipeline.py:609-663`` for one
        program of ``solve``: replay it where it exists and the arguments
        match; else run eagerly, and capture where the routing says (the
        module's docstring)."""
        key = self._key("solve", effect)
        fn = self._program_of(key)
        prog = self._aot.get(key)
        with span("program.call", self.timer):
            if prog is not None:
                if prog.matches(args):
                    return prog(args, exit_log, self.exit_wait)
                return self._eager(fn, args, exit_log)
            if self._fast:
                self._ensure_staged()
                out = self._eager(fn, args, exit_log)
                self._staged_solves += 1
                if self._staged_solves >= 2:  # the JAX pipeline's deferral
                    self._kick(effect, args)
                return out
            out = self._eager(fn, args, exit_log)
            self.capture(effect, *args)
            return out

    def _inc_args(self, args):
        *rest, center = args
        return (*rest, device_yx("center_yx", center, self.device))

    def _route_incremental(self, effect: Optional[int], args, exit_log):
        """``realtimedepthdiffusion_tpu/pipeline.py:665-682``: replay the
        windowed re-solve's program where it exists and the arguments
        match, else run eagerly; where no program exists, the call captures
        it at its end (JAX's plain ``jit`` compiles at the first call)."""
        key = self._key("inc", effect)
        fn = self._program_of(key)
        with span("program.call", self.timer):
            args = self._inc_args(args)
            prog = self._aot.get(key)
            if prog is not None and prog.matches(args):
                return prog(args, exit_log, self.exit_wait)
            out = self._eager(fn, args, exit_log)
            if prog is None:
                self._capture(key, args)
            return out

    def _solve_eager(self, gray_pyr, mask0, value0, depth_state, exit_log=None):
        return self._scheme(gray_pyr, mask0, value0, depth_state, self.cfg, exit_log)

    def _inc_eager(self, gray_pyr, mask0, value0, depth_state, center, exit_log=None):
        return solve_incremental(gray_pyr, mask0, value0, depth_state, center, self.cfg,
                                 exit_log)

    def _inc_fx_eager(self, effect, gray_pyr, rgb, mask0, value0, depth_state, center,
                      exit_log=None):
        depth0, state = self._inc_eager(gray_pyr, mask0, value0, depth_state, center, exit_log)
        out = self.effect(effect, rgb, gray_pyr[0], torch.clamp(depth0, 0.0, 255.0))
        return depth0, state, out

    def _solve_fx_eager(self, effect, gray_pyr, rgb, mask0, value0, depth_state, exit_log=None):
        depth0, state = self._solve_eager(gray_pyr, mask0, value0, depth_state, exit_log)
        # The unclamped Chebyshev update can overshoot [0, 255] slightly.
        out = self.effect(effect, rgb, gray_pyr[0], torch.clamp(depth0, 0.0, 255.0))
        return depth0, state, out

    # -- setup and the critical path ----------------------------------------
    def prepare_image(self, rgb_u8) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
        """Upload the (H,W,3) uint8 image once; returns (rgb, gray_pyramid).
        The returned rgb is a copy on every device: a later change of the
        caller's array does not reach it."""
        if isinstance(rgb_u8, np.ndarray):
            rgb_u8 = torch.from_numpy(np.ascontiguousarray(rgb_u8))
        rgb = rgb_u8.to(device=self.device, dtype=torch.uint8, copy=True)
        return rgb, build_gray_pyramid(rgb_to_gray(rgb), self.cfg)

    def initial_state(self) -> Tuple[torch.Tensor, ...]:
        return initial_depth_state(self.rows, self.cols, self.cfg, self.device)

    def level_calls(self, windowed: bool = False):
        """[(h, w, iterations, fused)] of the level solves of one ``solve``
        (the V-cycle's warm cascade; its polish solves no level) or, with
        ``windowed``, of one windowed re-solve, in the order
        ``core/multigrid.py`` and ``core/incremental.py`` run them, each
        with at least one iteration: ``fused`` where
        ``ops/dispatch.py:fused_route`` sends it to K6. Routed on the host
        from the shapes, as the eager solve and so its capture route them;
        nothing here touches the device."""
        cfg = self.cfg
        if not windowed and cfg.multigrid == "vcycle":
            cfg = vcycle_warm_config(cfg)
        inc = cfg.incremental_iterations if cfg.incremental_iterations > 0 else cfg.max_iterations
        calls = []
        for level in range(self.levels - 1, -1, -1):
            h, w = cfg.level_size(self.rows, self.cols, level)
            win = cfg.incremental_window >> level
            if not (windowed and level < cfg.incremental_window_levels and win < min(h, w)):
                calls.append((h, w, cfg.level_iterations(self.levels, level)))
                continue
            iters = max(inc >> level, 1)
            calls.append((h, w, min(int(cfg.incremental_global_smooth), iters)))
            calls.append((win, win, iters))
        return [(h, w, n, dispatch.fused_route(h, w, self.device, cfg.solver))
                for h, w, n in calls if n > 0]

    def solve(self, gray_pyr: Sequence[torch.Tensor], mask0: torch.Tensor,
              value0: torch.Tensor, depth_state: Sequence[torch.Tensor], exit_log=None):
        """Full solve by the scheme ``cfg.multigrid`` names; returns (depth0_f32,
        new_depth_state), eagerly or by replaying its program (the module's
        docstring). Under the early exit a list given as ``exit_log``
        receives each level's iterations and probes
        (``core/solver.py:_chunked_early_exit``), read once after the solve."""
        return self._route(None, (tuple(gray_pyr), mask0, value0, tuple(depth_state)), exit_log)

    def solve_and_effect(self, effect: int, gray_pyr, rgb, mask0, value0, depth_state,
                         exit_log=None):
        """Solve, then the effect on the clipped depth, as one program;
        returns (depth0, new_state, effect_rgb_u8)."""
        return self._route(effect, (tuple(gray_pyr), rgb, mask0, value0, tuple(depth_state)),
                           exit_log)

    def solve_incremental(self, gray_pyr, mask0, value0, depth_state, center_yx,
                          exit_log=None):
        """Windowed warm re-solve around an edit at ``center_yx`` (level-0
        coordinates: a (2,) int32 tensor on the pipeline's device, or host
        integers, a numpy array or a CPU tensor, which are uploaded;
        ``core/incremental.py``); returns (depth0, new_state), eagerly or
        by replaying its program (the module's docstring). ``depth_state``
        comes from an earlier solve and stays valid."""
        return self._route_incremental(
            None, (tuple(gray_pyr), mask0, value0, tuple(depth_state), center_yx), exit_log)

    def solve_incremental_and_effect(self, effect: int, gray_pyr, rgb, mask0, value0,
                                     depth_state, center_yx, exit_log=None):
        """``solve_incremental``, then the effect on the clipped depth, as
        one program; returns (depth0, new_state, effect_rgb_u8)."""
        return self._route_incremental(
            effect, (tuple(gray_pyr), rgb, mask0, value0, tuple(depth_state), center_yx),
            exit_log)

    def update_annotation_window(self, mask_d, value_d, mask_win, value_win, origin):
        """The annotation planes with a dirty window written in at ``origin``
        (host integers), so that the host uploads only the window's bytes.
        An origin that would put the window past an edge is moved inside,
        as ``solve_incremental`` moves its window. Returns new (mask, value)
        planes; the given ones are not changed."""
        h, w = mask_d.shape
        wh, ww = mask_win.shape
        oy, ox = clamp_origin(*host_yx("origin", origin), wh, ww, h, w)
        mask_d, value_d = mask_d.clone(), value_d.clone()
        mask_d[oy:oy + wh, ox:ox + ww] = torch.as_tensor(mask_win).to(mask_d)
        value_d[oy:oy + wh, ox:ox + ww] = torch.as_tensor(value_win).to(value_d)
        return mask_d, value_d

    def effect(self, effect: int, rgb, gray0, depth0) -> torch.Tensor:
        return fx.apply_effect(effect, rgb, gray0, depth0, self.cfg)

    def depth_u8(self, depth0: torch.Tensor) -> torch.Tensor:
        """float32 depth -> uint8 (round half to even, like ``jnp.rint``)."""
        return torch.clamp(torch.round(depth0), 0, 255).to(torch.uint8)

    def depth_u16(self, depth0: torch.Tensor) -> torch.Tensor:
        """float32 depth -> uint16, clip(rint(d * 257), 0, 65535). uint16
        has few ops in torch, so the clip is in float32 and the cast goes
        through int32."""
        u16 = torch.clamp(torch.round(depth0 * 257.0), 0, 65535)
        return u16.to(torch.int32).to(torch.uint16)

    def residuals(self, gray_pyr, mask0, value0, depth_state) -> torch.Tensor:
        """Per-level residuals of a depth state, a (2, levels) float32
        tensor: the max norm in row 0 and the rms in row 1 (the one
        ``residual_metric='rms'`` gates on)."""
        masks, _ = build_annotation_pyramids(mask0, value0, self.cfg)
        L = len(gray_pyr) - 1
        res = []
        for l in range(len(gray_pyr)):
            wts = edge_weights(gray_pyr[l], depth_state[l], l, L, self.cfg)
            res.append(torch.stack([residual_norm(depth_state[l], masks[l], wts),
                                    residual_rms(depth_state[l], masks[l], wts)]))
        return torch.stack(res, dim=1)


@functools.lru_cache(maxsize=8)
def get_pipeline(rows: int, cols: int, cfg: DiffusionConfig = DiffusionConfig(), *,
                 device) -> DepthPipeline:
    """Pipeline cache keyed by (shape, config, device)."""
    return DepthPipeline(rows, cols, cfg, device=device)
