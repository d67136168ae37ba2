"""The ``session`` driver: one user editing one photo live, closed loop.

One update is what the GUI does each tick under ``--live`` with an effect
latched (``live/gui.py``): the traffic's ``paint(x, y)`` events go to
``DepthSession.paint``, then ``DepthSession.solve()`` returns the u8 depth
map, then the effect image is read back to the host (``session.artistic``).
The next update starts when this one has returned.

Set-up: the seeded photo and annotation (a PNG the session loads), the
effect key, the traffic's presses of '+' (``brush_steps``), the first
solve (eager), the second (it captures the solve's graph), then
``warm_updates`` updates of the traffic itself (the first
closes the windowed path's gate and captures its graph, the next replays
it). The window runs the traffic's later updates until ``--seconds`` have
passed; a traced run instead runs ``trace_updates`` of them under the
profiler.

The comparison (``check``) covers the first solve, from the fresh state,
and ``check_updates`` window updates drawn from the seed (reservoir
sampling, so that any update of the window may be drawn) plus the last:
each from the program's own depth state before it, which the reference
cannot follow through thousands of updates. The reference paints every
stroke event again on its own planes.
"""

from __future__ import annotations

import contextlib
import gc
import os
import statistics
import time

import numpy as np

from .. import check, gen


class SessionRun:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, tmp: str,
                 reference):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.ref = reference  # the module ``check`` holds the run to (``spec.reference``)
        self.host_split = {}  # the window's mean update, phase by phase (ms)
        self.dcfg = dict(cfg["diffusion"])
        self.h, self.w = int(cfg["rows"]), int(cfg["cols"])
        self.device, self.tmp = device, tmp
        self.samples = []  # [index, state before, u8, effect, state after]
        self.last = None
        self.latencies, self.paint_s, self.readback_s = [], [], []
        self.marks = []  # (set-up phase, perf_counter at its end)
        self.attempted = 0

    # ---------------------------------------------------------------- set-up
    def setup(self):
        import torch
        from PIL import Image

        from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
        from realtimedepthdiffusion_tpu_torch.live.session import DepthSession

        rng = np.random.default_rng(self.seed % (1 << 64))
        h, w = self.h, self.w
        self.rgb = gen.photo_like(rng, h, w)
        self.mask0, self.value0 = gen.dense_scribbles(rng, h, w)
        n = int(self.traffic["max_updates"])
        self.keys, self.events = gen.strokes(rng, h, w, self.traffic, n)
        self.pick = np.random.default_rng([self.seed % (1 << 64), 1])
        path = os.path.join(self.tmp, "annotation.png")
        Image.fromarray(gen.annotation_plane(self.mask0, self.value0,
                                             self.dcfg["annotation_sentinel"])).save(path)
        self.marks.append(("inputs", time.perf_counter()))
        self.torch = torch
        s = DepthSession(self.rgb, DiffusionConfig(**self.dcfg), device=self.device)
        s.load_annotation_file(path)
        s.set_effect_key(self.cfg["effect"])
        for _ in range(int(self.traffic.get("brush_steps", 0))):
            s.adjust_radius(+2)
        self.session = s
        self.marks.append(("session", time.perf_counter()))
        u8 = s.solve()
        self.start = (u8, s.artistic.cpu().numpy(), s.depth_state)
        self.marks.append(("first solve", time.perf_counter()))
        s.solve()
        s.artistic.cpu().numpy()
        self.marks.append(("second solve", time.perf_counter()))
        self.next = 0
        for _ in range(int(self.traffic["warm_updates"])):
            self._update()
        self._sync()
        self.marks.append(("warm updates", time.perf_counter()))

    def _sync(self):
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def _update(self, span=None):
        """One update; returns (index, u8, effect, latency s)."""
        span = span or contextlib.nullcontext
        s, i = self.session, self.next
        if i >= len(self.keys):
            raise RuntimeError(f"the traffic ran out of its {len(self.keys)} updates")
        self.next += 1
        t0 = time.perf_counter()
        s.set_color_key(int(self.keys[i]))
        with span("bench.paint"):
            for x, y in self.events[i].tolist():
                p0 = time.perf_counter()
                s.paint(x, y)
                self.paint_s.append(time.perf_counter() - p0)
        with span("bench.solve"):
            u8 = s.solve()
        with span("bench.readback"):
            r0 = time.perf_counter()
            art = s.artistic.cpu().numpy()
            t1 = time.perf_counter()
        self.readback_s.append(t1 - r0)
        return i, u8, art, t1 - t0

    # ---------------------------------------------------------------- window
    def window(self, seconds: float):
        """Updates until ``seconds`` have passed; returns the end-to-end
        metrics."""
        k = int(self.traffic["check_updates"])
        self.session.timer.reset()
        self.paint_s.clear()
        self.readback_s.clear()
        t0 = time.perf_counter()
        t_end = t0 + seconds
        j = 0
        while time.perf_counter() < t_end:
            before = self.session.depth_state
            i, u8, art, lat = self._update()
            self.latencies.append(lat)
            self.attempted += 1
            row = [i, before, u8, art, self.session.depth_state]
            if j < k:
                self.samples.append(row)
            else:
                r = int(self.pick.integers(0, j + 1))
                if r < k:
                    self.samples[r] = row
            self.last = row
            j += 1
        wall = time.perf_counter() - t0
        lat = self.latencies
        n, stages = len(lat), self.session.timer.totals
        self.host_split = {"paint_ms": sum(self.paint_s) / n * 1e3,
                           "upload_ms": stages["upload"] / n * 1e3,
                           "solve_ms": stages["solve"] / n * 1e3,
                           "readback_ms": sum(self.readback_s) / n * 1e3}
        # the 95th percentile, between the two nearest ranks (numpy's linear)
        p95 = statistics.quantiles(lat, n=20, method="inclusive")[18] if len(lat) > 1 else lat[0]
        return {"update_ms": wall / len(lat) * 1e3, "update_p95_ms": p95 * 1e3}

    def traced_window(self):
        """``trace_updates`` updates, run under a started profiler, each
        phase in a span of its own; returns the record the readers read."""
        from torch.profiler import record_function

        n = int(self.traffic["trace_updates"])
        self.session.timer.reset()
        self.paint_s.clear()
        self.readback_s.clear()
        with record_function("bench.window"):
            for _ in range(n):
                before = self.session.depth_state
                i, u8, art, _ = self._update(record_function)
                self.last = [i, before, u8, art, self.session.depth_state]
                self.attempted += 1
            self._sync()
        timer = self.session.timer
        return {"updates": n, "rows": self.h, "cols": self.w, "config": self.dcfg,
                "spans": {"paint": list(self.paint_s), "readback": list(self.readback_s)},
                "stages": {k: (timer.totals[k], timer.counts[k]) for k in timer.totals}}

    def release(self):
        """Drop the session, its pipelines and graphs; the held samples stay."""
        self.session = None
        gc.collect()
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.empty_cache()

    # ----------------------------------------------------------------- check
    def check(self, stand_in=None) -> dict:
        """The worst numbers over the first solve and the drawn updates.
        With ``stand_in`` (a torch dtype) the reference at that precision
        takes the program's place (the control)."""
        torch, ref = self.torch, self.ref
        dev = torch.device(self.device)
        rgb = torch.from_numpy(self.rgb).to(dev)
        grays = ref.gray_pyramid(self.dcfg, ref.rgb_to_gray(rgb))
        sizes = [tuple(g.shape) for g in grays]
        radius = gen.brush_side(ref.brush_radius(self.dcfg, self.h, self.w), self.traffic)
        kmax = max(int(self.dcfg["incremental_max_rects"]), 1)
        s_win = min(int(self.dcfg["incremental_window"]), self.h, self.w)
        inc = int(self.dcfg["incremental_iterations"])
        mask, value = self.mask0.copy(), self.value0.copy()

        def solve(state, rects, first, dt):
            m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
            masks, values = ref.annotation_pyramids(self.dcfg, m, v)
            args = (self.dcfg, grays, masks, values)
            fits = all(r[2] - r[0] + 1 <= s_win and r[3] - r[1] + 1 <= s_win for r in rects)
            if not first and inc > 0 and rects and len(rects) <= kmax and fits:
                for r in rects:
                    depth0, state = ref.windowed(*args, state,
                                                 ((r[0] + r[2]) // 2, (r[1] + r[3]) // 2), dt)
            else:
                depth0, state = ref.cascade(*args, state, dt,
                                            max_iterations=None if first or inc == 0 else inc)
            effect = ref.defocus(self.dcfg, rgb, depth0.to(torch.float32))
            return ref.to_u8(depth0).cpu().numpy(), effect.cpu().numpy(), state

        def judge(state_before, rects, first, got):
            want = solve(state_before, rects, first, torch.float32)
            if stand_in is not None:
                got = solve(state_before, rects, first, stand_in)
            u8, art, st = got
            st = [t.to(dev, torch.float32) for t in st]
            return check.compare(u8, art, st, want[0], want[1], want[2], mask, value)

        fresh = [torch.full(s, float(self.dcfg["depth_init"]), dtype=torch.float32, device=dev)
                 for s in sizes]
        rows = [judge(fresh, [], True, self.start)]
        todo = sorted({r[0]: r for r in self.samples + [self.last]}.values(), key=lambda r: r[0])
        i = 0
        for idx, before, u8, art, after in todo:
            while i <= idx:
                color = ref.scribble_value(self.keys[i])
                rects = []
                for x, y in self.events[i].tolist():
                    r = ref.paint(mask, value, x, y, color, radius)
                    if r is not None:
                        ref.merge_rect(rects, r, kmax)
                i += 1
            rows.append(judge([t.to(dev) for t in before], rects, False, (u8, art, after)))
        return check.worst(rows)

    def counts(self):
        """(updates attempted in the window, updates failed): a failed
        update raises."""
        return self.attempted, 0

