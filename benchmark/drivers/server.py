"""The ``server`` driver: a folder of annotated photos solved by the
directory server, as ``rtdd-serve-torch --effect b`` runs it.

Set-up makes the traffic's ``pairs`` seeded pairs (``photo_like`` under
``dense_scribbles``) and writes them as PNGs into a directory of
``TMPDIR``, both on ``io_workers`` threads (numpy and zlib release the
GIL; zlib at level 1), and solves the first ``warm_pairs`` of them once.
The window calls ``serve.solve_pairs``
on chunks of ``chunk`` pairs, one after another, with the server's
defaults (``io_workers``, ``prefetch``) and its pipelines kept across
calls, overwriting the same outputs, until ``--seconds`` have passed.
``images_per_s`` is the pairs whose two PNGs are on disk within the
window, over the window's seconds. A traced
run instead makes one call over every pair under the profiler.

The comparison reads back every pair's depth and effect PNG after the
last call and holds each to the reference solved from the fresh state.
"""

from __future__ import annotations

import gc
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import check, gen


class ServerRun:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device: str, tmp: str,
                 reference):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.ref = reference  # the module ``check`` holds the run to (``spec.reference``)
        self.dcfg = dict(cfg["diffusion"])
        self.h, self.w = int(cfg["rows"]), int(cfg["cols"])
        self.device, self.tmp = device, tmp
        self.attempted = 0
        self.failed = 0
        self.marks = []  # (set-up phase, perf_counter at its end)

    def setup(self):
        import torch
        from PIL import Image

        from realtimedepthdiffusion_tpu_torch import serve
        from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
        from realtimedepthdiffusion_tpu_torch.core import effects

        self.torch, self.serve = torch, serve
        n = int(self.traffic["pairs"])
        img_dir, ann_dir = os.path.join(self.tmp, "images"), os.path.join(self.tmp, "annotations")
        self.out_dir = os.path.join(self.tmp, "out")
        for d in (img_dir, ann_dir, self.out_dir):
            os.makedirs(d, exist_ok=True)
        self.pairs = [(os.path.join(img_dir, f"p{k}.png"), os.path.join(ann_dir, f"p{k}.png"))
                      for k in range(n)]
        sentinel = self.dcfg["annotation_sentinel"]

        def make(k):
            rgb, mask, value = gen.pair(self.seed, k, self.h, self.w)
            Image.fromarray(rgb).save(self.pairs[k][0], compress_level=1)
            Image.fromarray(gen.annotation_plane(mask, value, sentinel)).save(
                self.pairs[k][1], compress_level=1)
            return rgb, mask, value

        with ThreadPoolExecutor(int(self.traffic["io_workers"])) as pool:
            self.inputs = list(pool.map(make, range(n)))
        self.marks.append(("inputs", time.perf_counter()))
        self.diffusion = DiffusionConfig(**self.dcfg)
        self.effect = {"b": effects.EFFECT_DEFOCUS, "g": effects.EFFECT_DESATURATION,
                       "h": effects.EFFECT_HAZE}[self.cfg["effect"]]
        self.pipelines = {}
        self._call(self.pairs[:int(self.traffic["warm_pairs"])], None, {})
        self._sync()
        self.marks.append(("warm pairs", time.perf_counter()))

    def _sync(self):
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def _call(self, chunk, progress, stats):
        out = self.serve.solve_pairs(
            chunk, self.out_dir, self.diffusion, effect=self.effect, progress=progress,
            io_workers=int(self.traffic["io_workers"]), prefetch=int(self.traffic["prefetch"]),
            stats_out=stats, pipelines=self.pipelines, device=self.device)
        self.failed += sum(p is None for p in out)
        return out

    def window(self, seconds: float):
        chunk = int(self.traffic["chunk"])
        t0 = time.perf_counter()
        t_end = t0 + seconds
        done = []

        def progress(_src, _dst):
            done.append(time.perf_counter())

        k = 0
        while time.perf_counter() < t_end:
            part = [self.pairs[(k + j) % len(self.pairs)] for j in range(chunk)]
            k += chunk
            self.attempted += len(part)
            self._call(part, progress, {})
        return {"images_per_s": sum(t <= t_end for t in done) / seconds}

    def traced_window(self):
        from torch.profiler import record_function

        stats = {}
        with record_function("bench.window"):
            with record_function("bench.serve"):
                self._call(self.pairs, None, stats)
            self._sync()
        self.attempted += len(self.pairs)
        return {"updates": len(self.pairs), "rows": self.h, "cols": self.w,
                "config": self.dcfg, "pairs": list(stats.values())}

    def release(self):
        self.pipelines = None
        gc.collect()
        if self.torch.device(self.device).type == "cuda":
            self.torch.cuda.empty_cache()

    def check(self, stand_in=None) -> dict:
        """The worst numbers over every pair's PNGs, against the reference
        from the fresh state; with ``stand_in`` the reference at that
        precision takes the program's place (the control)."""
        from PIL import Image

        torch = self.torch
        dev = torch.device(self.device)
        rows, missing = [], 0
        for k, (rgb, mask, value) in enumerate(self.inputs):
            want = self._reference(rgb, mask, value, torch.float32, dev)
            if stand_in is not None:
                got = self._reference(rgb, mask, value, stand_in, dev)
            else:
                dp = os.path.join(self.out_dir, f"p{k}_depth.png")
                ep = os.path.join(self.out_dir, f"p{k}_effect.png")
                if not (os.path.exists(dp) and os.path.exists(ep)):
                    missing += 1
                    continue
                got = (np.asarray(Image.open(dp)), np.asarray(Image.open(ep).convert("RGB")))
            rows.append(check.compare(got[0], got[1], None, want[0], want[1], None, mask, value))
        out = check.worst(rows)
        out["missing"] = float(missing)
        return out

    def _reference(self, rgb_np, mask_np, value_np, dt, dev):
        torch, ref = self.torch, self.ref
        rgb = torch.from_numpy(rgb_np).to(dev)
        grays = ref.gray_pyramid(self.dcfg, ref.rgb_to_gray(rgb))
        masks, values = ref.annotation_pyramids(
            self.dcfg, torch.from_numpy(mask_np).to(dev), torch.from_numpy(value_np).to(dev))
        fresh = [torch.full(tuple(g.shape), float(self.dcfg["depth_init"]), device=dev)
                 for g in grays]
        depth0, _ = ref.cascade(self.dcfg, grays, masks, values, fresh, dt)
        effect = ref.defocus(self.dcfg, rgb, depth0.to(torch.float32))
        return ref.to_u8(depth0).cpu().numpy(), effect.cpu().numpy()

    def counts(self):
        """(pairs handed to ``solve_pairs``, pairs it returned no path for)."""
        return self.attempted, self.failed

