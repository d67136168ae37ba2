"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the reference, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's traffic names its driver (``drivers/session.py``,
``drivers/server.py``); everything else, the reference the comparison
calls too, is found by name from ``BENCHMARK.json`` (``spec.py``). The
last line of stdout is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device``, ``breakdown`` in a traced run, and
last ``checks``: each number compared with its limit, which are also the
last lines of stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from . import check, env, spec, trace
from .drivers.server import ServerRun
from .drivers.session import SessionRun

DRIVERS = {"session": SessionRun, "server": ServerRun}
FORBIDDEN = spec.FORBIDDEN
FORBIDDEN_MODULES = ("realtimedepthdiffusion_tpu_torch.interop",)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_loaded() -> list:
    """The loaded modules whose top-level name, compared whole, is JAX's
    or the JAX package's, and the port's interop module."""
    found = {m for m in sys.modules if m.split(".")[0] in FORBIDDEN}
    found |= {m for m in FORBIDDEN_MODULES if m in sys.modules}
    return sorted(found)


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the first card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_cell(bench: dict, cell: dict, seed: int, seconds: float, traced: bool, device: str,
             t_start: float, cfg=None, traffic=None, limits=None, reference=None):
    """One run of ``cell``; returns the result dict. ``cfg``, ``traffic``,
    ``limits`` and ``reference`` (the module the comparison calls) default
    to the cell's files (the tests pass their own)."""
    import torch

    cfg = cfg or spec.config(bench, cell["config"])
    traffic = traffic or spec.traffic(cell["traffic"])
    limits = limits if limits is not None else spec.limits(cell["name"])
    reference = reference or spec.reference(cell["config"])
    on_card = torch.device(device).type == "cuda"
    tmp = tempfile.mkdtemp(prefix="rtdd-bench-")
    try:
        run = DRIVERS[traffic["driver"]](cfg, traffic, seed, device, tmp, reference)
        if on_card:
            torch.cuda.reset_peak_memory_stats(device)
        t_setup = time.perf_counter()
        run.setup()
        setup_s = time.perf_counter() - t_start
        last = t_start
        for phase, t in [("imports and card", t_setup)] + run.marks:
            print(f"setup: {phase} {t - last:.3f} s", file=sys.stderr)
            last = t
        breakdown = None
        if traced:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            with torch.profiler.profile(activities=acts) as prof:
                rec = run.traced_window()
            rec.update(trace.record(prof.events(), "bench.window", _on_device))
            values = {}
            for m in spec.metrics_of(bench, cell["name"], "per_layer"):
                v = spec.reader(m["name"])(rec)
                if v is not None:
                    values[m["name"]] = (v, m["unit"])
            breakdown = {"device_ops": rec["device_ops"], "idle_gaps": rec["idle_gaps"]}
        else:
            e2e = run.window(seconds)
            e2e["setup_s"] = setup_s
            split = getattr(run, "host_split", None)
            if split:
                print("window: mean update " + ", ".join(
                    f"{k} {v:.4f}" for k, v in split.items()), file=sys.stderr)
            values = {}
            for m in spec.metrics_of(bench, cell["name"], "end_to_end"):
                values[m["name"]] = (e2e[m["name"]], m["unit"])
        if on_card:
            torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) if on_card else 0
        attempted, failed = run.counts()
        run.release()
        numbers = run.check()
        # After the comparison, so that what the reference loads counts too.
        bad = forbidden_loaded()
        if bad:
            raise ForbiddenModules(bad)
        correct, checks = check.verdict(numbers, limits)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if traced:
        dev_info["busy_s"] = rec["busy_s"]
        dev_info["window_s"] = rec["window_s"]
    result = {"correct": correct and failed == 0, "attempted": attempted, "failed": failed,
              "metrics": {k: {"value": v, "unit": u} for k, (v, u) in values.items()},
              "device": dev_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


class ForbiddenModules(RuntimeError):
    pass


def _on_device(e) -> bool:
    """A device operation of the trace; the device-side copies of the
    benchmark's own host spans (user annotations) are none."""
    import torch

    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and not e.name.startswith("bench."))


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"error: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    from realtimedepthdiffusion_tpu_torch.utils.cache import enable_compilation_cache

    enable_compilation_cache(os.path.join(env.CACHE, "kernels"))
    print(f"card: {power_limit()}; peaks 67 TFLOP/s FP32, 3.35 TB/s", file=sys.stderr)
    try:
        result = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), "cuda",
                          t_start)
    except ForbiddenModules as e:
        print(f"error: modules of JAX or the JAX package are loaded: {e.args[0]}",
              file=sys.stderr)
        return 3
    check.print_checks(result["checks"])
    print(json.dumps(result, allow_nan=True))
    sys.stdout.flush()
    return 0
