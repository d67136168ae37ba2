"""The harness end to end on the CPU at a small size: the result line, the
reference against the port's session and server, the control and the
planted faults, the throwaway mix added as new files, and no JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import check, harness, spec
from benchmark.tests import small

from realtimedepthdiffusion_tpu_torch.pipeline import DepthPipeline

CELLS = [w["name"] for w in spec.load()["workloads"]]
REPO = str(spec.ROOT)


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(cell):
    res = small.run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    limits = spec.limits(cell)
    assert set(res["checks"]) == set(limits)


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    res = small.run("faithful_1080p.strokes", traced=traced)
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    names = set(res["metrics"])
    if traced:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert {"paint_us", "upload_ms", "readback_ms"} <= names
    else:
        assert names == {"update_ms", "update_p95_ms", "setup_s"}
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    json.dumps(res, allow_nan=False)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    """The reference in bfloat16, put in the program's place, fails a limit."""
    from benchmark import control

    bench = spec.load()
    c = spec.cell(bench, cell)
    (_, _, prog, _), (_, _, ctl, _) = control.readings(
        cell, [2**35 + 1], 0.3, device="cpu", cfg=small.config(c), traffic=small.traffic(c))
    assert check.verdict(prog, spec.limits(cell))[0]
    assert not check.verdict(ctl, spec.limits(cell))[0], ctl


def _unchanged(self, effect, gray_pyr, rgb, mask0, value0, depth_state, *a, **kw):
    """A step that returns its state unchanged."""
    state = tuple(depth_state)
    return state[0], state, self.effect(effect, rgb, gray_pyr[0], state[0].clamp(0, 255))


def _altered_u8(self, depth0):
    """The u8 map with a 16 x 16 block inverted where it is produced."""
    u8 = torch.clamp(torch.round(depth0), 0, 255).to(torch.uint8)
    u8[40:56, 60:76] = 255 - u8[40:56, 60:76]
    return u8


FAULTS = [
    ("faithful_1080p.strokes", "solve_and_effect", _unchanged),
    ("fast_1080p.strokes", "solve_incremental_and_effect", _unchanged),
    ("fast_1080p.spread", "solve_and_effect", _unchanged),
    ("faithful_1080p.batch", "solve_and_effect", _unchanged),
] + [(cell, "depth_u8", _altered_u8) for cell in CELLS]


@pytest.mark.parametrize("cell,method,fault", FAULTS,
                         ids=[f"{c}-{m}" for c, m, _ in FAULTS])
def test_fault_is_not_correct(cell, method, fault, monkeypatch):
    monkeypatch.setattr(DepthPipeline, method, fault)
    res = small.run(cell)
    assert not res["correct"], res["checks"]


def test_missing_output_is_not_correct(monkeypatch):
    from realtimedepthdiffusion_tpu_torch import serve

    real = serve.imwrite

    def drop_one(path, arr, png_level=None):
        if not path.endswith("p1_effect.png"):
            real(path, arr, png_level=png_level)

    monkeypatch.setattr(serve, "imwrite", drop_one)
    res = small.run("faithful_1080p.batch")
    assert not res["correct"] and res["checks"]["missing"]["value"] == 1


def test_throwaway_mix_is_files_only(tmp_path):
    """A new traffic mix, its limits and a new per-layer metric are new
    files plus new BENCHMARK.json entries: no file the benchmark has
    changes, and the harness runs the new cell."""
    here = spec.HERE
    tag = f"throwaway_{os.getpid()}"
    before = {p: p.read_bytes() for p in here.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    new = [here / "traffic" / f"{tag}.json", here / "limits" / f"faithful_1080p.{tag}.json",
           here / "metrics" / f"{tag}_paints.py"]
    try:
        t = dict(small.traffic({"traffic": "strokes"}), events=2, step_min=3, step_max=4)
        new[0].write_text(json.dumps(t))
        new[1].write_text(json.dumps(spec.limits("faithful_1080p.strokes")))
        new[2].write_text("def read(rec):\n    return float(len(rec['spans']['paint']))\n")
        bench = spec.load()
        cell = {"name": f"faithful_1080p.{tag}", "config": "faithful_1080p", "traffic": tag,
                "chips": 1, "why": "a throwaway mix"}
        bench["workloads"].append(cell)
        bench["per_layer"].append({"name": f"{tag}_paints", "unit": "paints",
                                   "better": "lower", "source": "host_clock", "layer": "test",
                                   "moves": "update_ms", "workloads": [cell["name"]]})
        # The mix and the limits are found by name from the new files.
        res = harness.run_cell(bench, cell, 5, 0.5, True, "cpu", 0.0, cfg=small.config(cell))
        assert res["correct"]
        assert res["metrics"][f"{tag}_paints"]["value"] == 2 * t["trace_updates"]
        after = {p: p.read_bytes() for p in before}
        assert after == before
    finally:
        for p in new:
            p.unlink(missing_ok=True)


def test_no_jax_is_loaded():
    """A dry run of the harness's pieces in a fresh process loads no module
    whose top-level name is jax, jaxlib, flax or the JAX package, compared
    whole, nor the port's interop."""
    code = (
        "import sys\n"
        "from benchmark.tests import small\n"
        "from benchmark import harness, control\n"
        "for cell in ('faithful_1080p.strokes', 'faithful_1080p.batch'):\n"
        "    small.run(cell, traced=True)\n"
        "mods = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'realtimedepthdiffusion_tpu_torch' in mods\n"
        "print(harness.forbidden_loaded())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=600, env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    monkeypatch.setitem(sys.modules, "realtimedepthdiffusion_tpu_torch.x", object())
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "realtimedepthdiffusion_tpu.pipeline", object())
    assert harness.forbidden_loaded() == ["realtimedepthdiffusion_tpu.pipeline"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the benchmark measures the port on the card")


@pytest.mark.cuda
def test_command_on_the_card(card, tmp_path):
    """The command as the driver runs it, briefly, on the card."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "faithful_1080p.strokes", "--seed", str(2**31 + 11), "--seconds", "2",
                          "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert np.isfinite(res["metrics"]["update_ms"]["value"])
