"""The port's bench twins (``bench.py``, ``bench_configs.py`` and
``bench_cold.py`` of ``realtimedepthdiffusion_tpu_torch``) against the JAX
scripts at the repository's root, on the CPU at 96x128.

The twins' inputs equal the JAX scripts' numpy recipes, written out here.
Their frames and config steps equal the JAX steps as the JAX scripts build
them: depth and carried state within RMSE 1e-3 on [0, 1]
(tests/test_golden.py), config 3's weights to ``tests/test_torch_glue.py``'s
rtol 1e-6, the defocus equal to JAX's on a shared depth
(``tests/test_torch_pipeline.py``) and, frame against frame, within a mean
absolute difference of 0.5 (``tests/test_torch_serve.py``). Their records
carry the keys and metric names the JAX scripts print, read from those
scripts' source. The twins raise without a card and import no JAX."""

import ast
import json
import os
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.core import effects as jfx
from realtimedepthdiffusion_tpu.core import multigrid as jmg
from realtimedepthdiffusion_tpu.core.color import rgb_to_gray as jrgb_to_gray
from realtimedepthdiffusion_tpu.core.incremental import solve_incremental as jsolve_incremental
from realtimedepthdiffusion_tpu.core.weights import edge_weights as jedge_weights
from realtimedepthdiffusion_tpu_torch import bench, bench_cold, bench_configs
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import effects as tfx
from realtimedepthdiffusion_tpu_torch.core.weights import EdgeWeights, edge_weights
from tests.conftest import synthetic_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 96, 128
OVER = {"max_iterations": 40, "incremental_window": 32}
CENTER = (48, 64)  # both levels' windows start inside the image, in both packages


def _rmse(a, b):
    return float(np.sqrt(np.mean(((np.asarray(a) - np.asarray(b)) / 255.0) ** 2)))


def _jcfg(**kw):
    return JConfig(backend="xla", fast_start=False, **kw)


def _jax_source(name):
    with open(os.path.join(REPO, name)) as f:
        return ast.parse(f.read())


def _dict_keys(node):
    return [k.value for k in node.keys]


def _printed_dict(tree):
    """The dict literal the script passes to ``json.dumps``."""
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "dumps"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return node.args[0]
    raise AssertionError("no json.dumps of a dict literal")


def _recipe(h, w):
    """bench.py:81-96 (the rng branch) and bench_cold.py:72-81, written out."""
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    mask = np.zeros((h, w), bool)
    value = np.zeros((h, w), np.uint8)
    for i, d in enumerate((0, 64, 128, 192, 254)):
        y, x = 120 + 180 * i, 200 + 320 * i
        mask[y: y + 40, x: x + 60] = True
        value[y: y + 40, x: x + 60] = d
    return rgb, mask, value


# -- inputs ------------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", [(1080, 1920), (2160, 3840), (H, W)])
def test_inputs_equal_the_jax_recipe(h, w, monkeypatch):
    monkeypatch.delenv(bench.IMAGE_ENV, raising=False)
    want = _recipe(h, w)
    rgb, mask, value, source = bench.bench_inputs(h, w)
    assert "default_rng(0)" in source
    for got, cold, wnt in zip((rgb, mask, value), bench.seeded_inputs(h, w), want):
        assert got.dtype == wnt.dtype and np.array_equal(got, wnt)
        assert cold.dtype == wnt.dtype and np.array_equal(cold, wnt)
    assert int(mask.sum()) == (0 if (h, w) == (H, W) else 5 * 40 * 60)  # cut at the edges


@pytest.mark.parametrize("broken", [False, True])
def test_bench_image_is_tiled_or_falls_back(tmp_path, monkeypatch, broken):
    """bench.py:84-87: the dataset image tiled to the size; an image that
    does not decode falls back to the rng recipe."""
    from realtimedepthdiffusion_tpu_torch import io

    path = str(tmp_path / "img.png")
    base = np.random.default_rng(3).integers(0, 256, (40, 50, 3), dtype=np.uint8)
    if broken:
        with open(path, "wb") as f:
            f.write(b"not an image")
    else:
        io.imwrite(path, base)
    monkeypatch.setenv(bench.IMAGE_ENV, path)
    rgb, _, _, source = bench.bench_inputs(H, W)
    want = _recipe(H, W)[0] if broken else np.tile(base, (H // 40 + 1, W // 50 + 1, 1))[:H, :W]
    assert np.array_equal(rgb, want) and (source == path) != broken


# -- the headline frame against bench.py:98-112 ---------------------------------------

@pytest.fixture(scope="module")
def scene():
    return synthetic_pair(H, W, 5)


def test_headline_frames_match_jax(scene):
    rgb, mask, value = scene
    cfg = DiffusionConfig(max_iterations=40, pallas_defocus_quality="exact")
    frame, carry = bench.headline_frame(H, W, cfg, "cpu", scene)
    jcfg = _jcfg(max_iterations=40, pallas_defocus_quality="exact")
    rgb_d, mask_d, value_d = jnp.asarray(rgb), jnp.asarray(mask), jnp.asarray(value)
    gpyr = jmg.build_gray_pyramid(jrgb_to_gray(rgb_d), jcfg)
    jstate = jmg.initial_depth_state(H, W, jcfg)
    for i in range(3):
        carry = frame(carry)
        depth0, jstate = jmg.solve_cascade(gpyr, mask_d, value_d, jstate, jcfg)
        jout = jfx.apply_effect(jfx.EFFECT_DEFOCUS, rgb_d, gpyr[0],
                                jnp.clip(depth0, 0.0, 255.0), jcfg)
        state, out = carry
        assert len(state) == len(jstate)
        for s, js in zip(state, jstate):
            assert _rmse(s.numpy(), js) <= 1e-3, i
        assert np.array_equal(state[0].numpy()[mask], value[mask].astype(np.float32))
        out, jout = out.numpy(), np.asarray(jout)
        assert out.dtype == np.uint8 and out.shape == (H, W, 3)
        assert float(np.abs(out.astype(int) - jout).mean()) <= 0.5, i
        shared = tfx.apply_effect(tfx.EFFECT_DEFOCUS, torch.from_numpy(rgb),
                                  torch.from_numpy(np.array(gpyr[0])),
                                  torch.from_numpy(np.clip(np.asarray(depth0), 0.0, 255.0)), cfg)
        assert np.array_equal(shared.numpy(), jout), i


def test_headline_times_and_logs_on_the_cpu(scene, capsys):
    res = bench.headline(H, W, DiffusionConfig(max_iterations=40), "cpu", scene, k=3, n=1)
    assert res.k == 3 and res.levels == 2 and res.sweeps == 40 + 20
    assert res.ms > 0 and res.t1_ms > 0 and res.tk_ms > 0
    assert res.device == {}  # no device numbers from a CPU run
    err = capsys.readouterr()
    assert err.out == "" and "per-frame" in err.err and "sweeps/frame: 60" in err.err


# -- bench_configs.py's five steps against the JAX steps --------------------------------

@pytest.fixture(scope="module")
def configs(scene):
    rgb, mask, value = scene
    cases = bench_configs.config_cases(rgb, mask, value, "cpu", OVER, CENTER)
    rgb_d, mask_d, value_d = jnp.asarray(rgb), jnp.asarray(mask), jnp.asarray(value)
    gray0 = jrgb_to_gray(rgb_d)
    jcfg1 = _jcfg(solver="jacobi", **OVER)
    gp = jmg.build_gray_pyramid(gray0, jcfg1)

    def cascade_step(cfg):
        return lambda state: jmg.solve_cascade(gp, mask_d, value_d, state, cfg)[1]

    jcfg4 = _jcfg(multigrid="vcycle", **OVER)
    jcfg5 = _jcfg(incremental_iterations=120, **OVER)
    _, warm = jmg.solve_cascade(gp, mask_d, value_d, jmg.initial_depth_state(H, W, jcfg5), jcfg5)
    center = jnp.asarray(CENTER, jnp.int32)

    def live_step(state):
        d0, s = jsolve_incremental(gp, mask_d, value_d, state, center, jcfg5)
        out = jfx.apply_effect(jfx.EFFECT_HAZE, rgb_d, gray0, jnp.clip(d0, 0.0, 255.0), jcfg5)
        s0 = s[0] + out.astype(jnp.float32).mean() * jnp.float32(1e-30)
        return (s0,) + tuple(s[1:])

    jcfg2 = _jcfg(solver="red_black", early_exit=True, tolerance=1e-3,
                  residual_check_every=25, **OVER)
    jax_steps = {
        0: (cascade_step(jcfg1), jmg.initial_depth_state(H, W, jcfg1)),
        1: (cascade_step(jcfg2), jmg.initial_depth_state(H, W, jcfg2)),
        3: (lambda s: jmg.solve_vcycle(gp, mask_d, value_d, s, jcfg4)[1],
            jmg.initial_depth_state(H, W, jcfg4)),
        4: (live_step, warm),
    }
    return cases, jax_steps, gray0, jcfg1


@pytest.mark.parametrize("i", [0, 1, 3, 4])
def test_config_steps_match_jax(configs, scene, i):
    cases, jax_steps, _, _ = configs
    case = cases[i]
    step, state = jax_steps[i]
    got = bench.run_chain(case.step, case.state0, 2)
    for _ in range(2):
        state = step(state)
    assert len(got) == len(state)
    for g, s in zip(got, state):
        assert _rmse(g.numpy(), s) <= 1e-3, case.name
    mask, value = scene[1], scene[2]
    assert np.array_equal(got[0].numpy()[mask], value[mask].astype(np.float32))
    if case.cfg.early_exit:  # every probe clear of the threshold: no knife edge
        exit_log = bench_configs.early_exit_log(case, scene[0], mask, value, "cpu")
        assert exit_log and all(abs(p - e["tol"]) > 0.05 * e["tol"]
                                for e in exit_log for p in e["probes"])


def test_config3_weights_match_jax(configs):
    """Config 3 steps d -> d + edge_weights(gray0, d, 0, 4).inv_count * 1e-9,
    from the initial state and from a depth that varies."""
    cases, _, gray0, jcfg1 = configs
    case = cases[2]
    assert case.k == 64 and tuple(case.state0.shape) == (H, W)
    varied = np.random.default_rng(9).random((H, W)).astype(np.float32) * 300 - 20
    for d in (case.state0.numpy(), varied):
        got = edge_weights(torch.from_numpy(np.array(gray0)), torch.from_numpy(d), 0, 4,
                           case.cfg)
        want = jedge_weights(gray0, jnp.asarray(d), 0, 4, jcfg1)
        for name in EdgeWeights._fields:
            g, wnt = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            np.testing.assert_allclose(g, wnt, rtol=1e-6, atol=0, err_msg=name)
            assert np.array_equal(g == 0, wnt == 0) and np.array_equal(g == 1, wnt == 1), name
        stepped = case.step(torch.from_numpy(d)).numpy()
        np.testing.assert_allclose(stepped, d + np.asarray(want.inv_count) * np.float32(1e-9),
                                   rtol=1e-6, atol=0)


# -- the records ---------------------------------------------------------------------

def test_headline_record_has_the_jax_keys():
    jax_keys = _dict_keys(_printed_dict(_jax_source("bench.py")))
    for ms, quality in ((10.7204, "exact"), (16.0, "approx"), (3.33349, "auto")):
        rec = bench.headline_record("4K", 1937, 6, "NVIDIA H100 80GB HBM3", quality, ms)
        assert list(rec) == jax_keys
        assert rec["unit"] == "ms" and rec["value"] == round(ms, 3)
        assert rec["vs_baseline"] == round(16 / rec["value"], 3)
        assert rec["metric"].startswith(
            "4K solve+defocus ms/frame, worst-case effect (1937 Chebyshev sweeps, 6-level "
            "cascade, 1 NVIDIA H100 80GB HBM3, host launches included")
        assert rec["metric"].endswith(")" if quality == "exact" else f", {quality} defocus)")


def test_config_names_and_records_match_jax(configs):
    tree = _jax_source("bench_configs.py")
    names = [n.args[0].value for n in ast.walk(tree)
             if isinstance(n, ast.Call) and getattr(n.func, "id", None) == "emit"
             and isinstance(n.args[0], ast.Constant)]
    assert list(bench_configs.NAMES) == names
    assert [c.name for c in configs[0]] == names
    assert [c.k for c in configs[0]] == [8, 8, 64, 4, 32]
    rec_keys = next(_dict_keys(n.value) for n in ast.walk(tree)
                    if isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                    and getattr(n.targets[0], "id", None) == "rec")
    assert list(bench_configs.config_record(names[0], 12.3456)) == rec_keys
    extra = bench_configs.config_record(names[3], 17.0, extra={"within_16ms_budget": False})
    assert list(extra) == rec_keys + ["within_16ms_budget"] and extra["value"] == 17.0


def test_configs_emit_five_lines(scene, capsys):
    rgb, mask, value = scene
    recs = bench_configs.run_configs(rgb, mask, value, "cpu", OVER, CENTER, n=1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln) for ln in lines] == recs
    assert [r["metric"] for r in recs] == list(bench_configs.NAMES)
    assert all(np.isfinite(r["value"]) for r in recs) and "within_16ms_budget" in recs[3]


def test_cold_record_has_the_jax_keys(capsys):
    jax_rec = _printed_dict(_jax_source("bench_cold.py"))
    jax_detail = _dict_keys(jax_rec.values[_dict_keys(jax_rec).index("detail")])
    rec = bench_cold.cold_start(H, W, DiffusionConfig(max_iterations=40), "cpu",
                                t_proc=bench_cold.T_PROC)
    assert json.loads(capsys.readouterr().out) == rec
    assert list(rec) == _dict_keys(jax_rec)
    assert set(rec["detail"]) == set(jax_detail) | {"build_s", "load_s", "note"}
    d = rec["detail"]
    # The JAX sequence: wait_fused after one solve returns at once.
    assert d["fused_switch_s"] >= d["time_to_first_depth_s"]
    assert d["build_s"] is None and d["load_s"] is None
    assert rec["unit"] == "s" and rec["value"] == d["time_to_first_depth_s"] > 0
    assert rec["vs_baseline"] == round(5.0 / max(d["first_solve_s"], 1e-9), 3)


def test_headline_cold_record_failure_is_logged(capsys):
    """bench.py:183-211 without the file: a cold twin that fails in its
    fresh process (here a card asked for where there is none) is logged and
    gives None, and BENCH_COLD.json, the TPU's record, is never written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    record = os.path.join(REPO, "BENCH_COLD.json")
    before = open(record, "rb").read()
    assert bench.record_cold_start("cuda") is None
    err = capsys.readouterr().err
    assert "cold-start bench failed" in err and "no CUDA device" in err
    assert open(record, "rb").read() == before


# -- no card, no JAX ---------------------------------------------------------------------

@pytest.mark.parametrize("module", [bench, bench_configs, bench_cold])
def test_main_raises_without_a_card(module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


def test_twins_run_without_jax():
    """With jax, the JAX package and the root bench scripts unimportable,
    the three twins import and the cold twin runs at 96x128 on the CPU."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "realtimedepthdiffusion_tpu", "bench", "bench_configs",
                     "bench_cold"):
            sys.modules[name] = None
        from realtimedepthdiffusion_tpu_torch import bench, bench_configs, bench_cold
        from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
        bench_cold.cold_start({H}, {W}, DiffusionConfig(max_iterations=40), "cpu")
        assert not any(m.startswith("jax") for m, v in sys.modules.items() if v is not None)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    detail = json.loads(lines[0])["detail"]
    assert detail["fused_switch_s"] >= detail["time_to_first_depth_s"]
