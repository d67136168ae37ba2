"""The port's directory server (``serve.py``) against the JAX package's.

Twins of every serve test of tests/test_serve_and_incremental.py, on the
port with ``--device cpu`` (the same ``slow`` markers), and where the two
servers can read the same directory, both run on it: the same file set and
manifest keys (the port's manifest adds ``device``), ``depth16`` within
RMSE 1e-3 on [0, 1], the u8 depth within one gray level of the rounded
16-bit map with the scribbled pixels exact, and the effect within a mean
absolute difference of 0.5. Besides: the watch-mode give-up on a broken
image that shares its stem with a solved one (the JAX server deletes the
solved pair's outputs, the port keeps them, and where the given-up image
wrote them last, removes them and solves the sibling again), the
asynchronous pipeline
against the sequential one, bit for bit, multichip on an 8-slot CPU mesh
against sequential, and one run in a subprocess where jax, PIL and cv2 do
not import."""

import json
import os
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu import io as jio
from realtimedepthdiffusion_tpu.serve import main as jax_serve_main
from realtimedepthdiffusion_tpu_torch import io
from realtimedepthdiffusion_tpu_torch import serve as serve_mod
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import effects as fx
from realtimedepthdiffusion_tpu_torch.serve import (discover_pairs, solve_pairs,
                                                    solve_pairs_multichip)
from tests.conftest import synthetic_pair

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def serve_main(argv):
    return serve_mod.main(list(argv) + ["--device", "cpu"])


def _dirs(d):
    os.makedirs(os.path.join(d, "images"), exist_ok=True)
    os.makedirs(os.path.join(d, "annotations"), exist_ok=True)


def _write_pair(d, name, h, w, seed):
    rgb, mask, value = synthetic_pair(h, w, seed)
    io.imwrite(os.path.join(d, "images", f"{name}.png"), rgb)
    io.save_annotation(os.path.join(d, "annotations", f"{name}.png"), mask, value)
    return rgb, mask, value


def _dir_args(d):
    return ["--images", os.path.join(d, "images"), "--annotations", os.path.join(d, "annotations")]


def _watch_args(d, *extra):
    return [*_dir_args(d), "--out", os.path.join(d, "out"), "--backend", "xla",
            "--watch", "--poll-interval", "0.1", *extra]


def _png(path):
    with open(path, "rb") as f:
        return io.png_decode(f.read())


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def _spy_pipelines(monkeypatch):
    """Record the (rows, cols) of every DepthPipeline built."""
    import realtimedepthdiffusion_tpu_torch.pipeline as pipeline_mod

    built = []
    real = pipeline_mod.DepthPipeline

    class Spy(real):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            built.append((args[0], args[1]))

    monkeypatch.setattr(pipeline_mod, "DepthPipeline", Spy)
    return built


def _wait_for(path, timeout=30.0):
    deadline = time.time() + timeout
    while not os.path.exists(path) and time.time() < deadline:
        time.sleep(0.05)
    time.sleep(0.3)  # let the write settle past the poll in flight


# -- the port against the JAX server on the same directory ----------------------------

@pytest.fixture(scope="module")
def both_servers(tmp_path_factory):
    """Both servers over one directory of three pairs (two shapes), with the
    defocus, the 16-bit map and a manifest. Not 64x80: its defocus kernel
    is 2 wide, so a pixel blurs only at depth 255 exactly, where the
    Chebyshev overshoot clipped to 255 sits against 254.999 on the other
    package, and the effect compares a knife edge."""
    d = str(tmp_path_factory.mktemp("serve"))
    _dirs(d)
    for name, (h, w), seed in [("a", (96, 128), 1), ("b", (96, 128), 2), ("c", (72, 96), 3)]:
        _write_pair(d, name, h, w, seed)
    argv = [*_dir_args(d), "--effect", "b", "--depth16", "--iterations", "40",
            "--backend", "xla"]
    jout, tout = os.path.join(d, "jax"), os.path.join(d, "port")
    assert jax_serve_main(argv + ["--out", jout, "--report", os.path.join(d, "jax.json")]) == 0
    assert serve_main(argv + ["--out", tout, "--report", os.path.join(d, "port.json")]) == 0
    return d, jout, tout


def test_serve_matches_jax_files_and_manifest(both_servers):
    d, jout, tout = both_servers
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout)) == sorted(
        f"{n}_{k}.png" for n in "abc" for k in ("depth", "depth16", "effect"))
    jrep, trep = (json.load(open(os.path.join(d, f))) for f in ("jax.json", "port.json"))
    assert set(trep) == set(jrep)
    assert set(trep["config"]) - set(jrep["config"]) == {"device"}
    assert trep["config"]["device"] == "cpu"
    assert {k: v for k, v in trep["config"].items() if k != "device"} == jrep["config"]
    assert trep["counts"] == jrep["counts"] == {"total": 3, "solved": 3, "skipped_existing": 0,
                                                 "failed": 0}
    for je, te in zip(jrep["pairs"], trep["pairs"]):
        assert set(te) == set(je)
        assert te["image"] == je["image"] and te["status"] == je["status"] == "solved"
        assert os.path.basename(te["depth"]) == os.path.basename(je["depth"])


@pytest.mark.parametrize("name,shape,seed", [("a", (96, 128), 1), ("b", (96, 128), 2),
                                             ("c", (72, 96), 3)])
def test_serve_outputs_match_jax(both_servers, name, shape, seed):
    _, jout, tout = both_servers
    _, mask, value = synthetic_pair(*shape, seed)
    d16, j16 = (_png(os.path.join(o, f"{name}_depth16.png")) for o in (tout, jout))
    assert d16.dtype == np.uint16 and d16.shape == shape
    assert float(np.sqrt(np.mean(((d16.astype(float) - j16) / 65535.0) ** 2))) <= 1e-3
    d8 = io.imread_gray(os.path.join(tout, f"{name}_depth.png"))
    assert np.array_equal(d8[mask], value[mask])
    assert np.abs(d8.astype(int) - (d16.astype(int) + 128) // 257).max() <= 1
    art, jart = (io.imread_rgb(os.path.join(o, f"{name}_effect.png")).astype(int)
                 for o in (tout, jout))
    assert float(np.abs(art - jart).mean()) <= 0.5


# -- twins of tests/test_serve_and_incremental.py ------------------------------------

def test_serve_directory_mode(tmp_path):
    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "a", 64, 80, 1)
    _write_pair(d, "b", 64, 80, 2)  # same shape: pipeline reused
    _write_pair(d, "c", 72, 96, 3)  # new shape: second pipeline
    pairs = discover_pairs(os.path.join(d, "images"), os.path.join(d, "annotations"))
    assert len(pairs) == 3

    out = os.path.join(d, "out")
    assert serve_main([*_dir_args(d), "--out", out, "--effect", "h", "--backend", "xla"]) == 0
    for name in ("a", "b", "c"):
        assert os.path.exists(os.path.join(out, f"{name}_depth.png"))
        assert os.path.exists(os.path.join(out, f"{name}_effect.png"))
    # depth respects a scribble
    _, mask, value = synthetic_pair(64, 80, 1)
    dm = io.imread_gray(os.path.join(out, "a_depth.png"))
    ys, xs = np.nonzero(mask)
    assert abs(int(dm[ys[0], xs[0]]) - int(value[ys[0], xs[0]])) <= 1


def test_serve_requires_input(capsys):
    assert serve_main(["--out", "/tmp/x"]) == 2


def test_serve_watch_new_and_updated_pairs(tmp_path):
    """--watch: a pair dropped in AFTER the initial scan is picked up, an
    annotation rewritten on disk re-solves its pair, and the service exits 0
    via --idle-exit. The manifest covers every pair ever seen."""
    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "a", 64, 80, 1)
    out = os.path.join(d, "out")
    depth_a1 = {}

    def later():
        _wait_for(os.path.join(out, "a_depth.png"))
        depth_a1["v"] = io.imread_gray(os.path.join(out, "a_depth.png")).copy()
        _write_pair(d, "b", 64, 80, 2)  # same shape: pipeline reuse
        _rgb, mask, value = synthetic_pair(64, 80, 1)
        io.save_annotation(os.path.join(d, "annotations", "a.png"), mask,
                           np.where(mask, 254 - value, 0).astype(np.uint8))

    t = threading.Thread(target=later)
    t.start()
    rc = serve_main(_watch_args(d, "--idle-exit", "1.5", "--report", os.path.join(d, "rep.json")))
    t.join(timeout=60)
    assert not t.is_alive()
    assert rc == 0
    assert os.path.exists(os.path.join(out, "b_depth.png"))
    assert not np.array_equal(depth_a1["v"], io.imread_gray(os.path.join(out, "a_depth.png")))
    rep = json.load(open(os.path.join(d, "rep.json")))
    by = {os.path.basename(e["image"]): e for e in rep["pairs"]}
    assert by["a.png"]["status"] == "solved"
    assert by["b.png"]["status"] == "solved"
    assert rep["counts"]["total"] == 2


def test_serve_watch_reuses_pipelines_and_gives_up_on_bad_file(tmp_path, monkeypatch):
    """--watch keeps per-shape pipelines resident across batches and a pair
    whose decode keeps failing is retried then recorded 'failed' without
    killing the service (exit code 1 flags it)."""
    built = _spy_pipelines(monkeypatch)
    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "a", 64, 80, 1)
    for sub in ("images", "annotations"):
        with open(os.path.join(d, sub, "bad.png"), "wb") as f:
            f.write(b"not a png")
    out = os.path.join(d, "out")

    def later():
        _wait_for(os.path.join(out, "a_depth.png"))
        _write_pair(d, "c", 64, 80, 3)  # same shape, second batch

    t = threading.Thread(target=later)
    t.start()
    rc = serve_main(_watch_args(d, "--idle-exit", "1.5", "--report", os.path.join(d, "rep.json")))
    t.join(timeout=60)
    assert rc == 1
    assert os.path.exists(os.path.join(out, "a_depth.png"))
    assert os.path.exists(os.path.join(out, "c_depth.png"))
    assert built.count((64, 80)) == 1  # resident across batches
    by = {os.path.basename(e["image"]): e
          for e in json.load(open(os.path.join(d, "rep.json")))["pairs"]}
    assert by["bad.png"]["status"] == "failed"
    assert by["a.png"]["status"] == "solved"
    assert by["c.png"]["status"] == "solved"


def test_serve_watch_gave_up_pair_not_reported_solved(tmp_path):
    """The --watch manifest reports the LATEST status: a pair that solved
    once and was then overwritten with an undecodable file ends 'failed',
    and its stale outputs leave the disk."""
    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "a", 64, 80, 1)
    out = os.path.join(d, "out")

    def later():
        _wait_for(os.path.join(out, "a_depth.png"))
        with open(os.path.join(d, "images", "a.png"), "wb") as f:
            f.write(b"not a png")

    t = threading.Thread(target=later)
    t.start()
    rc = serve_main(_watch_args(d, "--idle-exit", "1.5", "--report", os.path.join(d, "rep.json")))
    t.join(timeout=60)
    assert rc == 1
    rep = json.load(open(os.path.join(d, "rep.json")))
    by = {os.path.basename(e["image"]): e for e in rep["pairs"]}
    assert by["a.png"]["status"] == "failed", by["a.png"]
    assert by["a.png"]["depth"] is None
    assert rep["counts"]["failed"] == 1
    assert not os.path.exists(os.path.join(out, "a_depth.png"))


def test_trim_pipelines_lru():
    from collections import OrderedDict

    from realtimedepthdiffusion_tpu_torch.serve import _trim_pipelines

    pipes = OrderedDict([((1, 1), "a"), ((2, 2), "b"), ((3, 3), "c")])
    pipes.move_to_end((1, 1))  # (1,1) most recently used
    assert _trim_pipelines(pipes, 2) == [(2, 2)]
    assert list(pipes) == [(3, 3), (1, 1)]
    assert _trim_pipelines(pipes, 8) == []  # under cap: no-op
    assert _trim_pipelines(pipes, 0) == [(3, 3)]  # floored at 1
    assert list(pipes) == [(1, 1)]


def test_serve_watch_max_shapes_evicts_and_rebuilds(tmp_path, monkeypatch):
    """--watch --max-shapes 1: a second image shape evicts the first's
    resident pipeline after its batch; the first shape seen again gets a
    NEW pipeline."""
    built = _spy_pipelines(monkeypatch)
    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "a", 64, 80, 1)
    out = os.path.join(d, "out")

    def later():
        _wait_for(os.path.join(out, "a_depth.png"))
        _write_pair(d, "b", 72, 96, 2)  # new shape: evicts (64, 80)
        _wait_for(os.path.join(out, "b_depth.png"))
        _write_pair(d, "c", 64, 80, 3)  # first shape again: rebuilt

    t = threading.Thread(target=later)
    t.start()
    rc = serve_main(_watch_args(d, "--idle-exit", "1.5", "--max-shapes", "1"))
    t.join(timeout=60)
    assert rc == 0
    for name in ("a", "b", "c"):
        assert os.path.exists(os.path.join(out, f"{name}_depth.png"))
    assert built.count((64, 80)) == 2
    assert built.count((72, 96)) == 1


@pytest.mark.slow
def test_serve_watch_shared_stem_settles(tmp_path, capsys):
    """--watch: a.jpg + a.png sharing a stem are distinct pairs with
    distinct signatures; each solves once and the service goes idle."""
    d = str(tmp_path)
    _dirs(d)
    rgb, _m, _v = _write_pair(d, "a", 64, 80, 1)
    jio.imwrite(os.path.join(d, "images", "a.jpg"), rgb)  # a JPEG (Pillow)
    os.utime(os.path.join(d, "images", "a.jpg"), (time.time() - 10, time.time() - 10))
    done = {}

    def run():
        done["rc"] = serve_main(_watch_args(d, "--idle-exit", "1.0"))

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), "watch service kept re-solving a settled pair"
    assert done["rc"] == 0
    assert os.path.exists(os.path.join(d, "out", "a_depth.png"))
    lines = [ln for ln in capsys.readouterr().out.splitlines() if " -> " in ln]
    assert len(lines) == 2


def _serve_process(d, *extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "realtimedepthdiffusion_tpu_torch.serve", *_dir_args(d),
         "--out", os.path.join(d, "out"), "--backend", "xla", "--watch", "--device", "cpu",
         *extra],
        env=env, cwd=d, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.mark.slow
def test_serve_watch_sigterm_writes_manifest(tmp_path):
    """--watch: SIGTERM exits through the Ctrl-C path: final manifest
    written, exit code 0."""
    import signal

    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "a", 64, 80, 1)
    out, rep = os.path.join(d, "out"), os.path.join(d, "rep.json")
    proc = _serve_process(d, "--poll-interval", "0.2", "--report", rep)
    try:
        deadline = time.time() + 120
        while not os.path.exists(os.path.join(out, "a_depth.png")):
            assert time.time() < deadline, "first solve never landed"
            assert proc.poll() is None, proc.communicate()
            time.sleep(0.1)
        time.sleep(0.5)
        proc.send_signal(signal.SIGTERM)
        _stdout, stderr = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, (proc.returncode, stderr[-2000:])
    assert "interrupted, exiting" in stderr
    assert json.load(open(rep))["pairs"][0]["status"] == "solved"


def test_serve_watch_flag_validation(capsys):
    base = ["--out", "/tmp/x", "--watch", "--images", "i", "--annotations", "a"]
    with pytest.raises(SystemExit):
        serve_main(["--out", "/tmp/x", "--watch"])  # needs directories
    for extra in (["--multichip"], ["--poll-interval", "0"], ["--max-shapes", "0"],
                  ["--png-level", "12"]):
        with pytest.raises(SystemExit):
            serve_main(base + extra)


def test_serve_leaves_no_thread_running(tmp_path):
    """The port has no background compile to turn off; what stands in for
    the JAX test: no thread the run started outlives it."""
    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "a", 64, 80, 1)
    _write_pair(d, "b", 72, 96, 2)
    before = set(threading.enumerate())
    assert serve_main([*_dir_args(d), "--out", os.path.join(d, "out"), "--effect", "b",
                       "--iterations", "40"]) == 0
    assert serve_main([*_dir_args(d), "--out", os.path.join(d, "mc"), "--multichip",
                       "--iterations", "40"]) == 0
    assert set(threading.enumerate()) <= before


def test_serve_png_level_same_pixels_smaller_effort(tmp_path):
    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "a", 64, 80, 1)
    args = [*_dir_args(d), "--effect", "h", "--backend", "xla"]
    assert serve_main(args + ["--out", os.path.join(d, "o6")]) == 0
    assert serve_main(args + ["--out", os.path.join(d, "o1"), "--png-level", "1"]) == 0
    for suffix in ("depth", "effect"):
        np.testing.assert_array_equal(io.imread_gray(os.path.join(d, "o6", f"a_{suffix}.png")),
                                      io.imread_gray(os.path.join(d, "o1", f"a_{suffix}.png")))
    with pytest.raises(SystemExit):
        serve_main(args + ["--out", os.path.join(d, "bad"), "--png-level", "11"])


def _parsed_config(monkeypatch, extra, module=serve_mod):
    """``module``'s main() through argument parsing and config resolution
    only (no input pairs: it returns 2 right after), with the config it
    resolved."""
    import contextlib
    import io as pyio

    holder = {}
    real = module.config_from_args

    def capture(a, error=None):
        holder["cfg"] = real(a, error)
        return holder["cfg"]

    monkeypatch.setattr(module, "config_from_args", capture)
    with contextlib.redirect_stderr(pyio.StringIO()), contextlib.redirect_stdout(pyio.StringIO()):
        assert module.main(["--out", "/tmp/x"] + extra) == 2
    return holder["cfg"]


def test_serve_profile_fast_config_resolution(monkeypatch):
    cfg = _parsed_config(monkeypatch, ["--profile", "fast"])
    assert cfg.solver == "red_black" and cfg.early_exit
    assert cfg.tolerance == 1e-3 and cfg.residual_metric == "rms"
    cfg = _parsed_config(monkeypatch, ["--profile", "faithful"])
    assert cfg.solver == "jacobi_chebyshev" and not cfg.early_exit
    assert cfg == DiffusionConfig()
    cfg = _parsed_config(monkeypatch, ["--profile", "fast", "--solver", "jacobi_chebyshev"])
    assert cfg.solver == "jacobi_chebyshev" and cfg.early_exit
    cfg = _parsed_config(monkeypatch, ["--profile", "fast", "--tolerance", "1e-4",
                                       "--residual-metric", "max", "--rb-plain"])
    assert cfg.tolerance == 1e-4 and cfg.residual_metric == "max"
    assert not cfg.rb_chebyshev
    cfg = _parsed_config(monkeypatch, ["--early-exit"])
    assert cfg.solver == "jacobi_chebyshev" and cfg.early_exit


@pytest.mark.parametrize("flags", [
    ["--profile", "fast"], ["--profile", "faithful"], ["--early-exit"],
    ["--profile", "fast", "--solver", "jacobi_chebyshev", "--iterations", "64"],
    ["--tolerance", "1e-4", "--residual-metric", "max", "--rb-plain", "--rb-rho", "0.99"],
    ["--defocus-stride", "8", "--multigrid", "vcycle", "--backend", "xla"],
    ["--defocus-quality", "exact", "--solver", "jacobi"],
], ids=" ".join)
def test_serve_config_matches_jax(monkeypatch, flags):
    """The same flags resolve to the JAX server's config, field for field."""
    import dataclasses

    from realtimedepthdiffusion_tpu import serve as jserve

    got = _parsed_config(monkeypatch, flags)
    want = _parsed_config(monkeypatch, flags, jserve)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_serve_profile_fast_takes_early_exit_path(tmp_path, monkeypatch):
    """--profile fast routes every level through the red-black solver's
    early exit."""
    from realtimedepthdiffusion_tpu_torch.core import solver as core_solver

    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "a", 64, 80, 1)
    calls = []
    real = core_solver._chunked_early_exit

    def spy(state, run, u_of, mask, wts, iters, cfg, exit_log=None):
        calls.append(cfg.solver)
        return real(state, run, u_of, mask, wts, iters, cfg, exit_log)

    monkeypatch.setattr(core_solver, "_chunked_early_exit", spy)
    out = os.path.join(d, "out")
    assert serve_main([*_dir_args(d), "--out", out, "--backend", "xla", "--profile", "fast"]) == 0
    assert os.path.exists(os.path.join(out, "a_depth.png"))
    levels = DiffusionConfig().num_levels(64, 80)
    assert calls == ["red_black"] * levels, calls


def test_serve_multichip_matches_sequential(tmp_path):
    """--multichip through main() (a one-slot CPU mesh: one slot per card,
    and the CPU counts as one) against the sequential path, with a padded
    last batch, a bucket smaller than the batch and an odd shape."""
    d = str(tmp_path)
    _dirs(d)
    for name, (h, w), seed in [("a", (64, 80), 1), ("b", (64, 80), 2), ("c", (64, 80), 5),
                               ("dd", (72, 96), 3), ("ee", (69, 85), 4)]:
        _write_pair(d, name, h, w, seed)
    out_seq, out_mc = os.path.join(d, "out_seq"), os.path.join(d, "out_mc")
    common = [*_dir_args(d), "--backend", "xla", "--effect", "h", "--iterations", "64"]
    assert serve_main(common + ["--out", out_seq]) == 0
    assert serve_main(common + ["--out", out_mc, "--multichip", "--batch", "2",
                                "--depth16"]) == 0
    for name in ("a", "b", "c", "dd", "ee"):
        seq = io.imread_gray(os.path.join(out_seq, f"{name}_depth.png")).astype(np.int32)
        mc = io.imread_gray(os.path.join(out_mc, f"{name}_depth.png")).astype(np.int32)
        assert np.abs(seq - mc).max() <= 1, name
        assert os.path.exists(os.path.join(out_mc, f"{name}_effect.png"))
        d16 = _png(os.path.join(out_mc, f"{name}_depth16.png")).astype(np.int32)
        assert np.abs(d16 // 257 - mc).max() <= 1, name


def test_serve_multichip_on_cpu_mesh_matches_sequential(tmp_path):
    """solve_pairs_multichip on the 8-slot CPU mesh (2, 2, 2), batch 2 with a
    padded last batch, against solve_pairs: depth16 within RMSE 1e-3, u8
    within one gray level, the effect within a mean difference of 0.5."""
    from realtimedepthdiffusion_tpu_torch.parallel.mesh import make_mesh

    d = str(tmp_path)
    _dirs(d)
    for name, seed in (("a", 1), ("b", 2), ("c", 3)):
        _write_pair(d, name, 64, 96, seed)
    pairs = discover_pairs(os.path.join(d, "images"), os.path.join(d, "annotations"))
    cfg = DiffusionConfig(max_iterations=40)
    kw = dict(depth16=True, io_workers=2, device="cpu")
    seq = solve_pairs(pairs, os.path.join(d, "seq"), cfg, fx.EFFECT_DEFOCUS, **kw)
    mc = solve_pairs_multichip(pairs, os.path.join(d, "mc"), cfg, fx.EFFECT_DEFOCUS, batch=2,
                               mesh=make_mesh(8, device="cpu"), **kw)
    assert [os.path.basename(p) for p in mc] == [os.path.basename(p) for p in seq]
    for s, m in zip(seq, mc):
        s16, m16 = (_png(p.replace("_depth.png", "_depth16.png")).astype(float) for p in (s, m))
        assert float(np.sqrt(np.mean(((s16 - m16) / 65535.0) ** 2))) <= 1e-3
        assert np.abs(io.imread_gray(s).astype(int) - io.imread_gray(m).astype(int)).max() <= 1
        se, me = (io.imread_rgb(p.replace("_depth.png", "_effect.png")).astype(int)
                  for p in (s, m))
        assert float(np.abs(se - me).mean()) <= 0.5


@pytest.mark.parametrize("effect", [fx.EFFECT_HAZE, fx.EFFECT_DEFOCUS])
def test_serve_async_pipeline_matches_sequential(tmp_path, effect):
    """The async IO pipeline (decode-ahead threads, deferred readback,
    threaded PNG writes) writes byte-identical files, in input order, to
    the strictly sequential path (prefetch=0, io_workers=1)."""
    d = str(tmp_path)
    _dirs(d)
    for i, (name, h, w) in enumerate([("a", 64, 80), ("b", 64, 80), ("c", 72, 96),
                                      ("d", 64, 80)]):
        _write_pair(d, name, h, w, i + 1)
    pairs = discover_pairs(os.path.join(d, "images"), os.path.join(d, "annotations"))
    cfg = DiffusionConfig(backend="xla")
    seq = solve_pairs(pairs, os.path.join(d, "seq"), cfg, effect, io_workers=1, prefetch=0,
                      depth16=True, device="cpu")
    par = solve_pairs(pairs, os.path.join(d, "par"), cfg, effect, io_workers=4, prefetch=3,
                      depth16=True, device="cpu")
    assert [os.path.basename(p) for p in seq] == [os.path.basename(p) for p in par] == [
        "a_depth.png", "b_depth.png", "c_depth.png", "d_depth.png"]
    for s, p in zip(seq, par):
        for suffix in ("_depth.png", "_depth16.png", "_effect.png"):
            assert _bytes(s.replace("_depth.png", suffix)) == _bytes(
                p.replace("_depth.png", suffix)), (s, suffix)


def test_serve_multichip_bounded_decode(tmp_path, monkeypatch):
    """The multichip path buckets by image HEADER and decodes lazily: batch
    k's pixels are decoded only after batch k-2 has been dispatched."""
    import realtimedepthdiffusion_tpu_torch.parallel.sharded as sharded
    from realtimedepthdiffusion_tpu_torch.parallel.mesh import make_mesh

    d = str(tmp_path)
    _dirs(d)
    names = ["a", "b", "c", "d"]
    for i, name in enumerate(names):
        _write_pair(d, name, 48, 64, i + 1)
    pairs = [(os.path.join(d, "images", f"{n}.png"), os.path.join(d, "annotations", f"{n}.png"))
             for n in names]
    events = []
    real_load = serve_mod._load_pair

    def spy_load(img_path, ann_path, cfg):
        events.append(("decode", os.path.basename(img_path)))
        return real_load(img_path, ann_path, cfg)

    real_step = sharded.batched_step
    n_dispatch = [0]

    def spy_step(*a, **kw):
        fn, meta = real_step(*a, **kw)

        def wrapped(*fa):
            events.append(("dispatch", n_dispatch[0]))
            n_dispatch[0] += 1
            return fn(*fa)

        return wrapped, meta

    monkeypatch.setattr(serve_mod, "_load_pair", spy_load)
    monkeypatch.setattr(sharded, "batched_step", spy_step)
    cfg = DiffusionConfig(backend="xla", max_iterations=16)
    got = solve_pairs_multichip(pairs, os.path.join(d, "out"), cfg, batch=1,
                                mesh=make_mesh(1, device="cpu"), device="cpu")
    assert len(got) == 4 and all(os.path.exists(p) for p in got)
    decode_at, dispatch_at = {}, {}
    for idx, (kind, tag) in enumerate(events):
        (decode_at if kind == "decode" else dispatch_at)[tag] = idx
    assert n_dispatch[0] == 4
    for k in range(2, 4):
        assert decode_at[f"{names[k]}.png"] > dispatch_at[k - 2], events


def test_serve_keep_going_skips_bad_pairs(tmp_path):
    """--keep-going: a mismatched pair becomes a warning + None entry and the
    rest of the run completes; without it the run aborts. Both paths, the
    exit codes, and --skip-existing with and without --effect."""
    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "a", 48, 64, 1)
    _write_pair(d, "b", 48, 64, 2)
    rgb, _mask, _value = synthetic_pair(48, 64, 3)
    io.imwrite(os.path.join(d, "images", "bad.png"), rgb)
    m2, v2 = synthetic_pair(40, 56, 3)[1:]
    io.save_annotation(os.path.join(d, "annotations", "bad.png"), m2, v2)
    pairs = discover_pairs(os.path.join(d, "images"), os.path.join(d, "annotations"))
    assert [os.path.basename(p) for p, _ in pairs] == ["a.png", "b.png", "bad.png"]

    cfg = DiffusionConfig(backend="xla", max_iterations=16)
    with pytest.raises(ValueError):
        solve_pairs(pairs, os.path.join(d, "o0"), cfg, device="cpu")
    got = solve_pairs(pairs, os.path.join(d, "o1"), cfg, keep_going=True, device="cpu")
    assert got[2] is None
    assert got[0] and got[1] and all(os.path.exists(p) for p in got[:2])

    base = [*_dir_args(d), "--backend", "xla", "--iterations", "16", "--keep-going"]
    o2, o3 = os.path.join(d, "o2"), os.path.join(d, "o3")
    assert serve_main(base + ["--out", o2]) == 1
    assert serve_main(base + ["--out", o3, "--multichip", "--batch", "2"]) == 1
    for o in (o2, o3):
        assert os.path.exists(os.path.join(o, "a_depth.png"))
        assert os.path.exists(os.path.join(o, "b_depth.png"))
        assert not os.path.exists(os.path.join(o, "bad_depth.png"))

    a_mtime = os.path.getmtime(os.path.join(o2, "a_depth.png"))
    assert serve_main(base + ["--out", o2, "--skip-existing"]) == 1
    assert os.path.getmtime(os.path.join(o2, "a_depth.png")) == a_mtime
    # A pair is done only when EVERY requested output exists.
    assert serve_main(base + ["--out", o2, "--skip-existing", "--effect", "h"]) == 1
    assert os.path.exists(os.path.join(o2, "a_effect.png"))
    assert os.path.exists(os.path.join(o2, "b_effect.png"))
    a_mtime2 = os.path.getmtime(os.path.join(o2, "a_depth.png"))
    e_mtime = os.path.getmtime(os.path.join(o2, "a_effect.png"))
    assert serve_main(base + ["--out", o2, "--skip-existing", "--effect", "h"]) == 1
    assert os.path.getmtime(os.path.join(o2, "a_depth.png")) == a_mtime2
    assert os.path.getmtime(os.path.join(o2, "a_effect.png")) == e_mtime


def test_image_size_header_probe(tmp_path):
    p = str(tmp_path / "im.png")
    io.imwrite(p, np.zeros((37, 53, 3), np.uint8))
    assert io.image_size(p) == (37, 53)
    assert io.imread_rgb(p).shape[:2] == io.image_size(p)


def test_serve_multichip_async_writes_identical_and_last_wins(tmp_path):
    """The multichip encode pool reorders host work only (byte-identical
    outputs across io_workers), and duplicate stems keep last-wins: only
    the winner encodes, the duplicate reports the winner's path once it is
    on disk."""
    from realtimedepthdiffusion_tpu_torch.parallel.mesh import make_mesh

    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "x", 48, 64, 1)
    rgb2, mask2, value2 = synthetic_pair(48, 64, 7)
    io.imwrite(os.path.join(d, "images", "x2.png"), rgb2)
    io.save_annotation(os.path.join(d, "annotations", "x2.png"), mask2, value2)
    _write_pair(d, "y", 48, 64, 3)
    _write_pair(d, "z", 56, 72, 4)  # second shape bucket
    img, ann = os.path.join(d, "images", "x.png"), os.path.join(d, "annotations", "x.png")
    ann2 = os.path.join(d, "annotations", "x2.png")
    py = (os.path.join(d, "images", "y.png"), os.path.join(d, "annotations", "y.png"))
    pz = (os.path.join(d, "images", "z.png"), os.path.join(d, "annotations", "z.png"))
    pairs = [(img, ann), py, (img, ann2), pz]
    cfg = DiffusionConfig(backend="xla", max_iterations=16)
    mesh = make_mesh(1, device="cpu")
    seen = []

    def progress(src, dst):
        seen.append((src, dst, os.path.exists(dst)))

    got1 = solve_pairs_multichip(pairs, os.path.join(d, "o1"), cfg, batch=2, mesh=mesh,
                                 io_workers=4, progress=progress, device="cpu")
    assert [os.path.basename(p) for p in got1] == [
        "x_depth.png", "y_depth.png", "x_depth.png", "z_depth.png"]
    assert len(seen) == 4 and all(existed for _, _, existed in seen), seen
    got2 = solve_pairs_multichip(pairs, os.path.join(d, "o2"), cfg, batch=2, mesh=mesh,
                                 io_workers=1, device="cpu")
    for p1, p2 in zip(got1, got2):
        assert _bytes(p1) == _bytes(p2), p1
    solo = solve_pairs_multichip([(img, ann2)], os.path.join(d, "o3"), cfg, batch=2, mesh=mesh,
                                 io_workers=1, device="cpu")
    assert _bytes(got1[2]) == _bytes(solo[0])


def test_serve_duplicate_stems_last_wins(tmp_path):
    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "x", 64, 80, 1)
    _rgb2, mask2, value2 = synthetic_pair(64, 80, 7)
    io.save_annotation(os.path.join(d, "annotations", "x2.png"), mask2, value2)
    img, ann = os.path.join(d, "images", "x.png"), os.path.join(d, "annotations", "x.png")
    ann2 = os.path.join(d, "annotations", "x2.png")
    cfg = DiffusionConfig(backend="xla")
    out = os.path.join(d, "out")
    seen = []

    def progress(src, dst):
        seen.append((src, dst, os.path.exists(dst)))

    got = solve_pairs([(img, ann), (img, ann2)], out, cfg, io_workers=4, prefetch=2,
                      progress=progress, device="cpu")
    assert got[0] == got[1] == os.path.join(out, "x_depth.png")
    assert len(seen) == 2 and all(existed for _, _, existed in seen), seen
    solo = solve_pairs([(img, ann2)], os.path.join(d, "out2"), cfg, io_workers=1, prefetch=0,
                       device="cpu")
    assert _bytes(got[1]) == _bytes(solo[0])


def test_serve_depth16_full_precision(tmp_path):
    from realtimedepthdiffusion_tpu_torch.pipeline import DepthPipeline

    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "a", 64, 80, 1)
    out = os.path.join(d, "out")
    base = [*_dir_args(d), "--out", out, "--backend", "xla"]
    assert serve_main(base + ["--depth16"]) == 0
    p16 = os.path.join(out, "a_depth16.png")
    d16 = _png(p16)
    d8 = io.imread_gray(os.path.join(out, "a_depth.png"))
    assert d16.dtype == np.uint16 and d16.shape == d8.shape
    assert np.abs((d16 // 257).astype(int) - d8.astype(int)).max() <= 1
    assert np.any(d16 % 257 != 0)
    # Host and device conversions are the same float32 operation.
    rng_depth = np.random.default_rng(0).uniform(0, 255, (16, 24)).astype(np.float32)
    pipe = DepthPipeline(16, 24, DiffusionConfig(backend="xla"), device="cpu")
    np.testing.assert_array_equal(pipe.depth_u16(torch.from_numpy(rng_depth)).numpy(),
                                  io.depth_to_u16(rng_depth))
    os.remove(p16)
    assert serve_main(base + ["--depth16", "--skip-existing"]) == 0
    assert os.path.exists(p16)
    assert serve_main(base + ["--depth16", "--skip-existing"]) == 0


def test_serve_report_manifest(tmp_path):
    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "a", 64, 80, 1)
    _write_pair(d, "b", 64, 80, 2)
    with open(os.path.join(d, "images", "broken.png"), "wb") as f:
        f.write(b"not a png")
    io.save_annotation(os.path.join(d, "annotations", "broken.png"),
                       np.zeros((8, 8), bool), np.zeros((8, 8), np.uint8))
    out = os.path.join(d, "out")
    base = [*_dir_args(d), "--out", out, "--backend", "xla", "--keep-going"]
    rep1 = os.path.join(d, "run1.json")
    assert serve_main(base + ["--report", rep1]) == 1
    r = json.load(open(rep1))
    by = {os.path.basename(e["image"]): e for e in r["pairs"]}
    assert r["counts"] == {"total": 3, "solved": 2, "skipped_existing": 0, "failed": 1}
    assert by["a.png"]["status"] == "solved" and os.path.exists(by["a.png"]["depth"])
    # The first pair of a shape charges its pipeline; 'b' reuses it.
    assert by["a.png"]["solve_s"] > 0
    assert 0 < by["b.png"]["solve_s"] <= by["a.png"]["solve_s"]
    assert by["broken.png"] == {
        "image": os.path.join(d, "images", "broken.png"),
        "annotation": os.path.join(d, "annotations", "broken.png"),
        "status": "failed", "depth": None,
    }
    assert r["wall_s"] > 0 and r["config"]["backend"] == "xla"
    assert r["config"]["device"] == "cpu"
    rep2 = os.path.join(d, "run2.json")
    assert serve_main(base + ["--skip-existing", "--report", rep2]) == 1
    r2 = json.load(open(rep2))
    assert r2["counts"] == {"total": 3, "solved": 0, "skipped_existing": 2, "failed": 1}
    assert {os.path.basename(e["image"]): e["status"] for e in r2["pairs"]} == {
        "a.png": "skipped_existing", "b.png": "skipped_existing", "broken.png": "failed"}


@pytest.mark.slow
def test_serve_watch_soak_lru_fails_and_sigterm_manifest(tmp_path):
    """Watch-mode soak: add/modify/delete cycles across max_shapes+2 shapes
    plus one persistently broken annotation, then SIGTERM. The LRU bound
    holds (evictions fire, RSS bounded), the broken pair gives up once per
    touch, and the final manifest covers every pair with true statuses."""
    import re
    import signal

    d = str(tmp_path)
    _dirs(d)
    shapes = [(48, 64), (56, 72), (64, 80), (48, 80)]
    for i, (h, w) in enumerate(shapes):
        _write_pair(d, f"s{i}", h, w, i + 1)
    rgb, _, _ = synthetic_pair(48, 64, 9)
    io.imwrite(os.path.join(d, "images", "bad.png"), rgb)
    _rgb2, m2, v2 = synthetic_pair(24, 32, 9)
    io.save_annotation(os.path.join(d, "annotations", "bad.png"), m2, v2)
    out, rep = os.path.join(d, "out"), os.path.join(d, "rep.json")
    proc = _serve_process(d, "--poll-interval", "0.1", "--max-shapes", "2", "--iterations", "40",
                          "--report", rep)

    def rss_mb():
        with open(f"/proc/{proc.pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS"):
                    return int(line.split()[1]) / 1024.0
        return 0.0

    try:
        deadline = time.time() + 240
        while not all(os.path.exists(os.path.join(out, f"s{i}_depth.png")) for i in range(4)):
            assert time.time() < deadline, "outputs never appeared"
            assert proc.poll() is None, proc.communicate()
            time.sleep(0.1)
        rss_warm = rss_mb()
        stamps = {}
        for cyc in range(12):
            i = cyc % 4
            _r, m, v = synthetic_pair(*shapes[i], 20 + cyc)
            ann = os.path.join(d, "annotations", f"s{i}.png")
            io.save_annotation(ann, m, np.where(m, (v.astype(int) + cyc * 7) % 255, 0)
                               .astype(np.uint8))
            stamps[f"s{i}"] = os.path.getmtime(ann)
            os.utime(os.path.join(d, "annotations", "bad.png"))  # re-arm
            if cyc == 5:
                os.unlink(os.path.join(d, "images", "s3.png"))
            if cyc == 8:
                io.imwrite(os.path.join(d, "images", "s3.png"), synthetic_pair(*shapes[3], 99)[0])
            time.sleep(1.2)
        time.sleep(4.0)
        rss_end = rss_mb()
        proc.send_signal(signal.SIGTERM)
        _stdout, stderr = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 1, (proc.returncode, stderr[-3000:])
    assert "evicted" in stderr, stderr[-3000:]
    assert rss_end < rss_warm * 1.6 + 200.0, (rss_warm, rss_end)
    assert len(re.findall(r"giving up on .*bad\.png", stderr)) >= 2, stderr[-3000:]
    assert not os.path.exists(os.path.join(out, "bad_depth.png"))
    by = {os.path.basename(e["image"]): e for e in json.load(open(rep))["pairs"]}
    assert by["bad.png"]["status"] == "failed" and by["bad.png"]["depth"] is None
    for i in range(4):
        assert by[f"s{i}.png"]["status"] == "solved", by[f"s{i}.png"]
        assert os.path.exists(by[f"s{i}.png"]["depth"])
    for name, ts in stamps.items():
        if name != "s3":
            assert os.path.getmtime(os.path.join(out, f"{name}_depth.png")) >= ts


# -- the port's own -------------------------------------------------------------------

def _shared_stem_watch(d, run):
    """a.png solves; a.jpg, a broken file of the same stem, is given up on
    after three scans. Returns (rc, manifest)."""
    _dirs(d)
    _write_pair(d, "a", 64, 80, 1)
    with open(os.path.join(d, "images", "a.jpg"), "wb") as f:
        f.write(b"not a jpeg")
    rep = os.path.join(d, "rep.json")
    rc = run(_watch_args(d, "--idle-exit", "1.0", "--iterations", "40", "--report", rep))
    return rc, json.load(open(rep))


def test_watch_give_up_keeps_outputs_of_a_solved_shared_stem(tmp_path, capsys):
    """Giving up on a broken a.jpg must not delete the outputs of a.png,
    which stands solved under the same stem: the JAX server deletes them
    (its manifest still says a.png solved, at a path that is gone); the
    port keeps them."""
    for tag, run in (("jax", jax_serve_main), ("port", serve_main)):
        d = str(tmp_path / tag)
        rc, rep = _shared_stem_watch(d, run)
        assert rc == 1, tag  # the given-up a.jpg flags the exit
        by = {os.path.basename(e["image"]): e for e in rep["pairs"]}
        assert by["a.jpg"]["status"] == "failed", tag
        assert by["a.png"]["status"] == "solved", tag
        kept = os.path.exists(by["a.png"]["depth"])
        assert kept == (tag == "port"), (tag, os.listdir(os.path.join(d, "out")))
    err = capsys.readouterr().err
    assert "outputs kept: " in err and "stands solved under stem 'a'" in err


def test_watch_give_up_of_the_last_writer_resolves_its_sibling(tmp_path, capsys):
    """a.png solves; a valid a.jpg of another image solves and overwrites
    a_depth.png; a.jpg is rewritten as garbage and given up on. The files
    then hold a.jpg's old depth, so the port unlinks them and solves a.png
    again: after one more scan a_depth.png is a fresh solve of a.png, byte
    for byte, and the manifest reports a.png solved at that path."""
    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "a", 96, 128, 1)
    jpg, out = os.path.join(d, "images", "a.jpg"), os.path.join(d, "out")
    depth, rep = os.path.join(out, "a_depth.png"), os.path.join(d, "rep.json")
    seen = {}

    def later():
        _wait_for(depth)
        seen["a.png"] = _bytes(depth)
        jio.imwrite(jpg, synthetic_pair(96, 128, 2)[0])
        deadline = time.time() + 60
        while _bytes(depth) == seen["a.png"] and time.time() < deadline:
            time.sleep(0.05)
        time.sleep(0.3)  # let the write settle past the poll in flight
        seen["a.jpg"] = _bytes(depth)
        with open(jpg, "wb") as f:
            f.write(b"not a jpeg")
        os.utime(jpg, (time.time() + 5, time.time() + 5))

    t = threading.Thread(target=later)
    t.start()
    rc = serve_main(_watch_args(d, "--idle-exit", "1.5", "--iterations", "40", "--report", rep))
    t.join(timeout=60)
    assert not t.is_alive()
    assert rc == 1  # a.jpg stays given up
    assert seen["a.jpg"] != seen["a.png"]  # a.jpg's solve did overwrite the files
    fresh = os.path.join(d, "fresh")
    assert serve_main(["--pairs", f"{d}/images/a.png:{d}/annotations/a.png", "--out", fresh,
                       "--backend", "xla", "--iterations", "40"]) == 0
    assert _bytes(depth) == _bytes(os.path.join(fresh, "a_depth.png")) == seen["a.png"]
    by = {os.path.basename(e["image"]): e for e in json.load(open(rep))["pairs"]}
    assert by["a.jpg"]["status"] == "failed" and by["a.jpg"]["depth"] is None
    assert by["a.png"]["status"] == "solved" and by["a.png"]["depth"] == depth
    err = capsys.readouterr().err
    assert f"stale outputs removed; re-solving {d}/images/a.png" in err, err


def test_device_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "a", 48, 64, 1)
    for extra in ([], ["--multichip"], ["--watch", "--idle-exit", "0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_mod.main([*_dir_args(d), "--out", os.path.join(d, "out"), *extra])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve_pairs(discover_pairs(os.path.join(d, "images"), os.path.join(d, "annotations")),
                    os.path.join(d, "out"))
    assert not os.path.exists(os.path.join(d, "out", "a_depth.png"))


@pytest.mark.parametrize("extra", [[], ["--multichip"]])
def test_unknown_backend_raises(tmp_path, extra):
    """--backend routes nothing but is validated, where the pipeline or the
    step is built (as the CLI does it)."""
    d = str(tmp_path)
    _dirs(d)
    _write_pair(d, "a", 48, 64, 1)
    with pytest.raises(ValueError, match="unknown backend 'tpu'"):
        serve_main([*_dir_args(d), "--out", os.path.join(d, "out"), "--backend", "tpu", *extra])


@pytest.mark.parametrize("value,ok", [("cpu", True), ("CUDA", True), ("cuda:1", True),
                                      ("gpu", False), ("meta", False), ("cuda:x", False)])
def test_device_flag(value, ok, capsys):
    if ok:
        assert serve_mod.device_arg(value) == value.lower()
    else:
        with pytest.raises(SystemExit):
            serve_mod.main(["--out", "/tmp/x", "--device", value])
        assert "unknown --device" in capsys.readouterr().err


def test_serve_and_warmup_run_without_jax_pil_cv2(tmp_path):
    """serve.main (single-device, multichip and watch) and warmup.main with
    --device cpu where jax, PIL and cv2 do not import: PNGs by the zlib
    codec."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "PIL", "cv2", "realtimedepthdiffusion_tpu"):
            sys.modules[name] = None
        import os
        import numpy as np
        from realtimedepthdiffusion_tpu_torch import io, serve, warmup
        assert io.codec() == "zlib"
        d = {str(tmp_path)!r}
        r = np.random.default_rng(0)
        for sub in ("images", "annotations"):
            os.makedirs(os.path.join(d, sub))
        for n, (h, w) in (("a", (47, 61)), ("b", (40, 56))):
            io.imwrite(os.path.join(d, "images", n + ".png"),
                       r.integers(0, 256, (h, w, 3), dtype=np.uint8))
            mask = np.zeros((h, w), bool); mask[10:14, 10:20] = True
            value = np.zeros((h, w), np.uint8); value[10:14, 10:20] = 64
            io.save_annotation(os.path.join(d, "annotations", n + ".png"), mask, value)
        args = ["--images", os.path.join(d, "images"), "--annotations",
                os.path.join(d, "annotations"), "--effect", "b", "--depth16",
                "--iterations", "40", "--device", "cpu"]
        for out, extra in (("out", []), ("mc", ["--multichip"]),
                           ("watch", ["--watch", "--poll-interval", "0.05", "--idle-exit", "0.2"])):
            assert serve.main(args + ["--out", os.path.join(d, out)] + extra) == 0
            assert sorted(os.listdir(os.path.join(d, out))) == sorted(
                n + s for n in "ab" for s in ("_depth.png", "_depth16.png", "_effect.png"))
            dm = io.imread_gray(os.path.join(d, out, "a_depth.png"))
            assert (dm[10:14, 10:20] == 64).all()
        os.environ["RTDD_CACHE_DIR"] = os.path.join(d, "cache")
        assert warmup.main(["--size", "40x56", "--effect", "b", "--incremental", "20",
                            "--iterations", "40", "--device", "cpu"]) == 0
        assert not any(m.startswith(("jax", "PIL", "cv2")) for m, v in sys.modules.items()
                       if v is not None)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith("ok")
