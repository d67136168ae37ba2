"""The port's CLI (``live/cli.py``) against the JAX package's: ``parse_args``
and ``make_config`` on the flag lists of tests/test_cli_and_session.py, the
same errors, the same usage text but for the port's ``--device`` line and
its profiler, and the headless run on the same PNG files with
``--device cpu`` (DepthMap16 within RMSE 1e-3 on [0, 1], the annotation
files equal). One run in a subprocess where jax, PIL and cv2 do not
import."""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu.live import cli as jcli
from realtimedepthdiffusion_tpu_torch import io
from realtimedepthdiffusion_tpu_torch.live import cli
from tests.conftest import synthetic_pair

VALID = [
    ["-i", "img.jpg", "-a", "ann.png", "--live"],
    ["--live", "-x", "-i", "img.jpg"],
    *[["-i", "x.jpg", "--effect", v] for v in
      ("b", "refocus", "DEFOCUS", "g", "desaturation", "grayscale", "h", "haze")],
    ["-i", "x.jpg", "--incremental", "48", "--early-exit", "--tolerance", "2e-5",
     "--gray-pyramid", "floor", "--solver", "red_black", "--residual-metric", "max"],
    ["-i", "x.jpg", "--solver", "red_black", "--tolerance", "1e-4"],
    ["-i", "x.jpg"],
    ["-i", "x.jpg", "--tolerance", "1e-4"],
    ["-i", "x.jpg", "--solver", "jacobi", "--early-exit"],
    ["--residual-metric", "MAX"],
    ["--gray-pyramid", "OpenCV"],
    ["-i", "x.jpg", "--solver", "red_black", "--rb-rho", "0.995"],
    ["-i", "x.jpg", "--rb-plain"],
    ["-i", "x.jpg", "--profile", "fast"],
    ["-i", "x.jpg", "--profile", "faithful"],
    ["-i", "x.jpg", "--profile", "fast", "--tolerance", "1e-4", "--incremental", "0"],
    ["-i", "x.jpg", "--profile", "fast", "--solver", "jacobi_chebyshev"],
    ["-i", "x.jpg", "--defocus-quality", "approx"],
    ["-i", "x.jpg", "--defocus-stride", "8"],
    ["-i", "x.jpg", "--defocus-quality", "EXACT", "--defocus-stride", "8"],
    ["-i", "x.jpg", "--defocus-quality", "auto"],
    ["-i", "x.jpg", "--multigrid", "vcycle", "--backend", "xla", "--incremental", "-3"],
    ["-i", "x.jpg", "-a", "a.png", "--headless", "--solve", "--effect", "g", "--save-dir",
     "out", "--time", "--backend", "xla", "--depth16", "--checkpoint", "c.npz",
     "--resume", "r.npz", "--trace", "t", "--verbose", "-h"],
]
ERRORS = [
    ["-i"], ["-i", "x.jpg", "--effect", "sepia"], ["--incremental", "abc"],
    ["--tolerance", "abc"], ["--residual-metric", "rsm"], ["--gray-pyramid", "opencV2"],
    ["--rb-rho", "abc"], ["--profile", "turbo"], ["--defocus-quality", "fast"],
    ["--defocus-stride", "abc"], ["--defocus-stride", "1"], ["--save-dir"],
]
# Flags that pass the parser and the config, and fail where the session
# builds its pipeline (ops/dispatch.py:check_supported).
BAD_NAMES = [("--solver", "sor"), ("--multigrid", "fmg"), ("--backend", "tpu")]


def _ids(argv):
    return " ".join(argv) or "empty"


@pytest.mark.parametrize("argv", VALID, ids=_ids)
def test_parse_args_and_config_match_jax(argv):
    got = dataclasses.asdict(cli.parse_args(argv))
    assert got.pop("device") == "cuda"  # the port's one extra flag, at its default
    assert got == dataclasses.asdict(jcli.parse_args(argv))
    cfg = cli.make_config(cli.parse_args(argv))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcli.make_config(jcli.parse_args(argv)))


@pytest.mark.parametrize("argv", ERRORS, ids=_ids)
def test_parse_errors_match_jax(argv):
    with pytest.raises(SystemExit) as got:
        cli.parse_args(argv)
    with pytest.raises(SystemExit) as want:
        jcli.parse_args(argv)
    assert str(got.value).splitlines()[0] == str(want.value).splitlines()[0]
    assert str(got.value).startswith("error: ") and "Usage:" in str(got.value)


@pytest.mark.parametrize("flag,name", BAD_NAMES)
def test_unknown_names_raise(files, flag, name):
    _, img, _, _, _ = files
    with pytest.raises(ValueError, match=f"unknown {flag[2:]} {name!r}"):
        cli.main(["-i", img, "--headless", "--solve", "--device", "cpu", flag, name])


def test_usage_matches_jax():
    """The usage block is the reference CLI's, with the port's profiler
    named and one more line for --device."""
    lines = cli.USAGE.splitlines()
    assert lines[-1].startswith(" --device cuda|cuda:N|cpu")
    assert "\n".join(lines[:-1]).replace("torch.profiler", "jax.profiler") + "\n" == jcli.USAGE
    assert cli.USAGE_SHORT == jcli.USAGE_SHORT.replace("depth-diffusion", "depth-diffusion-torch")


@pytest.mark.parametrize("value,want", [("cpu", "cpu"), ("cuda", "cuda"), ("cuda:1", "cuda:1"),
                                        ("CUDA:0", "cuda:0"), ("CPU", "cpu")])
def test_device_flag(value, want):
    assert cli.parse_args(["-i", "x.png", "--device", value]).device == want


@pytest.mark.parametrize("value", ["gpu", "meta", "cuda:x", "tpu"])
def test_device_flag_rejects_other_devices(value):
    with pytest.raises(SystemExit, match="unknown --device"):
        cli.parse_args(["-i", "x.png", "--device", value])


@pytest.mark.parametrize("argv,out", [([], "Usage: depth-diffusion-torch"),
                                      (["-h"], " --device cuda|cuda:N|cpu"),
                                      (["--live"], "Usage: depth-diffusion-torch")])
def test_no_image_prints_usage(capsys, argv, out):
    assert cli.main(argv) == 0
    assert out in capsys.readouterr().out


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    rgb, mask, value = synthetic_pair(96, 128, 6)
    img, ann = str(d / "img.png"), str(d / "ann.png")
    io.imwrite(img, rgb)
    io.save_annotation(ann, mask, value)
    return d, img, ann, mask, value


@pytest.fixture(scope="module")
def headless(files):
    """The headless one-shot run of both CLIs on the same files."""
    d, img, ann, _, _ = files
    argv = ["-i", img, "-a", ann, "--headless", "--solve", "--effect", "b", "--depth16",
            "--time", "--backend", "xla"]
    jout, tout = str(d / "jax"), str(d / "port")
    assert jcli.main(argv + ["--save-dir", jout]) == 0
    assert cli.main(argv + ["--save-dir", tout, "--device", "cpu"]) == 0
    return jout, tout


def _png(path):
    with open(path, "rb") as f:
        return io.png_decode(f.read())


def test_headless_run_matches_jax(files, headless):
    _, _, _, mask, value = files
    jout, tout = headless
    names = ["AnnotatedImage.png", "Annotation.png", "ArtisticEffect.png", "DepthMap.png",
             "DepthMap16.png"]
    assert sorted(os.listdir(tout)) == sorted(os.listdir(jout)) == names
    for name in ("Annotation.png", "AnnotatedImage.png"):
        assert np.array_equal(_png(os.path.join(tout, name)), _png(os.path.join(jout, name)))
    d16, j16 = (_png(os.path.join(o, "DepthMap16.png")) for o in (tout, jout))
    assert d16.dtype == np.uint16 and d16.shape == (96, 128)
    assert float(np.sqrt(np.mean(((d16.astype(float) - j16) / 65535.0) ** 2))) <= 1e-3
    d8 = io.imread_gray(os.path.join(tout, "DepthMap.png"))
    assert np.array_equal(d8[mask], value[mask])
    assert np.abs(d8.astype(int) - (d16.astype(int) + 128) // 257).max() <= 1
    art, jart = (io.imread_rgb(os.path.join(o, "ArtisticEffect.png")).astype(int)
                 for o in (tout, jout))
    assert float(np.abs(art - jart).mean()) <= 0.5


def test_headless_run_prints_reports(files, capsys, tmp_path):
    _, img, ann, _, _ = files
    ck = str(tmp_path / "s.npz")
    assert cli.main(["-i", img, "-a", ann, "--headless", "--solve", "--time", "--device", "cpu",
                     "--max-iterations-is-not-a-flag", "--checkpoint", ck]) == 0
    out = capsys.readouterr().out
    assert "Processing Time:" in out and "Residual (per level): L0=max" in out
    assert f"Checkpoint saved: {ck}" in out and os.path.exists(ck)
    # --resume restores the session; --effect alone solves headless.
    assert cli.main(["-i", img, "--resume", ck, "--headless", "--effect", "h", "--device", "cpu",
                     "--save-dir", str(tmp_path / "resumed")]) == 0
    assert "Saving images..." in capsys.readouterr().out
    m, v = io.load_annotation(str(tmp_path / "resumed" / "Annotation.png"))
    m0, v0 = io.load_annotation(ann)
    assert np.array_equal(m, m0) and np.array_equal(v[m], v0[m0])


def test_trace_and_fast_profile(files, tmp_path):
    """--trace writes torch.profiler's trace of the solve; --profile fast
    runs the red-black early exit with the incremental pipeline."""
    _, img, ann, _, _ = files
    trace = str(tmp_path / "trace")
    assert cli.main(["-i", img, "-a", ann, "--headless", "--solve", "--profile", "fast",
                     "--trace", trace, "--verbose", "--device", "cpu"]) == 0
    assert os.path.getsize(os.path.join(trace, "trace.json")) > 0


def test_device_cuda_without_card_raises(files):
    _, img, _, _, _ = files
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-i", img, "--headless", "--solve"])


def test_cli_runs_without_jax_pil_cv2(tmp_path):
    """The headless CLI with --device cpu writes its PNGs (by the zlib codec)
    where jax, PIL and cv2 do not import; the GUI path then raises an
    ImportError that names cv2."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "jaxlib", "PIL", "cv2", "realtimedepthdiffusion_tpu"):
            sys.modules[name] = None
        import os
        import numpy as np
        from realtimedepthdiffusion_tpu_torch import io
        from realtimedepthdiffusion_tpu_torch.live import cli
        assert io.codec() == "zlib"
        r = np.random.default_rng(0)
        h, w = 47, 61
        rgb = r.integers(0, 256, (h, w, 3), dtype=np.uint8)
        mask = np.zeros((h, w), bool); mask[10:14, 10:20] = True
        value = np.zeros((h, w), np.uint8); value[10:14, 10:20] = 64
        d = {str(tmp_path)!r}
        io.imwrite(os.path.join(d, "img.png"), rgb)
        io.save_annotation(os.path.join(d, "ann.png"), mask, value)
        out = os.path.join(d, "out")
        rc = cli.main(["-i", os.path.join(d, "img.png"), "-a", os.path.join(d, "ann.png"),
                       "--headless", "--solve", "--effect", "b", "--save-dir", out,
                       "--depth16", "--time", "--device", "cpu", "--incremental", "20"])
        assert rc == 0
        assert sorted(os.listdir(out)) == ["AnnotatedImage.png", "Annotation.png",
                                           "ArtisticEffect.png", "DepthMap.png", "DepthMap16.png"]
        dm = io.imread_gray(os.path.join(out, "DepthMap.png"))
        assert (dm[mask] == 64).all()
        try:
            cli.main(["-i", os.path.join(d, "img.png"), "--device", "cpu"])
        except ImportError as e:
            assert "cv2" in str(e)
        else:
            raise AssertionError("the GUI ran without cv2")
        assert not any(m.startswith(("jax", "PIL", "cv2")) for m, v in sys.modules.items()
                       if v is not None)
        print("ok")
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")
