"""The port's warmup tool (``warmup.py``) and build cache (``utils/cache.py``):
twins of tests/test_fast_start.py::test_warmup_tool and
tests/test_serve_and_incremental.py::test_compilation_cache_helper, with
``--device cpu``, and where ``ops/build.library_path()`` lands."""

import os

import pytest
import torch

from realtimedepthdiffusion_tpu_torch import warmup
from realtimedepthdiffusion_tpu_torch.ops import build
from realtimedepthdiffusion_tpu_torch.utils.cache import (default_cache_dir,
                                                          enable_compilation_cache)


@pytest.fixture()
def build_dir(monkeypatch):
    """Restore ops/build.py's directory after the test."""
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    monkeypatch.delenv("RTDD_NO_COMPILE_CACHE", raising=False)
    monkeypatch.delenv("RTDD_CACHE_DIR", raising=False)


def test_warmup_tool(tmp_path, capsys, monkeypatch, build_dir):
    """rtdd-warmup-torch runs every path for the requested shape, prints
    each under the JAX tool's names, and points the build at the cache."""
    monkeypatch.setenv("RTDD_CACHE_DIR", str(tmp_path / "cache"))
    rc = warmup.main([
        "--size", "64x96", "--effect", "h", "--incremental", "40",
        "--iterations", "40", "--backend", "xla", "--jobs", "3", "--device", "cpu",
    ])
    assert rc == 0
    out = capsys.readouterr().out
    assert "64x96: warmed in" in out
    assert f"build cache: {tmp_path / 'cache'}" in out
    names = [line.strip().split(": ")[0].split(" ", 1)[1] for line in out.splitlines()
             if line.startswith("  64x96 ")]
    assert names == ["card", "gray_pyramid", "solve", "depth_u8", "depth_u16",
                     "solve+effect[3]", "effect[3]", "incremental", "incremental+effect[3]"]
    assert "build" not in names  # the CPU builds nothing
    assert (tmp_path / "cache").exists()
    assert build.library_path().parent == tmp_path / "cache"

    # size parsing contract
    assert warmup.parse_size("1080p") == (1080, 1920)
    assert warmup.parse_size("4k") == (2160, 3840)
    assert warmup.parse_size("123x456") == (123, 456)
    with pytest.raises(SystemExit):
        warmup.main(["--size", "garbage"])
    assert warmup.main([]) == 2  # no shapes


def test_warmup_shapes_from_images(tmp_path, capsys, build_dir):
    import numpy as np

    from realtimedepthdiffusion_tpu_torch import io

    for name, shape in (("a", (40, 56)), ("b", (40, 56)), ("c", (48, 64))):
        io.imwrite(str(tmp_path / f"{name}.png"), np.zeros(shape + (3,), np.uint8))
    (tmp_path / "notes.txt").write_text("not an image")
    assert warmup.shapes_from_images(str(tmp_path)) == [(40, 56), (48, 64)]
    assert warmup.main(["--images", str(tmp_path), "--size", "48x64", "--iterations", "16",
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "48x64: warmed in" in out and "40x56: warmed in" in out
    assert "total: 2 shape(s)" in out


def test_warmup_device_cuda_without_card_raises(tmp_path, monkeypatch, build_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    monkeypatch.setenv("RTDD_CACHE_DIR", str(tmp_path / "cache"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        warmup.main(["--size", "64x96"])
    with pytest.raises(SystemExit):
        warmup.main(["--size", "64x96", "--device", "tpu"])


def test_compilation_cache_helper(tmp_path, monkeypatch, build_dir):
    """enable_compilation_cache honors RTDD_CACHE_DIR / RTDD_NO_COMPILE_CACHE,
    returns the directory it configured and points the build there."""
    assert default_cache_dir() == str(build.DEFAULT_BUILD_DIR)
    monkeypatch.setenv("RTDD_CACHE_DIR", str(tmp_path / "kernels"))
    assert default_cache_dir() == str(tmp_path / "kernels")
    got = enable_compilation_cache()
    assert got == str(tmp_path / "kernels")
    assert os.path.isdir(got)
    assert build.library_path().parent == tmp_path / "kernels"
    assert enable_compilation_cache(str(tmp_path / "given")) == str(tmp_path / "given")
    assert build.library_path().parent == tmp_path / "given"

    monkeypatch.setenv("RTDD_NO_COMPILE_CACHE", "1")
    assert enable_compilation_cache() is None
    own = build.library_path().parent
    assert own.is_dir() and own.name.startswith("rtdd-kernels-")
    assert own not in (tmp_path / "kernels", build.DEFAULT_BUILD_DIR)
    assert enable_compilation_cache() is None
    assert build.library_path().parent != own  # another of its own


def test_build_runs_at_most_jobs_at_once(tmp_path):
    """--jobs bounds the nvcc processes of ops/build.py:_run_all: with 2, no
    third command starts before the first two have ended. A failure raises
    with the command's stderr."""
    import sys

    lock = tmp_path / "live"
    lock.mkdir()
    # Each command counts the live ones by files, and fails where it finds
    # more than 2 (itself included).
    body = ("import os, sys, time; d = sys.argv[1]; p = os.path.join(d, sys.argv[2]); "
            "open(p, 'w').close(); time.sleep(0.5); n = len(os.listdir(d)); os.remove(p); "
            "sys.stderr.write(sys.argv[2] + ' '); sys.exit(n > 2)")
    cmds = [[sys.executable, "-c", body, str(lock), str(i)] for i in range(5)]
    assert build._run_all(cmds, 2) == "0 1 2 3 4 "
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build._run_all(cmds)  # all five at once
    cmds = [[sys.executable, "-c", f"import sys; sys.stderr.write('{i} ')"] for i in range(5)]
    assert build._run_all(cmds, 2) == "0 1 2 3 4 "
    assert build._run_all(cmds) == "0 1 2 3 4 "
    with pytest.raises(RuntimeError, match="boom"):
        build._run_all([[sys.executable, "-c", "import sys; sys.exit('boom')"]], 1)
