"""The reference a configuration is held to, found by name: ``plain`` for
every configuration the benchmark has, a configuration's own file where it
has one, and both drivers judging by the module they are given."""

import sys

import pytest
import torch

from benchmark import control, harness, spec
from benchmark.reference import plain
from benchmark.tests import small

CONFIGS = [c["name"] for c in spec.load()["configs"]]
# One cell of each driver.
CELLS = ["faithful_1080p.strokes", "faithful_1080p.batch"]

REEXPORT = "from benchmark.reference.plain import *  # noqa: F401,F403\n"
# The effect one gray level brighter than plain's (255 stays).
SHIFTED = REEXPORT + (
    "import torch\n"
    "from benchmark.reference import plain\n\n\n"
    "def defocus(cfg, rgb, depth):\n"
    "    out = plain.defocus(cfg, rgb, depth).to(torch.int16) + 1\n"
    "    return out.clamp(max=255).to(torch.uint8)\n")


def _module(tmp_path, config_name, source):
    """``source`` as ``reference/<config_name>.py`` under ``tmp_path``,
    resolved by ``spec.reference``."""
    (tmp_path / "reference").mkdir(parents=True, exist_ok=True)
    (tmp_path / "reference" / f"{config_name}.py").write_text(source)
    return spec.reference(config_name, base=tmp_path)


@pytest.mark.parametrize("config", CONFIGS)
def test_every_config_resolves_to_plain(config):
    assert spec.reference(config) is plain


@pytest.mark.parametrize("config", CONFIGS)
def test_every_config_reference_has_the_interface(config):
    mod = spec.reference(config)
    assert all(callable(getattr(mod, f, None)) for f in plain.INTERFACE)


def test_plain_docstring_names_the_interface():
    for f in plain.INTERFACE:
        assert f"``{f}(" in plain.__doc__, f


@pytest.mark.parametrize("config_name", ["faithful_1080p", "a_4k.approx-2"])
def test_a_config_file_is_found_by_name(tmp_path, config_name):
    """``reference/<config>.py`` where it exists, loaded by path (a name
    with ``.`` or ``-`` too), with what it keeps taken from ``plain``;
    ``plain`` where it does not."""
    mod = _module(tmp_path, config_name, SHIFTED)
    assert mod is not plain and mod.defocus is not plain.defocus
    assert mod.cascade is plain.cascade and mod.merge_rect is plain.merge_rect
    assert spec.reference("another_config", base=tmp_path) is plain


def test_a_reference_that_lacks_a_function_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="defocus"):
        _module(tmp_path, "no_defocus",
                "from benchmark.reference.plain import cascade, windowed, to_u8\n")


def test_no_orphan_reference():
    """Every file under ``reference/`` but ``plain.py`` and ``__init__.py``
    is the reference of a configuration ``BENCHMARK.json`` names."""
    own = {f"{c}.py" for c in CONFIGS} | {"plain.py", "__init__.py"}
    files = {p.name for p in (spec.HERE / "reference").iterdir() if p.is_file()}
    assert files <= own, files - own


@pytest.mark.parametrize("cell", CELLS)
def test_a_shifted_reference_fails_the_run(cell, tmp_path):
    """The driver judges by the module it is given: an effect one gray
    level off fails ``effect_rmse``; the same maths re-exported passes."""
    config = spec.cell(spec.load(), cell)["config"]
    res = small.run(cell, reference=_module(tmp_path, config, SHIFTED))
    assert not res["correct"], res["checks"]
    effect = res["checks"]["effect_rmse"]
    assert effect["value"] > effect["limit"], effect
    assert all(c["value"] <= c["limit"] for k, c in res["checks"].items() if k != "effect_rmse")
    again = small.run(cell, reference=_module(tmp_path / "again", config, REEXPORT))
    assert again["correct"], again["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_harness_and_control_resolve_the_configs_reference(cell, tmp_path, monkeypatch):
    """With no ``reference=``, ``run_cell`` and ``control.readings`` take
    ``spec.reference`` of the cell's configuration."""
    c = spec.cell(spec.load(), cell)
    shifted = _module(tmp_path, c["config"], SHIFTED)
    asked = []

    def resolve(config_name, base=spec.HERE):
        asked.append(config_name)
        return shifted

    monkeypatch.setattr(spec, "reference", resolve)
    res = small.run(cell)
    assert not res["correct"] and res["checks"]["effect_rmse"]["value"] > 0.2
    ((_, side, prog, _),) = control.readings(
        cell, [2**35 + 3], 0.3, device="cpu", cfg=small.config(c), traffic=small.traffic(c),
        n_control=0)
    assert side == "program" and prog["effect_rmse"] > 0.2
    assert asked == [c["config"]] * 2


# A reference that imports JAX, the JAX package or the port, at its top or
# lazily inside a function; the file is refused before it runs.
IMPORTS = {
    "lazy_jax": "def defocus(cfg, rgb, depth):\n    import jax  # noqa: F401\n"
                "    return plain.defocus(cfg, rgb, depth)\n",
    "lazy_jax_numpy": "def defocus(cfg, rgb, depth):\n    from jax import numpy  # noqa: F401\n"
                      "    return plain.defocus(cfg, rgb, depth)\n",
    "flax": "import flax.linen  # noqa: F401\n",
    "jax_package": "from realtimedepthdiffusion_tpu.ops import defocus  # noqa: F401\n",
    "port": "from realtimedepthdiffusion_tpu_torch.ops.defocus import defocus  # noqa: F401\n",
    "port_interop": "def cascade(*a, **k):\n"
                    "    import realtimedepthdiffusion_tpu_torch.interop  # noqa: F401\n",
}


@pytest.mark.parametrize("kind", sorted(IMPORTS))
def test_a_reference_that_imports_jax_or_the_port_is_refused(kind, tmp_path):
    with pytest.raises(SystemExit, match="imports"):
        _module(tmp_path, "faithful_1080p",
                REEXPORT + "from benchmark.reference import plain\n\n\n" + IMPORTS[kind])


@pytest.fixture
def planted(tmp_path, monkeypatch):
    """A directory on ``sys.path`` for planted modules, which leave
    ``sys.modules`` again after the test."""
    mods = tmp_path / "mods"
    mods.mkdir()
    monkeypatch.syspath_prepend(str(mods))
    yield mods
    for name in [m for m in sys.modules if m.startswith("bench_planted_")]:
        del sys.modules[name]


def test_a_reference_whose_loading_brings_in_a_forbidden_module_is_refused(
        planted, tmp_path, monkeypatch):
    """By way of a module that the scan of the file's own imports does not
    see."""
    (planted / "bench_planted_stub.py").write_text("")
    (planted / "bench_planted_helper.py").write_text("import bench_planted_stub  # noqa: F401\n")
    monkeypatch.setattr(spec, "FORBIDDEN", spec.FORBIDDEN + ("bench_planted_stub",))
    with pytest.raises(SystemExit, match="brings in .*bench_planted_stub"):
        _module(tmp_path, "faithful_1080p", REEXPORT + "import bench_planted_helper  # noqa\n")


@pytest.mark.parametrize("cell", CELLS)
def test_a_module_the_reference_loads_while_it_judges_fails_the_run(
        cell, planted, tmp_path, monkeypatch):
    """The look at ``sys.modules`` comes after the comparison: a forbidden
    module that the reference loads only when it is called stops the run."""
    (planted / "bench_planted_stub.py").write_text("")
    monkeypatch.setattr(harness, "FORBIDDEN", harness.FORBIDDEN + ("bench_planted_stub",))
    config = spec.cell(spec.load(), cell)["config"]
    late = _module(tmp_path, config, REEXPORT + (
        "from benchmark.reference import plain\n\n\n"
        "def defocus(cfg, rgb, depth):\n"
        "    import bench_planted_stub  # noqa: F401\n"
        "    return plain.defocus(cfg, rgb, depth)\n"))
    with pytest.raises(harness.ForbiddenModules, match="bench_planted_stub"):
        small.run(cell, reference=late)


@pytest.mark.parametrize("multigrid", ["vcycle", "full_multigrid"])
def test_cascade_refuses_a_scheme_it_does_not_compute(multigrid):
    cfg = dict(spec.config(spec.load(), "faithful_1080p")["diffusion"], multigrid=multigrid)
    lvl = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="cascadic"):
        plain.cascade(cfg, [lvl.to(torch.uint8)], [lvl.bool()], [lvl.to(torch.uint8)], [lvl],
                      torch.float32)
