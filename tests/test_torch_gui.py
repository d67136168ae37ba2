"""The port's GUI loop (``live/gui.py``) against the JAX package's:
``handle_key`` on the key script of tests/test_cli_and_session.py:176, and
``run_gui`` end to end through the scripted stand-in ``cv2`` module of
tests/test_gui_loop.py, whose ``waitKey`` fires each tick's mouse events
through the real callback. Paint events drain through the port's native
event queue before the frame's solve; the sessions stay within depth RMSE
1e-3 of each other."""

import sys

import numpy as np
import pytest

from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.live import gui as jgui
from realtimedepthdiffusion_tpu.live.session import DepthSession as JSession
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import effects as fx
from realtimedepthdiffusion_tpu_torch.live import gui
from realtimedepthdiffusion_tpu_torch.live.session import DepthSession
from realtimedepthdiffusion_tpu_torch.native import runtime
from tests.conftest import synthetic_pair
from tests.test_gui_loop import FakeCv2, _drag

H, W = 64, 64
KW = dict(max_iterations=20)


def _rmse(a, b):
    return float(np.sqrt(np.mean(((np.asarray(a, np.float64) - np.asarray(b)) / 255.0) ** 2)))


def _sessions(seed=3, **kw):
    rgb, _, _ = synthetic_pair(H, W, seed)
    cfg = dict(KW, **kw)
    return (JSession(rgb, JConfig(backend="xla", fast_start=False, **cfg)),
            DepthSession(rgb, DiffusionConfig(**cfg), device="cpu"))


def _state(s):
    return (s.scribble_color, s.scribble_radius, s.effect, s.solve_count, s.artistic is None)


# The key script of tests/test_cli_and_session.py:176: (key, live, strokes
# painted before the key).
KEYS = [(27, False, ()), (255, False, ()), (ord("3"), False, ()), (ord("+"), False, ()),
        (ord("-"), False, ()), (ord("d"), False, ((32, 32),)), (ord("h"), False, ()),
        (ord("b"), False, ()), (255, True, ()), (ord("2"), True, ()), (ord("+"), True, ()),
        (ord("g"), True, ((10, 50), (50, 10))), (255, False, ()), (ord("t"), False, ()),
        (ord("0"), True, ((20, 20),))]


@pytest.fixture(scope="module")
def key_runs():
    js, ts = _sessions()
    out = []
    for key, live, strokes in KEYS:
        row = {}
        for tag, s, handle in (("jax", js, jgui.handle_key), ("port", ts, gui.handle_key)):
            for x, y in strokes:
                s.paint(x, y)
            if key == 255 and not live:
                s.artistic = None  # a sticky effect re-renders on a frame without a solve
            quit_ = handle(s, key, live=live)
            row[tag] = (quit_, _state(s), np.array(s.depth0, np.float32))
        out.append(row)
    return out


@pytest.mark.parametrize("i", range(len(KEYS)),
                         ids=[f"{i}-{k}{'-live' if lv else ''}" for i, (k, lv, _) in enumerate(KEYS)])
def test_handle_key_matches_jax(key_runs, i):
    j, p = key_runs[i]["jax"], key_runs[i]["port"]
    assert p[0] is j[0] and p[0] == (KEYS[i][0] == 27)
    assert p[1] == j[1]
    assert _rmse(p[2], j[2]) <= 1e-3


def test_handle_key_contract(key_runs):
    """The reference's per-frame contract, read off the port's run."""
    states = [r["port"][1] for r in key_runs]
    assert states[1][3] == 0  # an idle frame does not solve
    assert states[2][0] == 192 and states[4][1] == states[3][1] - 2
    assert states[5][3] == 1  # 'd' solves
    assert states[6][2] == fx.EFFECT_HAZE and not states[6][4]
    assert states[7][2] == fx.EFFECT_DEFOCUS
    assert [s[3] for s in states[8:12]] == [2, 3, 4, 5]  # --live solves every frame
    assert states[9][0] == 128 and states[11][2] == fx.EFFECT_DESATURATION
    assert states[12][3] == 5 and not states[12][4]  # re-rendered without a solve


def _run(session, script, live, monkeypatch, package):
    """run_gui of ``package`` (the port's gui or JAX's) on the scripted cv2,
    with every event queue it makes recorded."""
    rt = runtime if package is gui else sys.modules["realtimedepthdiffusion_tpu.native.runtime"]
    fake = FakeCv2(script)
    queues = []
    real_q = rt.EventQueue

    class SpyQueue(real_q):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            queues.append(self)

    monkeypatch.setitem(sys.modules, "cv2", fake)
    monkeypatch.setattr(rt, "EventQueue", SpyQueue)
    rc = package.run_gui(session, live=live)
    return fake, queues, rc


def _both(script, live, monkeypatch, color=None, **kw):
    js, ts = _sessions(seed=11, **kw)
    runs = {}
    for tag, s, package in (("jax", js, jgui), ("port", ts, gui)):
        if color is not None:
            s.set_color_key(color)
        runs[tag] = (s, *_run(s, script, live, monkeypatch, package))
    return runs


def test_run_gui_paint_drains_before_solve(monkeypatch):
    """A drag queued on tick 0 is painted before tick 1's 'd' solve, which
    pins it; three windows, no Artistic window without an effect, Esc exits
    at the next tick's drain, the queue is closed and native."""
    fake0 = FakeCv2([])
    script = [{"mouse": _drag(10, 10, 30, 10, fake0)}, {"key": ord("d")}, {"key": 27}]
    runs = _both(script, False, monkeypatch, color=3)
    s, fake, queues, rc = runs["port"]
    assert rc == 0 and fake.windows == ["Original Image", "Edited Image", "Depth Image"]
    assert s.mask_np[10, 10:31].all() and s.solve_count == 1
    d = s.depth0.numpy()
    yy, xx = np.nonzero(s.mask_np)
    assert np.array_equal(d[yy, xx], s.value_np[yy, xx].astype(np.float32))
    assert all(name != "Artistic Image" for _, name in fake.imshows)
    assert max(t for t, _ in fake.imshows) == 2 and fake.destroyed
    assert len(queues) == 1 and queues[0]._closed and queues[0].lib is not None
    js, jfake = runs["jax"][0], runs["jax"][1]
    assert fake.imshows == jfake.imshows
    assert np.array_equal(s.mask_np, js.mask_np) and np.array_equal(s.value_np, js.value_np)
    assert _rmse(d, np.asarray(js.depth0)) <= 1e-3


def test_run_gui_live_cadence_and_sticky_effect(monkeypatch):
    """--live solves every tick; the effect latched by 'b' shows from the
    tick that drains it on, as in the reference loop."""
    script = [{}, {"key": ord("b")}, {}, {}, {"key": 27}]
    runs = _both(script, True, monkeypatch)
    s, fake, queues, rc = runs["port"]
    assert rc == 0 and s.solve_count == 5
    art_ticks = sorted(t for t, name in fake.imshows if name == "Artistic Image")
    assert art_ticks == [2, 3, 4]
    assert s.artistic is not None and queues[0]._closed
    assert fake.imshows == runs["jax"][1].imshows
    assert _rmse(s.depth0.numpy(), np.asarray(runs["jax"][0].depth0)) <= 1e-3


def test_run_gui_sticky_effect_rerenders_without_solve(monkeypatch):
    js, ts = _sessions(seed=11)
    calls = []
    real = ts.render_effect
    ts.render_effect = lambda: (calls.append(1), real())[1]
    script = [{"key": ord("h")}, {}, {}, {"key": 27}]
    fake, queues, rc = _run(ts, script, False, monkeypatch, gui)
    assert rc == 0 and ts.solve_count == 0 and len(calls) == 3
    assert sorted(t for t, name in fake.imshows if name == "Artistic Image") == [1, 2, 3]
    jfake, _, _ = _run(js, script, False, monkeypatch, jgui)
    assert fake.imshows == jfake.imshows


def test_run_gui_live_strokes_take_the_windowed_path(monkeypatch):
    """--live with --incremental: the first solve is full; a drag drained on
    a later tick takes one windowed re-solve, an idle tick none."""
    rgb, _, _ = synthetic_pair(96, 96, 3)
    s = DepthSession(rgb, DiffusionConfig(max_iterations=20, incremental_iterations=8,
                                          incremental_window=32), device="cpu")
    local = []
    real = s.pipe.solve_incremental
    s.pipe.solve_incremental = lambda *a, **kw: (local.append(s.solve_count), real(*a, **kw))[1]
    fake0 = FakeCv2([])
    script = [{}, {"mouse": _drag(40, 40, 44, 42, fake0)}, {}, {"key": 27}]
    fake, _, rc = _run(s, script, True, monkeypatch, gui)
    assert rc == 0 and s.solve_count == 4
    assert local == [2]  # the tick after the drag, and only it
    assert s.mask_np[40:43, 40:45].any()


def test_run_gui_without_cv2_names_it(monkeypatch):
    _, ts = _sessions()
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="cv2"):
        gui.run_gui(ts)
