"""The port's native host runtime (``native/runtime.py`` over its own copy of
``rtdd_runtime.cpp``) against the JAX package's, and against its own
pure-Python fallback: planner, Chebyshev omegas, square brush, sentinel
codec, host arena and event queue, all exact. ``core/annotation.py:paint``
(torch) against JAX's ``paint`` and the native brush.

The two packages build their libraries under two names
(``librtdd_runtime_torch.so`` beside ``librtdd_runtime.so``), so this
process holds both and a comparison never holds one library against
itself. Modelled on tests/test_native.py."""

import os
import subprocess
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu.core.annotation import paint as jpaint
from realtimedepthdiffusion_tpu.native import runtime as jruntime
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core.annotation import paint
from realtimedepthdiffusion_tpu_torch.core.solver import chebyshev_omegas
from realtimedepthdiffusion_tpu_torch.native import runtime
from realtimedepthdiffusion_tpu_torch.native.runtime import Arena, EventQueue, NativeRuntime

CFG = DiffusionConfig()
SHAPES = [(1080, 1920), (700, 560), (853, 1280), (64, 64), (96, 128), (2160, 3840)]
# (x, y, color, radius) on a 40x60 plane: inside, on every edge, past every
# edge, off the canvas, radius 0 and negative, a brush wider than the plane.
STROKES = [(30, 20, 192, 9), (0, 0, 64, 4), (59, 39, 254, 6), (-2, 10, 128, 8),
           (65, 20, 0, 12), (30, -3, 64, 7), (10, 44, 192, 9), (-50, -50, 10, 4),
           (20, 20, 128, 0), (20, 20, 128, -5), (30, 20, 254, 200), (5, 33, 1, 1)]


@pytest.fixture(scope="module")
def rt():
    r = NativeRuntime()
    if not r.available:
        pytest.skip("native toolchain unavailable")
    return r


@pytest.fixture(scope="module")
def jrt():
    r = jruntime.NativeRuntime()
    if not r.available:
        pytest.skip("native toolchain unavailable")
    return r


@pytest.fixture(scope="module")
def fallback():
    r = NativeRuntime()
    r.lib = None  # every entry point takes its pure-Python path
    return r


def test_libraries_are_distinct_files(rt, jrt):
    """Both libraries are loaded in this process, each from its own file."""
    assert os.path.basename(runtime._SO) == "librtdd_runtime_torch.so"
    assert os.path.basename(runtime._SO) != os.path.basename(jruntime._SO)
    assert os.path.dirname(runtime._SO) != os.path.dirname(jruntime._SO)
    assert rt.lib._name == runtime._SO and jrt.lib._name == jruntime._SO
    assert rt.lib._handle != jrt.lib._handle
    assert rt.lib.rtdd_version() == jrt.lib.rtdd_version() == 1


@pytest.mark.parametrize("rows,cols", SHAPES)
@pytest.mark.parametrize("iters", [1000, 120, 7])
def test_plan_matches_jax_and_config(rt, jrt, fallback, rows, cols, iters):
    plan = rt.plan(rows, cols, CFG.pyramid_base_size, iters)
    assert plan == jrt.plan(rows, cols, CFG.pyramid_base_size, iters)
    assert plan == fallback.plan(rows, cols, CFG.pyramid_base_size, iters)
    levels = CFG.num_levels(rows, cols)
    assert len(plan) == levels
    for level, (r, c, it) in enumerate(plan):
        assert (r, c) == CFG.level_size(rows, cols, level)
        assert it == DiffusionConfig(max_iterations=iters).level_iterations(levels, level)


@pytest.mark.parametrize("iters,s,rho", [(50, 10, 0.99), (1000, 10, 0.99), (7, 0, 0.9),
                                         (30, 40, 0.999), (1, 1, 0.5)])
def test_chebyshev_omegas_match_jax(rt, jrt, fallback, iters, s, rho):
    got = rt.chebyshev_omegas(iters, s, rho)
    assert got.dtype == np.float32
    assert np.array_equal(got, jrt.chebyshev_omegas(iters, s, rho))
    assert np.array_equal(got, fallback.chebyshev_omegas(iters, s, rho))
    assert np.array_equal(got, chebyshev_omegas(iters, DiffusionConfig(chebyshev_s=s,
                                                                       chebyshev_rho=rho)))


def _planes(seed=0, h=40, w=60):
    r = np.random.default_rng(seed)
    mask = (r.random((h, w)) < 0.2).astype(np.uint8)
    value = r.integers(0, 255, (h, w), dtype=np.uint8)
    return mask, value


@pytest.mark.parametrize("stroke", STROKES, ids=lambda s: "x{}y{}c{}r{}".format(*s))
def test_paint_matches_jax_and_fallback(rt, jrt, fallback, stroke):
    x, y, color, radius = stroke
    outs = []
    for r in (rt, jrt, fallback):
        mask, value = _planes()
        rect = r.paint(mask, value, x, y, color, radius)
        outs.append((rect, mask, value))
    (rect, mask, value), *others = outs
    for o_rect, o_mask, o_value in others:
        assert rect == o_rect
        assert np.array_equal(mask, o_mask) and np.array_equal(value, o_value)
    m0, v0 = _planes()
    painted = (mask != m0) | (value != v0)
    if rect is None:
        assert not painted.any()
    else:
        y0, x0, y1, x1 = rect
        assert not painted[:y0].any() and not painted[y1 + 1:].any()
        assert not painted[:, :x0].any() and not painted[:, x1 + 1:].any()
        assert (mask[y0:y1 + 1, x0:x1 + 1] == 1).all()
        assert (value[y0:y1 + 1, x0:x1 + 1] == color).all()


@pytest.mark.parametrize("stroke", STROKES, ids=lambda s: "x{}y{}c{}r{}".format(*s))
def test_torch_paint_matches_jax_and_native(rt, stroke):
    """``core/annotation.py:paint`` on tensors: JAX's paint exactly, and the
    planes the native brush leaves; the given tensors are not changed."""
    x, y, color, radius = stroke
    mask, value = _planes(seed=1)
    m_t, v_t = torch.from_numpy(mask.astype(bool)), torch.from_numpy(value.copy())
    got_m, got_v = paint(m_t, v_t, x, y, color, radius)
    jm, jv = jpaint(jnp.asarray(mask.astype(bool)), jnp.asarray(value), x, y, color, radius)
    assert got_m.dtype == torch.bool and got_v.dtype == torch.uint8
    assert np.array_equal(got_m.numpy(), np.asarray(jm))
    assert np.array_equal(got_v.numpy(), np.asarray(jv))
    rt.paint(mask, value, x, y, color, radius)
    assert np.array_equal(got_m.numpy(), mask.astype(bool))
    assert np.array_equal(got_v.numpy(), value)
    assert torch.equal(m_t, torch.from_numpy(_planes(seed=1)[0].astype(bool)))
    assert torch.equal(v_t, torch.from_numpy(_planes(seed=1)[1]))


def test_paint_refuses_bad_planes(rt, fallback):
    mask, value = _planes()
    for r in (rt, fallback):
        with pytest.raises(ValueError, match="uint8"):
            r.paint(mask.astype(bool), value, 3, 3, 64, 4)
        with pytest.raises(ValueError, match="C-contiguous"):
            r.paint(mask[:, ::2], value[:, ::2], 3, 3, 64, 4)
        with pytest.raises(ValueError, match="shape"):
            r.paint(mask, value[:10], 3, 3, 64, 4)


@pytest.mark.parametrize("sentinel", [32, 0, 255])
@pytest.mark.parametrize("seed", [0, 1])
def test_annotation_codec_matches_jax(rt, jrt, fallback, sentinel, seed):
    rng = np.random.default_rng(seed)
    plane = rng.choice([0, 32, 64, 128, 192, 254, 255], (37, 53)).astype(np.uint8)
    mask, value = rt.annotation_decode(plane, sentinel)
    assert mask.dtype == bool and value.dtype == np.uint8
    assert np.array_equal(mask, plane != sentinel)
    for r in (jrt, fallback):
        m2, v2 = r.annotation_decode(plane, sentinel)
        assert np.array_equal(m2, mask) and np.array_equal(v2, value)
    back = rt.annotation_encode(mask, value, sentinel)
    assert np.array_equal(back, plane)
    for r in (jrt, fallback):
        assert np.array_equal(r.annotation_encode(mask, value, sentinel), back)


@pytest.mark.parametrize("native", [True, False], ids=["native", "fallback"])
def test_arena_alloc_alignment_and_reuse(rt, monkeypatch, native):
    if not native:
        monkeypatch.setattr(runtime, "get_lib", lambda: None)
    a = Arena(4096)
    assert a.native is native
    x = a.alloc_u8((8, 16))
    y = a.alloc_u8((4, 4), align=64)
    assert x.shape == (8, 16) and x.dtype == np.uint8 and not x.any()
    if native:
        assert y.ctypes.data % 64 == 0
    x[:] = 7
    assert not y.any()  # allocations don't alias
    assert a.used >= 8 * 16 + 4 * 4
    # capacity exhaustion falls back to the heap, still zeroed
    z = a.alloc_u8((100, 100))
    assert z.shape == (100, 100) and not z.any()
    assert a.used >= 8 * 16 + 4 * 4 + 100 * 100
    a.close()
    a.close()  # closing twice is harmless


def test_arena_view_shares_memory_with_torch(rt):
    """A tensor from an arena view shares its bytes: the session copies
    before it keeps one."""
    a = Arena(1024)
    plane = a.alloc_u8((8, 8))
    shared = torch.from_numpy(plane)
    kept = torch.tensor(plane)
    plane[3, 3] = 9
    assert int(shared[3, 3]) == 9 and int(kept[3, 3]) == 0
    a.close()


@pytest.mark.parametrize("native", [True, False], ids=["native", "fallback"])
def test_event_queue_order_and_overflow(rt, monkeypatch, native):
    if not native:
        monkeypatch.setattr(runtime, "get_lib", lambda: None)
    q = EventQueue(capacity=8)
    assert (q._q is not None) is native
    for i in range(5):
        assert q.push(EventQueue.KIND_PAINT, i, i * 2, 7)
    assert len(q) == 5
    for i in range(5):
        assert q.pop() == (EventQueue.KIND_PAINT, i, i * 2, 7)
    assert q.pop() is None
    for i in range(20):
        q.push(EventQueue.KIND_KEY, i, 0, 0)
    drained = []
    while (e := q.pop()) is not None:
        drained.append(e)
    assert 0 < len(drained) <= 8
    q.close()
    assert q.push(EventQueue.KIND_KEY, 1) is False and q.pop() is None and len(q) == 0


def test_event_queue_kinds_match_jax():
    assert (EventQueue.KIND_PAINT, EventQueue.KIND_KEY) == (
        jruntime.EventQueue.KIND_PAINT, jruntime.EventQueue.KIND_KEY)


@pytest.mark.parametrize("native", [True, False], ids=["native", "fallback"])
def test_event_queue_threaded(rt, monkeypatch, native):
    if not native:
        monkeypatch.setattr(runtime, "get_lib", lambda: None)
    q = EventQueue(capacity=1024)
    n_producers, per = 4, 200
    pushed_total = []

    def producer(pid):
        ok = 0
        for i in range(per):
            ok += q.push(EventQueue.KIND_PAINT, pid, i, 0)
        pushed_total.append(ok)

    threads = [threading.Thread(target=producer, args=(p,)) for p in range(n_producers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    got = []
    while (e := q.pop()) is not None:
        got.append(e)
    assert len(got) == sum(pushed_total) == n_producers * per
    for pid in range(n_producers):  # per-producer FIFO order preserved
        seq = [e[2] for e in got if e[1] == pid]
        assert seq == sorted(seq)
    q.close()


def test_event_queue_close_push_race(rt):
    """close() against push() from another thread never faults; pushes
    after close return False."""
    for _ in range(20):
        q = EventQueue(capacity=64)
        stop = threading.Event()

        def pusher():
            while not stop.is_set():
                q.push(EventQueue.KIND_PAINT, 1, 2, 3)

        t = threading.Thread(target=pusher)
        t.start()
        q.close()
        stop.set()
        t.join(timeout=30)
        assert not t.is_alive()
        assert q.push(EventQueue.KIND_PAINT, 0, 0, 0) is False
        assert q.pop() is None


def test_failed_build_falls_back(monkeypatch, tmp_path):
    """Where g++ fails, the runtime reports itself unavailable and every
    entry point runs its fallback."""
    def no_compiler(cmd, **kw):
        raise subprocess.CalledProcessError(1, cmd)

    monkeypatch.setattr(runtime, "_lib", None)
    monkeypatch.setattr(runtime, "_build_failed", False)
    monkeypatch.setattr(runtime, "_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(runtime, "_SO", str(tmp_path / "librtdd_runtime_torch.so"))
    monkeypatch.setattr(runtime.subprocess, "run", no_compiler)
    r = NativeRuntime()
    assert not r.available and runtime._build_failed
    assert not Arena(64).native
    mask, value = _planes()
    assert r.paint(mask, value, 30, 20, 192, 9) == (16, 26, 24, 34)
    assert list(tmp_path.iterdir()) == []


def test_session_buffers_are_arena_backed(rt):
    from realtimedepthdiffusion_tpu_torch.live.session import DepthSession
    from tests.conftest import synthetic_pair

    rgb, _, _ = synthetic_pair(32, 48, 5)
    s = DepthSession(rgb, DiffusionConfig(max_iterations=5), device="cpu")
    assert s.arena.native and s.native.available
    assert s.arena.used >= 2 * 32 * 48 + 3 * 32 * 48
    s.paint(10, 10)
    img = s.edited_image()
    assert img is s._edited_buf  # composited in place, no per-frame alloc
    assert (img[10, 10] == s.scribble_color).all()
