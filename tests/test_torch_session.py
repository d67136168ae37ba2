"""The port's live session (``live/session.py``, ``device="cpu"``) against
the JAX package's (``backend="xla", fast_start=False``) on the same strokes:
a first solve, a drag inside one dirty rect, two distant rects, more rects
than ``incremental_max_rects`` (the nearest merge), an annotation load, an
idle solve and a drag wider than the window (a full re-solve that uploads
its rect alone). Each update: depth within RMSE 1e-3 on [0, 1]
(tests/test_golden.py), scribbled pixels exact, the same dirty rects, the
same path (full or windowed, and through which pipeline), the same upload
window origins and solve centres. The rects lie where every level's window
starts inside the level: the reference wraps a negative start to the far
side, which the port does not copy (tests/test_torch_incremental.py).

Checkpoints load in both directions, and the pending rects the port saves
survive a round trip. Modelled on tests/test_incremental.py:93-236."""

import os

import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.live.session import DepthSession as JSession
from realtimedepthdiffusion_tpu_torch import io
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import effects as fx
from realtimedepthdiffusion_tpu_torch.live.session import DepthSession, window_origin
from tests.conftest import synthetic_pair

H, W = 96, 128  # 2 levels; windows of 32 at L0 and 16 at L1
KW = dict(max_iterations=200, incremental_iterations=40, incremental_window=32,
          incremental_max_rects=2)
# Each update: (name, actions). An action is ("color", digit), ("effect",
# key), ("paint", (x, y)), ("all", None), ``mark_all_dirty``, or ("load",
# None), the annotation PNG of the scene.
SCRIPT = [
    ("first", [("color", 1), ("effect", "b"), ("paint", (40, 40)), ("paint", (42, 41))]),
    ("one_rect", [("color", 3), ("paint", (60, 50)), ("paint", (62, 50)), ("paint", (64, 51))]),
    ("two_rects", [("color", 4), ("paint", (24, 24)), ("color", 0), ("paint", (100, 70))]),
    ("overflow", [("color", 2), ("paint", (20, 20)), ("paint", (100, 60)),
                  ("paint", (104, 74))]),
    ("annotation_load", [("effect", "h"), ("load", None)]),
    ("idle", []),
    # 8 px steps coalesce into one 37x49 rect, wider than the 32 px window:
    # the full warm re-solve with a painted rect.
    ("wide_drag", [("color", 2)] + [("paint", (16 + 8 * i, 20 + 6 * i)) for i in range(7)]),
]
STEPS = [name for name, _ in SCRIPT]


def _rmse(a, b):
    return float(np.sqrt(np.mean(((np.asarray(a, np.float64) - np.asarray(b)) / 255.0) ** 2)))


def _instrument(s, log):
    """Log the session's calls into its pipelines, outermost only (a
    pipeline method may call another): each solve entry point of both
    pipelines, with the centre of a windowed solve, and each window
    upload's origin."""
    inside = []

    def spy(pipe, name, tag, center_at=None):
        real = getattr(pipe, name)

        def wrapper(*args, **kw):
            if inside:
                return real(*args, **kw)
            arg = None if center_at is None else tuple(int(v) for v in np.asarray(args[center_at]))
            log.append((tag, arg))
            inside.append(tag)
            try:
                return real(*args, **kw)
            finally:
                inside.pop()

        setattr(pipe, name, wrapper)

    spy(s.pipe, "solve_incremental", "solve_incremental", center_at=4)
    spy(s.pipe, "solve_incremental_and_effect", "solve_incremental_and_effect", center_at=6)
    spy(s.pipe, "update_annotation_window", "upload_window", center_at=4)
    for tag, pipe in (("pipe", s.pipe), ("inc_pipe", s._inc_pipe)):
        for name in ("solve", "solve_and_effect"):
            spy(pipe, name, f"{tag}.{name}")


def _act(s, actions, ann_path):
    for op, arg in actions:
        if op == "color":
            s.set_color_key(arg)
        elif op == "effect":
            s.set_effect_key(arg)
        elif op == "paint":
            s.paint(*arg)
        elif op == "all":
            s.mark_all_dirty()
        else:
            s.load_annotation_file(ann_path)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    rgb, mask, value = synthetic_pair(H, W, 5)
    ann = str(tmp_path_factory.mktemp("scene") / "ann.png")
    io.save_annotation(ann, mask, value)
    return rgb, ann


@pytest.fixture(scope="module")
def runs(scene):
    """The script through both sessions; per update what each did."""
    rgb, ann = scene
    js = JSession(rgb, JConfig(backend="xla", fast_start=False, **KW))
    ts = DepthSession(rgb, DiffusionConfig(**KW), device="cpu")
    logs = {"jax": [], "port": []}
    _instrument(js, logs["jax"])
    _instrument(ts, logs["port"])
    out = {}
    for name, actions in SCRIPT:
        rec = {}
        for tag, s in (("jax", js), ("port", ts)):
            _act(s, actions, ann)
            logs[tag].clear()
            rects = list(s.dirty_rects)
            u8 = s.solve()
            rec[tag] = {"log": list(logs[tag]), "rects": rects, "u8": u8,
                        "depth": np.array(s.depth0, np.float32),
                        "state": [np.array(d, np.float32) for d in s.depth_state],
                        "art": np.array(s.artistic), "mask": s.mask_np.copy(),
                        "value": s.value_np.copy(), "solve_count": s.solve_count}
        rec["port"]["device_planes"] = (ts._mask_d.clone(), ts._value_d.clone())
        rec["port"]["upload_bytes"] = ts.last_upload_bytes
        out[name] = rec
    return js, ts, out


# What each update does: the path (calls in order) the reference takes too.
WANT_PATH = {
    "first": [("pipe.solve_and_effect", None)],
    "one_rect": [("upload_window", (34, 46)), ("solve_incremental_and_effect", (50, 62))],
    "two_rects": [("upload_window", (8, 8)), ("upload_window", (54, 84)),
                  ("solve_incremental", (24, 24)), ("solve_incremental_and_effect", (70, 100))],
    "overflow": [("upload_window", (4, 4)), ("upload_window", (51, 86)),
                 ("solve_incremental", (20, 20)), ("solve_incremental_and_effect", (67, 102))],
    "annotation_load": [("inc_pipe.solve_and_effect", None)],
    "idle": [("inc_pipe.solve_and_effect", None)],
    "wide_drag": [("inc_pipe.solve_and_effect", None)],
}


@pytest.mark.parametrize("step", STEPS)
def test_update_matches_jax(runs, step):
    _, _, out = runs
    j, p = out[step]["jax"], out[step]["port"]
    assert p["rects"] == j["rects"]
    assert p["log"] == j["log"] == WANT_PATH[step]
    assert np.array_equal(p["mask"], j["mask"]) and np.array_equal(p["value"], j["value"])
    assert _rmse(p["depth"], j["depth"]) <= 1e-3
    for a, b in zip(p["state"], j["state"]):
        assert _rmse(a, b) <= 1e-3
    m = p["mask"] != 0
    for d in (p["depth"], j["depth"]):
        assert np.array_equal(d[m], p["value"][m].astype(np.float32))
    assert p["u8"].dtype == np.uint8 and p["u8"].shape == (H, W)
    assert np.array_equal(p["u8"], np.clip(np.rint(p["depth"]), 0, 255).astype(np.uint8))
    assert p["art"].dtype == np.uint8 and p["art"].shape == (H, W, 3)
    assert float(np.abs(p["art"].astype(int) - j["art"]).mean()) <= 0.5
    assert p["solve_count"] == j["solve_count"] == STEPS.index(step) + 1
    # The device planes hold the host planes after every upload.
    dm, dv = p["device_planes"]
    assert np.array_equal(dm.numpy(), m) and np.array_equal(dv.numpy(), p["value"])


@pytest.mark.parametrize("step,want", [("first", 2 * H * W), ("one_rect", 2 * 32 * 32),
                                       ("two_rects", 4 * 32 * 32), ("annotation_load", 2 * H * W),
                                       ("idle", 0), ("wide_drag", 2 * 37 * 49)])
def test_upload_bytes(runs, step, want):
    """Only the windows' bytes cross for a windowed update, only the rect's
    for a full re-solve of a painted rect; nothing when nothing changed."""
    assert runs[2][step]["port"]["upload_bytes"] == want


# The faithful path (``incremental_iterations`` 0): every update a full
# re-solve. Each step: (name, actions, bytes sent); a 9 px brush.
FULL_SCRIPT = [
    ("first", [("load", None)], 2 * H * W),
    ("one_rect", [("color", 3), ("paint", (40, 30)), ("paint", (44, 32))], 2 * 11 * 13),
    ("corner", [("color", 1), ("paint", (W - 1, H - 1))], 2 * 5 * 5),
    ("two_rects", [("color", 4), ("paint", (20, 70)), ("paint", (110, 20))], 2 * 2 * 9 * 9),
    ("over", [("color", 0), ("paint", (42, 31))], 2 * 9 * 9),
    ("idle", [], 0),
    ("all", [("all", None)], 2 * H * W),
]


@pytest.fixture(scope="module")
def full_runs(scene):
    """FULL_SCRIPT through a port session; per step what it did, and the
    eager solve with its effect on freshly uploaded planes, from the same
    state before it."""
    rgb, ann = scene
    s = DepthSession(rgb, DiffusionConfig(max_iterations=60), device="cpu")
    s.set_effect_key("b")
    s.adjust_radius(8)
    out = {}
    for name, actions, _ in FULL_SCRIPT:
        before = tuple(s.depth_state)
        _act(s, actions, ann)
        rects = list(s.dirty_rects)
        u8 = s.solve()
        m, v = torch.tensor(s.mask_np != 0), torch.tensor(s.value_np)
        depth0, state, art = s.pipe._solve_fx_eager(fx.EFFECT_DEFOCUS, tuple(s.gray_pyr), s.rgb,
                                                     m, v, before)
        out[name] = {"rects": rects, "bytes": s.last_upload_bytes, "u8": u8,
                     "state": tuple(s.depth_state), "art": s.artistic,
                     "planes": (s._mask_d.clone(), s._value_d.clone()), "host": (m, v),
                     "want": (s.pipe.depth_u8(depth0).numpy(), state, art)}
    return out


@pytest.mark.parametrize("step,want_bytes", [(n, b) for n, _, b in FULL_SCRIPT])
def test_full_resolve_writes_the_rects(full_runs, step, want_bytes):
    """A full re-solve sends each pending rect's crop into the resident
    planes (both whole planes for the first solve and the whole image):
    the device planes equal the host planes bit for bit, the bytes are
    twice the rects' area, and the update equals the eager solve on
    planes uploaded whole."""
    r = full_runs[step]
    area = sum((y1 - y0 + 1) * (x1 - x0 + 1) for y0, x0, y1, x1 in r["rects"])
    assert r["bytes"] == want_bytes == (2 * H * W if step in ("first", "all") else 2 * area)
    for got, host in zip(r["planes"], r["host"]):
        assert got.dtype == host.dtype and torch.equal(got, host)
    u8, state, art = r["want"]
    assert np.array_equal(r["u8"], u8) and torch.equal(r["art"], art)
    assert all(torch.equal(a, b) for a, b in zip(r["state"], state))


@pytest.mark.parametrize("c,lo,hi,n,s,want", [
    (50, 50, 51, 96, 32, 34), (5, 0, 10, 96, 32, 0), (95, 90, 95, 96, 32, 64),
    (63, 32, 95, 128, 64, 32), (40, 8, 71, 80, 64, 8), (10, 0, 19, 20, 20, 0)])
def test_window_origin_covers_the_rect(c, lo, hi, n, s, want):
    o = window_origin(c, lo, hi, n, s)
    assert o == want and 0 <= o <= n - s and o <= lo and hi < o + s


def test_dirty_is_read_only():
    """The reference's setter collapsed every pending rect into one; here
    ``dirty`` is the bounding box alone."""
    rgb, _, _ = synthetic_pair(48, 64, 3)
    s = DepthSession(rgb, DiffusionConfig(max_iterations=8), device="cpu")
    assert s.dirty is None
    s.paint(5, 5)
    s.paint(50, 40)
    assert s.dirty_rects == [(5, 5, 5, 5), (40, 50, 40, 50)] and s.dirty == (5, 5, 40, 50)
    with pytest.raises(AttributeError):
        s.dirty = None
    s.mark_all_dirty()
    assert s.dirty_rects == [(0, 0, 47, 63)]


@pytest.fixture(scope="module")
def resumable(scene):
    """A port session after two solves, with two distant strokes pending."""
    rgb, ann = scene
    s = DepthSession(rgb, DiffusionConfig(**KW), device="cpu")
    s.load_annotation_file(ann)
    s.set_effect_key("b")
    s.solve()
    s.paint(40, 40)
    s.solve()
    s.set_color_key(4)
    s.paint(24, 24)
    s.paint(100, 70)
    return s


def test_pending_rects_survive_checkpoint(resumable, tmp_path):
    """Two distant pending rects come back as two, and the resumed
    session's next solve (which uploads both planes, then re-solves the two
    windows) equals the original's next solve."""
    s = resumable
    rects = list(s.dirty_rects)
    assert len(rects) == 2
    path = str(tmp_path / "ckpt.npz")
    s.save_checkpoint(path)
    rgb = s.rgb_np
    r = DepthSession(rgb, DiffusionConfig(**KW), device="cpu")
    r.load_checkpoint(path)
    assert r.dirty_rects == rects
    assert r.solve_count == s.solve_count and r.effect == s.effect == fx.EFFECT_DEFOCUS
    assert (r.scribble_color, r.scribble_radius) == (s.scribble_color, s.scribble_radius)
    assert np.array_equal(r.mask_np, s.mask_np) and np.array_equal(r.value_np, s.value_np)
    for a, b in zip(r.depth_state, s.depth_state):
        assert torch.equal(a, b)
    calls = []
    for name in ("solve_incremental", "solve_incremental_and_effect"):
        real = getattr(r.pipe, name)
        setattr(r.pipe, name,
                lambda *a, real=real, name=name, **kw: (calls.append(name), real(*a, **kw))[1])
    got, want = r.solve(), s.solve()
    # One windowed solve per rect, the last with the effect.
    assert calls == ["solve_incremental", "solve_incremental_and_effect"]
    assert r.last_upload_bytes == 2 * H * W
    assert np.array_equal(got, want) and torch.equal(r.depth0, s.depth0)
    assert torch.equal(r.artistic, s.artistic)
    for a, b in zip(r.depth_state, s.depth_state):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def jax_checkpoint(runs, tmp_path_factory):
    js = runs[0]
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    js.save_checkpoint(path)
    return js, path


@pytest.mark.parametrize("key", ["b", "h"])
def test_jax_checkpoint_loads_into_port(scene, jax_checkpoint, key):
    """A checkpoint the reference wrote (no pending-rect key): planes,
    state and cursor as saved, the whole image marked, and ``render_effect``
    equal to the reference's output on the same state."""
    js, path = jax_checkpoint
    with np.load(path) as data:
        assert "dirty_rects" not in data.files
        saved = {k: data[k] for k in data.files}
    s = DepthSession(scene[0], DiffusionConfig(**KW), device="cpu")
    s.load_checkpoint(path)
    assert np.array_equal(s.mask_np, js.mask_np) and np.array_equal(s.value_np, js.value_np)
    for a, b in zip(s.depth_state, js.depth_state):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert (s.scribble_color, s.scribble_radius, s.effect, s.solve_count) == tuple(
        int(saved[k]) for k in ("scribble_color", "scribble_radius", "effect", "solve_count"))
    assert s.dirty_rects == [(0, 0, H - 1, W - 1)]
    js.set_effect_key(key)
    s.set_effect_key(key)
    assert np.array_equal(s.render_effect(), js.render_effect())


def test_port_checkpoint_loads_into_jax(resumable, tmp_path):
    """The reference's loader reads the port's checkpoint (it ignores the
    pending-rect key) and renders the same effect from it."""
    s = resumable
    path = str(tmp_path / "port.npz")
    s.save_checkpoint(path)
    assert "dirty_rects" in np.load(path).files
    js = JSession(s.rgb_np, JConfig(backend="xla", fast_start=False, **KW))
    js.load_checkpoint(path)
    assert np.array_equal(js.mask_np, s.mask_np) and np.array_equal(js.value_np, s.value_np)
    for a, b in zip(js.depth_state, s.depth_state):
        assert np.array_equal(np.asarray(a), b.numpy())
    assert (js.scribble_color, js.scribble_radius, js.effect, js.solve_count) == (
        s.scribble_color, s.scribble_radius, s.effect, s.solve_count)
    assert np.array_equal(js.render_effect(), s.render_effect())


def test_save_writes_the_reference_files(runs, tmp_path):
    """save(): the same files; the annotation files equal in content, the
    8-bit map within one gray level and the 16-bit map within RMSE 1e-3."""
    js, ts, _ = runs
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jpaths = js.save(jdir, depth16=True)
    tpaths = ts.save(tdir, depth16=True)
    assert [os.path.basename(p) for p in tpaths] == [os.path.basename(p) for p in jpaths] == [
        "AnnotatedImage.png", "DepthMap.png", "ArtisticEffect.png", "DepthMap16.png"]
    for name in ("Annotation.png", "AnnotatedImage.png"):
        a = io.png_decode(open(os.path.join(tdir, name), "rb").read())
        b = io.png_decode(open(os.path.join(jdir, name), "rb").read())
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    d8 = [io.imread_rgb(os.path.join(d, "DepthMap.png")).astype(int) for d in (tdir, jdir)]
    assert np.abs(d8[0] - d8[1]).max() <= 1
    d16 = [io.png_decode(open(os.path.join(d, "DepthMap16.png"), "rb").read()) for d in (tdir, jdir)]
    assert d16[0].dtype == np.uint16
    assert _rmse(d16[0] / 257.0, d16[1] / 257.0) <= 1e-3
    m, v = io.load_annotation(os.path.join(tdir, "Annotation.png"))
    assert np.array_equal(m, ts.mask_np != 0) and np.array_equal(v[m], ts.value_np[m])
    assert "save" in ts.timing_report()


def test_reports_match_jax(runs):
    js, ts, _ = runs
    rep = ts.residual_report()
    jrep = js.residual_report()
    assert rep.split(":")[0] == jrep.split(":")[0] == "Residual (per level)"
    nums = [[float(x) for x in r.replace("/rms", " ").replace("max", " ").split()
             if x[0].isdigit()] for r in (rep, jrep)]
    assert len(nums[0]) == len(nums[1]) == 2 * 2
    np.testing.assert_allclose(nums[0], nums[1], rtol=0.05, atol=2e-3)
    timing = ts.timing_report()
    assert timing.startswith("Processing Time:") and "upload" in timing and "solve" in timing


def test_timing_report_counts_and_spans():
    """The 't' key's report of a traced solve under the early exit: the
    stages and spans in ms, the early exit's counters as plain counts."""
    rgb, _, _ = synthetic_pair(64, 64, 7)
    s = DepthSession(rgb, DiffusionConfig(max_iterations=30, early_exit=True,
                                          residual_check_every=5, solver="red_black"),
                     device="cpu")
    s.paint(32, 32)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        s.solve()
    lines = dict(ln.strip().split(": ", 1) for ln in s.timing_report().splitlines()[1:])
    for name in ("solve", "upload", "session.mask", "session.u8_readback", "program.call"):
        assert lines[name].endswith(" ms") and " calls = " in lines[name], name
    for name in ("exit.chunks_issued", "exit.chunks_live", "exit.px", "exit.px_iters_run"):
        assert int(lines[name]) > 0, name


def test_no_card_raises():
    rgb, _, _ = synthetic_pair(32, 48, 3)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DepthSession(rgb, DiffusionConfig(), device="cuda")


def test_annotation_size_mismatch_raises(tmp_path):
    rgb, _, _ = synthetic_pair(40, 50, 8)
    s = DepthSession(rgb, DiffusionConfig(max_iterations=8), device="cpu")
    p = str(tmp_path / "wrong.png")
    io.save_annotation(p, np.zeros((30, 40), bool), np.zeros((30, 40), np.uint8))
    with pytest.raises(ValueError, match="does not match image"):
        s.load_annotation_file(p)
    ck = str(tmp_path / "wrong.npz")
    np.savez_compressed(ck, mask=np.zeros((30, 40), np.uint8))
    with pytest.raises(ValueError, match="checkpoint shape"):
        s.load_checkpoint(ck)
