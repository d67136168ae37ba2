"""The residual early exit decided on the device and the windowed
incremental re-solve with its window origin on the device
(``core/solver.py:_chunked_early_exit``, ``core/incremental.py``) and their
programs in the pipeline (``pipeline.py``), against the JAX package and the
NumPy oracle on the CPU.

On the CPU the early exit reads its flag on the host and stops issuing
chunks; on a card it issues every chunk and the flag turns those after the
exit into no-ops. Patching ``solver._host_loop`` runs the card's loop here,
on the plain versions (``ops/sweep.py:unless_stopped``): it must give the
host loop's bits and exit log. Early-exit cases put every probe more than
5 % away from the threshold (``_between``), so a different summation order
cannot move the exit to another chunk; outputs are held to JAX's by RMSE
<= 1e-3 on [0, 1] (tests/test_golden.py's bar)."""

import contextlib
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.core import solver as jsolver
from realtimedepthdiffusion_tpu.core import weights as jweights
from realtimedepthdiffusion_tpu.pipeline import DepthPipeline as JPipeline
from realtimedepthdiffusion_tpu_torch import DepthPipeline, interop
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import incremental, solver
from realtimedepthdiffusion_tpu_torch.core import effects as tfx
from realtimedepthdiffusion_tpu_torch.core.weights import edge_weights
from realtimedepthdiffusion_tpu_torch.ops import dispatch, fused_sweep, rb_sweep, sweep
from realtimedepthdiffusion_tpu_torch.oracle import numpy_ref
from tests.conftest import synthetic_pair

CHUNK = 6
ITERS = 40
_no_patch = contextlib.nullcontext


def _rmse(a, b):
    return float(np.sqrt(np.mean(((np.asarray(a) - np.asarray(b)) / 255.0) ** 2)))


def _case(seed, h=48, w=64):
    r = np.random.default_rng(seed)
    gray = r.integers(0, 256, (h, w), dtype=np.uint8)
    gray = ((gray.astype(np.int32) + np.roll(gray, 3, 0) + np.roll(gray, 3, 1)) // 3)
    mask = r.random((h, w)) < 0.06
    value = r.integers(0, 255, (h, w), dtype=np.uint8)
    field = np.kron(r.random((h // 8 + 1, w // 8 + 1)) * 255.0, np.ones((8, 8)))[:h, :w]
    depth = np.where(mask, value, field).astype(np.float32)
    return gray.astype(np.uint8), mask, depth


def _port(case, iters, card_loop=False, monkeypatch=None, **kw):
    """The port's ``solve_level`` on level 1 of 2, and its exit log (read
    with ``read_exit_log``); the card's loop where ``card_loop``."""
    gray, mask, depth = case
    log = []
    with monkeypatch.context() if card_loop else _no_patch() as mp:
        if card_loop:
            mp.setattr(solver, "_host_loop", lambda device: False)
        out = solver.solve_level(torch.from_numpy(depth), torch.from_numpy(mask),
                                 torch.from_numpy(gray), 1, 1, iters, DiffusionConfig(**kw), log)
    if card_loop:
        assert all("_device" in e for e in log)  # nothing was read inside the solve
    return out.numpy(), solver.read_exit_log(log)


def _jax_condition(iters, chunk, tol, probe_after):
    """The reference's loop (``lax.while_loop`` of ``_chunked_early_exit``)
    replayed in numpy: (iterations run, probes) with ``probe_after(i)`` the
    residual after i iterations."""
    i, res, probes = 0, np.float32(np.inf), []
    while i < iters and res >= tol:
        i += min(chunk, iters - i)
        res = np.float32(probe_after(i))
        probes.append(float(res))
    return i, probes


def _between(probes):
    """(tolerance, n): a tolerance at which a run whose probes, never
    exiting, are ``probes`` exits after its n-th probe, before the last,
    with every probe it runs more than 5 % away from the threshold: the
    first n >= 2 that leaves that room, else 1."""
    for n in range(2, len(probes)):
        hi, lo = min(probes[:n - 1]), probes[n - 1]
        if hi > 1.11 * lo:
            return math.sqrt(lo * hi) / 255.0, n
    return 1.11 * probes[0] / 255.0, 1


@pytest.mark.parametrize("sv", ["jacobi_chebyshev", "red_black"])
@pytest.mark.parametrize("metric", ["rms", "max"])
def test_device_loop_matches_jax_solve_level(sv, metric, monkeypatch):
    """The card's loop against JAX's ``solve_level`` with the early exit:
    the exit falls after the same probe on both, before the cap, the
    iterations equal JAX's condition replayed on JAX's own residuals, and
    the outputs agree by RMSE; the host loop gives the card loop's bits
    and log."""
    case = _case(3)
    kw = dict(solver=sv, residual_metric=metric, residual_check_every=CHUNK, early_exit=True)
    _, never = _port(case, ITERS, tolerance=0.0, **kw)
    tol, n = _between(never[0]["probes"])
    got, log = _port(case, ITERS, True, monkeypatch, tolerance=tol, **kw)
    host, host_log = _port(case, ITERS, tolerance=tol, **kw)
    assert np.array_equal(got, host) and log == host_log
    assert log[0]["iters"] == n * CHUNK < ITERS and len(log[0]["probes"]) == n

    gray, mask, depth = case
    jcfg = JConfig(backend="xla", **kw, tolerance=tol)
    jargs = (jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), 1, 1)
    want = np.asarray(jsolver.solve_level(*jargs, ITERS, jcfg))
    assert _rmse(got, want) <= 1e-3
    assert np.array_equal(got[mask], depth[mask])
    jw = jweights.edge_weights(jnp.asarray(gray), jnp.asarray(depth), 1, 1, jcfg)
    res_fn = jsolver.residual_metric_fn(jcfg)
    fixed = dataclasses.replace(jcfg, early_exit=False)

    def probe_after(i):
        u = jsolver.solve_level(*jargs, i, fixed)
        if sv == "jacobi_chebyshev":  # the schedule of i iterations is a prefix of ITERS'
            assert np.array_equal(jsolver.chebyshev_omegas(i, jcfg),
                                  jsolver.chebyshev_omegas(ITERS, jcfg)[:i])
        return res_fn(u, jnp.asarray(mask), jw)

    tol255 = np.float32(tol) * np.float32(255.0)
    want_iters, want_probes = _jax_condition(ITERS, CHUNK, tol255, probe_after)
    assert log[0]["iters"] == want_iters
    np.testing.assert_allclose(log[0]["probes"], want_probes, rtol=1e-3)


@pytest.mark.parametrize("sv", ["jacobi_chebyshev", "jacobi", "red_black"])
def test_unreachable_tolerance_is_the_fixed_count_loop(sv, monkeypatch):
    """tolerance 0: the card's loop (40 = 6 x 6 + 4, the last chunk cut)
    lands on the fixed-count iterate bit for bit, and its log is JAX's
    condition replayed on its own probes."""
    case = _case(4, 40, 56)
    fixed, _ = _port(case, ITERS, solver=sv)
    got, log = _port(case, ITERS, True, monkeypatch, solver=sv, early_exit=True, tolerance=0.0,
                     residual_check_every=CHUNK)
    assert np.array_equal(got, fixed)
    probes = log[0]["probes"]
    assert _jax_condition(ITERS, CHUNK, np.float32(0.0),
                          lambda i: probes[-(-i // CHUNK) - 1]) == (ITERS, probes)
    assert log[0]["iters"] == ITERS and len(probes) == -(-ITERS // CHUNK) == 7


@pytest.mark.parametrize("sv,route", [("jacobi_chebyshev", "planes"), ("red_black", "planes"),
                                      ("jacobi_chebyshev", "fused")])
def test_card_loop_equals_host_loop(sv, route, monkeypatch):
    """The card's loop, whose stopped chunks still run (as no-ops) and
    whose later probes count for nothing, gives the host loop's bits and
    log, on the f32 weight planes (K1, K2; K4, K5) and on the fused route
    (K6), which the CPU takes where the L2 is small."""
    if route == "fused":
        monkeypatch.setattr(dispatch, "l2_bytes", lambda device: 1024)
    case = _case(5)
    kw = dict(solver=sv, early_exit=True, residual_check_every=5)
    _, never = _port(case, ITERS, tolerance=0.0, **kw)
    tol, n = _between(never[0]["probes"])
    host, host_log = _port(case, ITERS, tolerance=tol, **kw)
    got, log = _port(case, ITERS, True, monkeypatch, tolerance=tol, **kw)
    assert np.array_equal(got, host) and log == host_log
    assert log[0]["iters"] == 5 * n < ITERS


def _chunk_runners(case, monkeypatch):
    gray, mask, depth = (torch.from_numpy(a) for a in case)
    cfg = DiffusionConfig()
    wts = edge_weights(gray, depth, 1, 1, cfg)
    abc, om = solver.abc_schedule(ITERS, cfg), solver.rb_omegas(ITERS, cfg)
    return {
        "jacobi": sweep.chunks_plain(depth, mask, wts, abc),
        "red_black": rb_sweep.chunks_plain(depth, mask, wts, om),
        "fused": fused_sweep.fused_chunks_plain(depth, mask, gray, abc, 1, 1, cfg),
    }


@pytest.mark.parametrize("runner", ["jacobi", "red_black", "fused"])
def test_stopped_chunk_is_the_identity(runner, monkeypatch):
    """A plain chunk run with ``stop`` set leaves the state as it is, as a
    stopped kernel launch does; with ``stop`` clear it is the run without a
    flag, bit for bit."""
    state, run, u_of = _chunk_runners(_case(6), monkeypatch)[runner]
    moved = run(state, 0, 7)
    stopped = run(moved, 7, 8, torch.ones((), dtype=torch.int32))
    leaves = (lambda s: s) if isinstance(moved, tuple) else (lambda s: (s,))
    assert all(torch.equal(a, b) for a, b in zip(leaves(stopped), leaves(moved)))
    clear = run(moved, 7, 8, torch.zeros((), dtype=torch.int32))
    free = run(moved, 7, 8)
    assert all(torch.equal(a, b) for a, b in zip(leaves(clear), leaves(free)))
    assert not torch.equal(u_of(free), u_of(moved))


def test_check_stop():
    """The kernels take a 0-d int32 flag on their own device, or none."""
    dev = torch.device("cpu")
    assert sweep.check_stop("k", None, dev) is None
    flag = torch.zeros((), dtype=torch.int32)
    assert sweep.check_stop("k", flag, dev) == flag.data_ptr()
    for bad in (torch.zeros((), dtype=torch.int64), torch.zeros(1, dtype=torch.int32),
                torch.zeros((), dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError, match="0-d int32"):
            sweep.check_stop("k", bad, dev)


def test_read_exit_log_fills_pending_entries():
    """``read_exit_log`` fills each pending entry from its device counts,
    drops the slots of probes that did not run, and leaves read entries
    alone."""
    done = torch.tensor([12, 2], dtype=torch.int32)
    probes = torch.tensor([9.5, 3.25, 1.0, math.nan], dtype=torch.float32)
    read = {"shape": (4, 4), "cap": 5, "iters": 5, "probes": [1.0], "tol": 2.0}
    log = [dict(read), {"shape": (8, 8), "cap": 20, "tol": 2.0, "_device": (done, probes)}]
    assert solver.read_exit_log(log) is log
    assert log == [read, {"shape": (8, 8), "cap": 20, "tol": 2.0, "iters": 12,
                          "probes": [9.5, 3.25]}]


@pytest.mark.parametrize("sv", ["jacobi_chebyshev", "red_black"])
@pytest.mark.parametrize("metric", ["rms", "max"])
def test_device_loop_cascade_matches_jax(sv, metric, monkeypatch):
    """A whole early-exit solve through the pipeline, on the card's loop,
    against JAX's ``solve_cascade`` program: RMSE <= 1e-3, scribbles exact,
    every level reported in order."""
    h, w = 64, 80
    rgb, mask, value = synthetic_pair(h, w, 11)
    kw = dict(solver=sv, residual_metric=metric, early_exit=True, tolerance=2e-3,
              residual_check_every=8, max_iterations=80)
    jpipe = JPipeline(h, w, JConfig(backend="xla", fast_start=False, **kw))
    _, jg = jpipe.prepare_image(rgb)
    jd, _ = jpipe.solve(jg, jnp.asarray(mask), jnp.asarray(value), jpipe.initial_state())
    monkeypatch.setattr(solver, "_host_loop", lambda device: False)
    pipe = DepthPipeline(h, w, DiffusionConfig(fast_start=False, **kw), device="cpu")
    _, g = pipe.prepare_image(rgb)
    log = []
    d, _ = pipe.solve(g, *interop.annotation_from_numpy(mask, value, "cpu"),
                      pipe.initial_state(), log)
    assert _rmse(d.numpy(), np.asarray(jd)) <= 1e-3
    assert np.array_equal(d.numpy()[mask], value[mask].astype(np.float32))
    assert [e["shape"] for e in log] == [tuple(x.shape) for x in g[::-1]]
    assert all(1 <= len(e["probes"]) and "_device" not in e for e in log)


def test_early_exit_pipeline_stores_its_program():
    """An early-exit config captures like any other: with fast_start off
    its first solve stores the program, and a call through it fills the
    exit log as the eager call does (on the CPU the program is the eager
    function, run with the caller's list)."""
    rgb, mask, value = synthetic_pair(64, 80, 12)
    cfg = DiffusionConfig(fast_start=False, solver="red_black", early_exit=True,
                          tolerance=1e-3, residual_check_every=8, max_iterations=40)
    pipe = DepthPipeline(64, 80, cfg, device="cpu")
    _, g = pipe.prepare_image(rgb)
    m, v = interop.annotation_from_numpy(mask, value, "cpu")
    first, second = [], []
    d1, _ = pipe.solve(g, m, v, pipe.initial_state(), first)
    assert ("solve",) in pipe._aot
    d2, _ = pipe.solve(g, m, v, pipe.initial_state(), second)
    assert torch.equal(d1, d2) and first == second and first


# -- the windowed re-solve with its centre on the device --------------------------

H, W = 96, 128  # 3 levels: 96x128, 48x64, 24x32
INC = dict(max_iterations=40, incremental_iterations=40, incremental_window=32)


@pytest.fixture(scope="module")
def inc_run():
    """The port's full solve of a scene, then a scribble near the top-left
    corner."""
    rgb, mask, value = synthetic_pair(H, W, 13)
    pipe = DepthPipeline(H, W, DiffusionConfig(**INC), device="cpu")
    _, g = pipe.prepare_image(rgb)
    _, state = pipe.solve(g, *interop.annotation_from_numpy(mask, value, "cpu"),
                          pipe.initial_state())
    mask2, value2 = mask.copy(), value.copy()
    mask2[2:6, 3:9] = True
    value2[2:6, 3:9] = 200
    return pipe, g, (mask2, value2), state


@pytest.mark.parametrize("center", [(4, 6), [4, 6], np.array([4, 6]),
                                    np.array([4, 6], np.int32),
                                    torch.tensor([4, 6]), torch.tensor([4, 6], dtype=torch.int32)],
                         ids=["tuple", "list", "numpy", "numpy_int32", "tensor", "tensor_int32"])
def test_core_center_forms_agree(inc_run, center):
    """``core/incremental.py:solve_incremental`` takes the centre as ints,
    a numpy array or a tensor, to the same bits."""
    pipe, g, (mask2, value2), state = inc_run
    m, v = interop.annotation_from_numpy(mask2, value2, "cpu")
    want, _ = incremental.solve_incremental(g, m, v, state, (4, 6), pipe.cfg)
    got, _ = incremental.solve_incremental(g, m, v, state, center, pipe.cfg)
    assert torch.equal(got, want)


def test_device_yx_forms():
    """``device_yx`` gives a (2,) int32 tensor on the device and refuses
    what is not one pair."""
    for yx in ((3, 4), np.array([3, 4], np.int64), torch.tensor([3, 4])):
        out = incremental.device_yx("c", yx, "cpu")
        assert out.dtype == torch.int32 and out.tolist() == [3, 4]
    with pytest.raises(ValueError, match="pair"):
        incremental.device_yx("c", (1, 2, 3), "cpu")
    assert incremental.host_yx("c", torch.tensor([7, 8], dtype=torch.int32)) == (7, 8)


@pytest.mark.parametrize("cy,cx", [(0, 0), (-40, 5), (3, 127), (95, 0), (47, 60),
                                   (500, -500), (80, 100)])
@pytest.mark.parametrize("level", [0, 1])
def test_window_indices_clamp_like_clamp_origin(cy, cx, level):
    """The window placed on the device is where ``clamp_origin`` puts it on
    the host: ``(centre >> level) - win // 2``, clamped into the level."""
    h, w, win = H >> level, W >> level, 32 >> level
    rows, cols = incremental.window_indices(torch.tensor([cy, cx], dtype=torch.int32), level,
                                            win, h, w)
    oy, ox = incremental.clamp_origin((cy >> level) - win // 2, (cx >> level) - win // 2,
                                      win, win, h, w)
    assert rows.tolist() == list(range(oy, oy + win))
    assert cols.tolist() == list(range(ox, ox + win))


def _numpy_incremental(gray_pyr, mask0, value0, state, center, cfg):
    """The windowed re-solve of Jacobi-Chebyshev in the NumPy oracle
    (``oracle/numpy_ref.py``), with the port's clamp of the window origin
    and no global sweeps."""
    levels = len(gray_pyr)
    L = levels - 1
    masks, values = [mask0], [value0]
    for lv in range(1, levels):
        m, v = numpy_ref.annotation_pyr_down(masks[-1], values[-1], gray_pyr[lv].shape)
        masks.append(m)
        values.append(v)
    state = [s.copy() for s in state]
    delta = None
    for level in range(L, -1, -1):
        h, w = gray_pyr[level].shape
        win = cfg.incremental_window >> level
        old = state[level]
        u = old if delta is None else old + numpy_ref.pyr_up(delta, (h, w))
        u = numpy_ref.seed_depth(u, masks[level], values[level])
        if not (level < cfg.incremental_window_levels and win < min(h, w)):
            state[level] = numpy_ref.solve_level(u, masks[level], gray_pyr[level], level, L,
                                                 cfg.level_iterations(levels, level), cfg)
        else:
            oy, ox = incremental.clamp_origin((center[0] >> level) - win // 2,
                                              (center[1] >> level) - win // 2, win, win, h, w)
            sl = (slice(oy, oy + win), slice(ox, ox + win))
            ring = np.zeros((win, win), bool)
            ring[[0, -1], :] = ring[:, [0, -1]] = True
            new = u.copy()
            new[sl] = numpy_ref.solve_level(u[sl], masks[level][sl] | ring, gray_pyr[level][sl],
                                            level, L, max(cfg.incremental_iterations >> level, 1),
                                            cfg)
            state[level] = new
        delta = state[level] - old
    return state[0]


@pytest.mark.parametrize("center", [(0, 0), (4, 6), (50, 0), (0, 70)])
def test_near_edges_match_the_numpy_oracle(inc_run, center):
    """At the near edges, where JAX wraps a negative window start to the
    far side, the port's clamp holds against the NumPy oracle given the
    same clamp: RMSE <= 1e-3."""
    pipe, g, (mask2, value2), state = inc_run
    m, v = interop.annotation_from_numpy(mask2, value2, "cpu")
    got, _ = pipe.solve_incremental(g, m, v, state, center)
    cfg = DiffusionConfig(**INC)
    want = _numpy_incremental([x.numpy() for x in g], mask2, value2,
                              [s.numpy() for s in state], center, cfg)
    assert _rmse(got.numpy(), want) <= 1e-3
    assert np.array_equal(got.numpy()[mask2], value2[mask2].astype(np.float32))


@pytest.mark.parametrize("fast,background,want_peek", [(True, True, False), (True, False, True),
                                                       (False, True, True),
                                                       (False, False, True)])
@pytest.mark.parametrize("effect", [None, tfx.EFFECT_HAZE])
def test_incremental_ready_truth_table(fast, background, want_peek, effect):
    """JAX's gate (``pipeline.py:564-589``): True with fast_start or
    background compiles off; else False until the program exists, which a
    kick captures (from stand-ins of the pipeline's shapes) while the
    kicking call still answers False; a peek captures nothing."""
    pipe = DepthPipeline(64, 80, DiffusionConfig(fast_start=fast, **INC), device="cpu")
    pipe.background_compile = background
    key = ("inc",) if effect is None else ("inc_fx", effect)
    assert pipe.incremental_ready(effect, kick=False) is want_peek
    assert key not in pipe._aot
    assert pipe.incremental_ready(effect) is want_peek
    assert (key in pipe._aot) is (not want_peek)
    assert pipe.incremental_ready(effect) is True


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("effect", [None, tfx.EFFECT_HAZE])
def test_incremental_program_routes(inc_run, effect, fast):
    """The first windowed re-solve stores its program (JAX's plain jit
    compiles at the first call), with fast_start on or off; later calls go
    through it at any centre, to the eager bits."""
    _, g, (mask2, value2), state = inc_run
    pipe = DepthPipeline(H, W, DiffusionConfig(fast_start=fast, **INC), device="cpu")
    rgb, _, _ = synthetic_pair(H, W, 13)
    rgb_d, _ = pipe.prepare_image(rgb)
    m, v = interop.annotation_from_numpy(mask2, value2, "cpu")
    key = ("inc",) if effect is None else ("inc_fx", effect)

    def call(center):
        if effect is None:
            return pipe.solve_incremental(g, m, v, state, center)
        return pipe.solve_incremental_and_effect(effect, g, rgb_d, m, v, state, center)

    first = call((4, 6))
    assert key in pipe._aot
    for center in ((4, 6), (90, 120), torch.tensor([30, 40], dtype=torch.int32)):
        eager = incremental.solve_incremental(g, m, v, state, center, pipe.cfg)
        got = call(center)
        assert torch.equal(got[0], eager[0])
        if effect is not None:
            want = pipe.effect(effect, rgb_d, g[0], torch.clamp(eager[0], 0.0, 255.0))
            assert torch.equal(got[2], want)
    assert torch.equal(call((4, 6))[0], first[0])


@pytest.mark.parametrize("early_exit", [False, True])
def test_server_captures_only_under_the_early_exit(tmp_path, early_exit):
    """The directory server keeps its solves eager under fast_start, as the
    JAX server compiles no fused program, except under the residual early
    exit, whose eager solve issues every chunk from the host: there the
    second pair of a shape captures the solve's program, which later pairs
    go through (on the CPU, the eager function)."""
    import os

    from realtimedepthdiffusion_tpu_torch import io, serve

    os.makedirs(tmp_path / "images")
    os.makedirs(tmp_path / "annotations")
    pairs = []
    for i in range(3):
        rgb, mask, value = synthetic_pair(64, 80, 20 + i)
        img, ann = tmp_path / "images" / f"p{i}.png", tmp_path / "annotations" / f"p{i}.png"
        io.imwrite(str(img), rgb)
        io.save_annotation(str(ann), mask, value)
        pairs.append((str(img), str(ann)))
    cfg = DiffusionConfig(fast_start=True, max_iterations=40, solver="red_black",
                          early_exit=early_exit, tolerance=1e-3, residual_check_every=8)
    pipes = {}
    written = serve.solve_pairs(pairs, str(tmp_path / "out"), cfg, tfx.EFFECT_HAZE,
                                pipelines=pipes, device="cpu")
    assert all(written)
    (pipe,) = pipes.values()
    assert pipe.background_compile is early_exit
    assert (("solve_fx", tfx.EFFECT_HAZE) in pipe._aot) is early_exit
