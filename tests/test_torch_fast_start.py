"""The port's program layer (``pipeline.py``), twin of tests/test_fast_start.py:
fast_start's eager ("staged") first solves, the second solve's kick, the
switch to the program, the hooks the session, CLI, server and warmup call,
and the join at exit.

On the CPU a program is the eager function itself (a CUDA graph needs a
card, ``tests/test_torch_cuda.py``), so these tests hold the routing, the
counters and the API, and the bits of both paths against each other and
against the JAX pipeline on the same seeded inputs: depth RMSE <= 1e-3 on
[0, 1] (the port's (a, b, c) sweep rounds otherwise than JAX's xla form),
the u8 readouts of one depth equal. Sizes stay at 64x96 to 80x96 and
40-120 iterations. The suite pins RTDD_FAST_START=0 (tests/conftest.py);
these tests opt in with ``fast_start=True``, as the JAX ones do.

Every JAX test has a twin here, under its name. The port adds three: the
fast_start session without JAX, the program's argument signature and fresh
outputs, and the launch tallies a replay adds."""

import dataclasses
import os
import subprocess
import sys
import textwrap
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.pipeline import DepthPipeline as JPipeline
from realtimedepthdiffusion_tpu_torch import ops
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import effects as fx
from realtimedepthdiffusion_tpu_torch.pipeline import DepthPipeline
from realtimedepthdiffusion_tpu_torch.utils.program import Program, fresh, signature
from tests.conftest import synthetic_pair

H, W = 64, 96
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rmse(a, b):
    return float(np.sqrt(np.mean(((np.asarray(a) - np.asarray(b)) / 255.0) ** 2)))


def _args(pipe, rgb, mask, value):
    rgb_d, gpyr = pipe.prepare_image(rgb)
    return rgb_d, gpyr, torch.from_numpy(mask), torch.from_numpy(value)


def _jax_depth(rgb, mask, value, **kw):
    """The JAX pipeline's fused solve from a fresh state."""
    jp = JPipeline(rgb.shape[0], rgb.shape[1], JConfig(fast_start=False, **kw))
    _, gpyr = jp.prepare_image(rgb)
    d, _ = jp.solve(gpyr, jnp.asarray(mask), jnp.asarray(value), jp.initial_state())
    return jp, d


def _against_jax(depth, jp, jdepth):
    """The port's depth within RMSE 1e-3 of JAX's, and both packages' u8
    readouts of JAX's depth equal."""
    assert _rmse(depth.numpy(), np.asarray(jdepth)) <= 1e-3
    pipe = DepthPipeline(H, W, DiffusionConfig(), device="cpu")
    ours = pipe.depth_u8(torch.from_numpy(np.array(jdepth))).numpy()
    assert np.array_equal(ours, np.asarray(jp.depth_u8(jdepth)))


class _Spy:
    """Counts the calls of a pipeline method through the class."""

    def __init__(self, monkeypatch, name):
        self.calls = []
        real = getattr(DepthPipeline, name)

        def spy(pipe, *a, **kw):
            self.calls.append(threading.get_ident())
            return real(pipe, *a, **kw)

        monkeypatch.setattr(DepthPipeline, name, spy)


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_staged_matches_fused_bitwise(backend):
    """The staged (eager) first solve and the program give the same bits,
    which lets fast_start switch mid-session unseen; both lie within the
    bar of JAX's fused program. ``backend`` is validated and routes nothing
    in the port; JAX runs its xla path or its Pallas kernels (interpret)."""
    rgb, mask, value = synthetic_pair(H, W, 3)
    iters = 40 if backend == "pallas_interpret" else 120
    cfg_fused = DiffusionConfig(backend=backend, max_iterations=iters, fast_start=False)
    jp, jd = _jax_depth(rgb, mask, value, backend=backend, max_iterations=iters)

    pipe_f = DepthPipeline(H, W, cfg_fused, device="cpu")
    _, gpyr, m, v = _args(pipe_f, rgb, mask, value)
    d_first, st_first = pipe_f.solve(gpyr, m, v, pipe_f.initial_state())
    assert ("solve",) in pipe_f._aot  # fast_start off: the first call captures at its end
    d_fused, st_fused = pipe_f.solve(gpyr, m, v, pipe_f.initial_state())

    pipe_s = DepthPipeline(H, W, dataclasses.replace(cfg_fused, fast_start=True), device="cpu")
    pipe_s._kick = lambda *a, **kw: None  # freeze the kick: the solve provably runs staged
    d_staged, st_staged = pipe_s.solve(gpyr, m, v, pipe_s.initial_state())
    assert pipe_s._staged and not pipe_s._aot

    for d, st in ((d_first, st_first), (d_staged, st_staged)):
        assert torch.equal(d, d_fused)
        assert all(torch.equal(a, b) for a, b in zip(st, st_fused))
    _against_jax(d_staged, jp, jd)


def test_background_compiles_never_trace_off_caller_thread(monkeypatch):
    """The port's contract for JAX's: the kick captures ON THE CALLER THREAD
    (the thread that launches into the capture stream), and only
    prewarm_async's preparation (build, card queries, tables) runs on its
    background thread."""
    cfg = DiffusionConfig(max_iterations=40, fast_start=True)
    rgb, mask, value = synthetic_pair(H, W, 3)
    main_id = threading.get_ident()
    captures = []
    real_init = Program.__init__

    def spy_init(self, *a, **kw):
        captures.append(threading.get_ident())
        real_init(self, *a, **kw)

    monkeypatch.setattr(Program, "__init__", spy_init)
    pipe = DepthPipeline(H, W, cfg, device="cpu")
    _, gpyr, m, v = _args(pipe, rgb, mask, value)
    for _ in range(2):
        pipe.solve(gpyr, m, v, pipe.initial_state())
    assert captures == [main_id] and ("solve",) in pipe._aot

    prep = _Spy(monkeypatch, "_prepare")
    pipe2 = DepthPipeline(H, W, cfg, device="cpu")
    pipe2.prewarm_async()
    pipe2._staged_thread.join(timeout=60)
    assert prep.calls == [pipe2._staged_thread.ident] != [main_id]
    assert pipe2._staged


def test_prewarm_async_overlaps_and_first_solve_joins(monkeypatch):
    """prewarm_async prepares the first solve on a background thread; the
    first solve joins it (no second preparation) and gives the bits of an
    un-prewarmed pipeline, within the bar of JAX's. Idempotent, and a no-op
    when fast_start is off."""
    rgb, mask, value = synthetic_pair(H, W, 3)
    cfg = DiffusionConfig(max_iterations=120, fast_start=True)
    prep = _Spy(monkeypatch, "_prepare")
    pipe = DepthPipeline(H, W, cfg, device="cpu")
    pipe._kick = lambda *a, **kw: None  # isolate: no program
    pipe.prewarm_async()
    t = pipe._staged_thread
    assert t is not None
    pipe.prewarm_async()  # idempotent: same thread, no respawn
    assert pipe._staged_thread is t
    _, gpyr, m, v = _args(pipe, rgb, mask, value)
    d1, _ = pipe.solve(gpyr, m, v, pipe.initial_state())
    assert pipe._staged and not t.is_alive()
    assert prep.calls == [t.ident]  # the first solve joined; it did not prepare again

    ref = DepthPipeline(H, W, cfg, device="cpu")
    ref._kick = lambda *a, **kw: None
    d2, _ = ref.solve(gpyr, m, v, ref.initial_state())
    assert torch.equal(d1, d2)
    jp, jd = _jax_depth(rgb, mask, value, max_iterations=120)
    _against_jax(d1, jp, jd)

    off = DepthPipeline(H, W, dataclasses.replace(cfg, fast_start=False), device="cpu")
    off.prewarm_async()
    assert off._staged_thread is None  # no-op without fast_start


def test_fast_start_switches_to_fused_and_results_stable(monkeypatch):
    """First solve: staged, and no kick yet (JAX's deferral). The second
    kicks the program; after wait_fused, solves run the program, with the
    same bits. solve_and_effect: staged solve + effect equals its program,
    bit for bit."""
    rgb, mask, value = synthetic_pair(H, W, 5)
    cfg = DiffusionConfig(max_iterations=120, fast_start=True)
    pipe = DepthPipeline(H, W, cfg, device="cpu")
    rgb_d, gpyr, m, v = _args(pipe, rgb, mask, value)

    d1, st1 = pipe.solve(gpyr, m, v, pipe.initial_state())
    assert pipe._staged and ("solve",) not in pipe._aot  # the deferral
    d1b, _ = pipe.solve(gpyr, m, v, pipe.initial_state())
    assert torch.equal(d1, d1b)
    assert ("solve",) in pipe._aot  # the second solve kicks
    assert pipe.wait_fused(timeout=120)

    replays = []
    real_call = Program.__call__
    monkeypatch.setattr(Program, "__call__",
                        lambda self, *a: (replays.append(1), real_call(self, *a))[1])
    staged = _Spy(monkeypatch, "_ensure_staged")
    d2, st2 = pipe.solve(gpyr, m, v, pipe.initial_state())
    assert replays and not staged.calls, "the program landed but the staged path still ran"
    assert torch.equal(d1, d2) and all(torch.equal(a, b) for a, b in zip(st1, st2))
    jp, jd = _jax_depth(rgb, mask, value, max_iterations=120)
    _against_jax(d2, jp, jd)

    d3, st3, art3 = pipe.solve_and_effect(fx.EFFECT_HAZE, gpyr, rgb_d, m, v,
                                          pipe.initial_state())
    assert ("solve_fx", fx.EFFECT_HAZE) in pipe._aot and pipe.wait_fused(timeout=120)
    replays.clear()
    d4, st4, art4 = pipe.solve_and_effect(fx.EFFECT_HAZE, gpyr, rgb_d, m, v,
                                          pipe.initial_state())
    assert replays
    assert torch.equal(art3, art4) and torch.equal(d3, d4) and torch.equal(d3, d1)


def test_fast_start_aval_mismatch_falls_back(monkeypatch):
    """A program serves only the shapes, dtypes and devices it was captured
    for; a uint8 mask runs eagerly (JAX: the plain jit), with the same
    numbers."""
    rgb, mask, value = synthetic_pair(H, W, 4)
    cfg = DiffusionConfig(max_iterations=60, fast_start=True)
    pipe = DepthPipeline(H, W, cfg, device="cpu")
    _, gpyr, m, v = _args(pipe, rgb, mask, value)
    for _ in range(2):
        pipe.solve(gpyr, m, v, pipe.initial_state())
    assert pipe.wait_fused(timeout=120)
    prog = pipe._aot[("solve",)]
    m8 = torch.from_numpy(mask.astype(np.uint8))
    assert not prog.matches((tuple(gpyr), m8, v, pipe.initial_state()))
    assert prog.matches((tuple(gpyr), m, v, pipe.initial_state()))

    replays = []
    real_call = Program.__call__
    monkeypatch.setattr(Program, "__call__",
                        lambda self, *a: (replays.append(1), real_call(self, *a))[1])
    d_u8, _ = pipe.solve(gpyr, m8, v, pipe.initial_state())
    assert not replays  # the eager path
    d_b, _ = pipe.solve(gpyr, m, v, pipe.initial_state())
    assert replays and torch.equal(d_u8, d_b)


def _session(cfg_kw, monkeypatch):
    from realtimedepthdiffusion_tpu_torch.live.session import DepthSession

    rgb, mask, value = synthetic_pair(80, 96, 9)
    cfg = DiffusionConfig(max_iterations=120, incremental_iterations=60, fast_start=True,
                          **cfg_kw)
    s = DepthSession(rgb, cfg, device="cpu")
    s.mask_np[:] = mask
    s.value_np[:] = value
    s.mark_all_dirty()
    s.solve()  # first solve: full budget
    win = _Spy(monkeypatch, "solve_incremental")
    return s, win


def test_incremental_gate_never_blocks(monkeypatch):
    """While incremental_ready says no, the live loop takes the full warm
    re-solve and kicks after the frame; once it says yes, small strokes take
    the windowed path. The gate is closed until the windowed re-solve's
    program exists, as JAX's is until its compile lands; here it is held
    closed, kick included, and then opened by a kick."""
    s, win = _session({}, monkeypatch)
    assert not s.pipe.incremental_ready(None, kick=False)
    gate = []
    monkeypatch.setattr(type(s.pipe), "incremental_ready",
                        lambda self, effect=None, kick=True: gate.append(kick) or False)
    s.set_color_key(2)
    s.paint(48, 40)
    s.solve()
    assert not win.calls, "frame blocked on the incremental program"
    assert gate == [False, True]  # peek before the frame, kick after it

    monkeypatch.undo()
    win = _Spy(monkeypatch, "solve_incremental")
    assert not s.pipe.incremental_ready(None)  # the kick captures the program
    assert s.pipe.incremental_ready(None) and s.pipe.wait_fused(timeout=120)
    s.paint(50, 42)
    s.solve()
    assert win.calls, "windowed path not taken once the gate opened"


def test_incremental_works_with_background_compile_disabled(monkeypatch):
    """background_compile False (RTDD_BACKGROUND_COMPILE=0, one-shot
    surfaces) must not turn --incremental off: incremental_ready is True
    and the first small stroke takes the windowed path."""
    s, win = _session({}, monkeypatch)
    s.pipe.background_compile = False
    s._inc_pipe.background_compile = False
    assert s.pipe.incremental_ready(None, kick=False)
    s.set_color_key(2)
    s.paint(48, 40)
    s.solve()
    assert win.calls, "windowed path not taken with background compiles disabled"


def test_one_shot_headless_skips_background_compile(tmp_path, monkeypatch):
    """A headless one-shot run exits right after its solve: it captures no
    program, and its solve runs on the staged (eager) path."""
    import realtimedepthdiffusion_tpu_torch.live.session as session_mod
    from realtimedepthdiffusion_tpu_torch import io
    from realtimedepthdiffusion_tpu_torch.live.cli import main

    monkeypatch.setenv("RTDD_FAST_START", "1")
    rgb, mask, value = synthetic_pair(H, W, 2)
    img = tmp_path / "img.png"
    io.imwrite(str(img), rgb)

    captured = []
    real = session_mod.DepthSession

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            captured.append(self)

    monkeypatch.setattr(session_mod, "DepthSession", Spy)
    rc = main(["-i", str(img), "--headless", "--solve", "--device", "cpu"])
    assert rc == 0
    (s,) = captured
    assert s.cfg.fast_start  # the env default applied
    assert s.pipe.background_compile is False
    assert s._inc_pipe is None or s._inc_pipe.background_compile is False
    assert not s.pipe._aot  # nothing was captured
    assert s.pipe._staged  # the staged path served the solve


def test_warmup_tool(capsys):
    """warm_shape runs each path and then reports the programs the JAX tool
    lowers, ``solve`` and ``solve+effect[e]``, with their capture seconds (0
    on the CPU); under the early exit too, which captures like any config."""
    from realtimedepthdiffusion_tpu_torch import warmup

    lines = []
    cfg = DiffusionConfig(max_iterations=40, fast_start=True)
    warmup.warm_shape(H, W, cfg, [fx.EFFECT_HAZE], False, log=lines.append, device="cpu")
    graphs = [ln for ln in lines if ln.endswith(" s") and " graph: " in ln]
    assert [ln.split(": ")[0].strip() for ln in graphs] == [
        f"{H}x{W} solve graph", f"{H}x{W} solve+effect[3] graph"]
    assert all(float(ln.split(": ")[1][:-2]) == 0.0 for ln in graphs)

    lines.clear()
    warmup.warm_shape(H, W, dataclasses.replace(cfg, early_exit=True), [], False,
                      log=lines.append, device="cpu")
    assert f"  {H}x{W} solve graph: 0.000 s" in lines


def test_fast_start_env_default(monkeypatch):
    """RTDD_FAST_START=0 (the suite's default) pins the config default off;
    explicit construction overrides either way. RTDD_BACKGROUND_COMPILE is
    read as the JAX pipeline reads it: '0' and 'false' turn it off."""
    assert os.environ.get("RTDD_FAST_START") == "0"
    assert DiffusionConfig().fast_start is False
    assert DiffusionConfig(fast_start=True).fast_start is True
    for env, want in ((None, True), ("1", True), ("0", False), ("False", False),
                      ("yes", True)):
        if env is None:
            monkeypatch.delenv("RTDD_BACKGROUND_COMPILE", raising=False)
        else:
            monkeypatch.setenv("RTDD_BACKGROUND_COMPILE", env)
        ours = DepthPipeline(H, W, DiffusionConfig(), device="cpu").background_compile
        assert ours is want is JPipeline(H, W, JConfig()).background_compile


def _run(code, timeout=240):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=timeout)


def test_exit_during_background_compile_is_clean():
    """Exiting while prewarm_async's thread is still preparing ends the
    process cleanly: the atexit hook joins the thread before finalization.
    The thread is held inside its preparation until the interpreter
    exits, so it is provably in flight there."""
    proc = _run("""
        import threading, time
        import torch
        from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
        from realtimedepthdiffusion_tpu_torch.pipeline import DepthPipeline
        release = threading.Event()
        real = DepthPipeline._prepare
        def slow(self):
            release.wait(30)
            real(self)
            print("PREPARED", flush=True)
        DepthPipeline._prepare = slow
        pipe = DepthPipeline(96, 128, DiffusionConfig(fast_start=True), device="cpu")
        pipe.prewarm_async()
        assert pipe._staged_thread.is_alive()
        threading.Timer(1.0, release.set).start()
        print("RC-OK", flush=True)
    """)
    assert "RC-OK" in proc.stdout, (proc.stdout, proc.stderr)
    assert proc.returncode == 0, (proc.returncode, proc.stderr[-2000:])
    assert proc.stdout.index("RC-OK") < proc.stdout.index("PREPARED")


def test_fast_start_session_runs_without_jax():
    """With jax and the JAX package unimportable, a fast_start session runs
    its staged solves, its kick and its program on the CPU."""
    proc = _run("""
        import sys
        for name in ("jax", "jaxlib", "realtimedepthdiffusion_tpu"):
            sys.modules[name] = None
        import numpy as np
        from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
        from realtimedepthdiffusion_tpu_torch.live.session import DepthSession
        rgb = np.random.default_rng(0).integers(0, 256, (64, 96, 3), dtype=np.uint8)
        s = DepthSession(rgb, DiffusionConfig(max_iterations=40, fast_start=True),
                         device="cpu")
        s.mask_np[20:30, 30:40] = 1
        s.value_np[20:30, 30:40] = 200
        maps = []
        for _ in range(3):
            s.mark_all_dirty()
            maps.append(s.solve())
        assert ("solve",) in s.pipe._aot and s.pipe._staged
        assert all(m.dtype == np.uint8 and (m[20:30, 30:40] == 200).all() for m in maps)
        assert not any(m.startswith("jax") for m, v in sys.modules.items() if v is not None)
        print("RC-OK")
    """)
    assert proc.returncode == 0 and "RC-OK" in proc.stdout, proc.stderr[-3000:]


def test_program_signature_and_fresh_outputs():
    """A program matches arguments of its structure, shapes, dtypes and
    devices only; its outputs are copies, one per distinct tensor, so that
    depth0 and level 0 of the state stay one tensor, as the eager solve
    returns them."""
    a, b = torch.zeros((2, 3)), torch.ones((1, 2), dtype=torch.uint8)
    sig = signature(((a, a), b))
    assert sig == signature(((a.clone(), torch.zeros((2, 3))), b.clone()))
    assert sig != signature(((a,), b)) and sig != signature(((a, a), b.bool()))
    assert sig != signature(((a, a), b.view(2, 1))) and signature(((a, a), b.numpy())) is None
    out = fresh((a, (a, b), b))
    assert out[0] is out[1][0] and out[1][1] is out[2]
    assert out[0] is not a and out[2] is not b and torch.equal(out[0], a)


def test_replay_adds_the_capture_tally():
    """A replay adds to the launch counts what its capture counted: the
    capture's own counts are taken back out (``Program`` on a card), and
    each replay puts them in again."""
    ops.reset_launch_counts()
    tally = {"jc_sweep_resident": 3, "jc_sweep_tiles": 24, "defocus_box": 1}
    ops.add_launches(tally)
    ops.add_launches({k: -n for k, n in tally.items()})
    assert not any(ops.launch_counts().values())
    for _ in range(2):
        ops.add_launches(tally)
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        k: 2 * n for k, n in tally.items()}
    ops.reset_launch_counts()
    # On the CPU nothing is captured: no tally.
    assert Program(lambda *a: a, (torch.zeros(2),), torch.device("cpu")).tally == {}
