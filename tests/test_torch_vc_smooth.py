"""The V-cycle's error smoother (``csrc/vc_smooth.cu``, ``ops/vc_smooth.py``):
its plan and routing on the CPU, and on the card the kernels against the
plain pass bit for bit, the whole polish on the kernel route against the
plain route, and a replayed V-cycle update against its eager solve.

The card tests carry the ``cuda`` marker and skip without a CUDA device.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_vc_smooth.py
"""

import collections
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu_torch import ops
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import multigrid
from realtimedepthdiffusion_tpu_torch.core.solver import jacobi_sweep_raw
from realtimedepthdiffusion_tpu_torch.core.weights import edge_weights
from realtimedepthdiffusion_tpu_torch.ops import dispatch, vc_smooth

ROOT = pathlib.Path(__file__).resolve().parent.parent
CFG = DiffusionConfig()
# The level shapes of a 1080p and of a 4K pyramid, finest first.
LEVELS_1080P = [CFG.level_size(1080, 1920, lv) for lv in range(CFG.num_levels(1080, 1920))]
LEVELS_4K = [CFG.level_size(2160, 3840, lv) for lv in range(CFG.num_levels(2160, 3840))]
# A pass longer than the tile route's deepest ring: chunks on the tiles.
CHUNKED = vc_smooth.MAX_TILE_SWEEPS + 4


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the smoother's kernels have no CPU form")
    return torch.device("cuda", 0)


def _pass_case(device, h, w, seed, scribbles="random", zero_start=True):
    """(e, rhs, mask, wts) of a smoothing pass on an (h, w) level: the
    weights of a random gray level and depth, a random right-hand side, e 0
    or random (also on the scribbles: the kernel must read what it is
    given), and the scribbles ``random`` (2 % of the pixels and the image's
    border), ``border``, ``interior`` (a block inside), ``all`` or
    ``none``."""
    r = np.random.default_rng(seed)
    gray = torch.from_numpy(r.integers(0, 256, (h, w), dtype=np.uint8))
    depth = torch.from_numpy((r.random((h, w)) * 255).astype(np.float32))
    mask = np.zeros((h, w), bool)
    if scribbles in ("random", "border"):
        mask[0], mask[-1], mask[:, 0], mask[:, -1] = True, True, True, True
    if scribbles == "random":
        mask |= r.random((h, w)) < 0.02
    elif scribbles == "interior":
        mask[h // 3:h // 3 + max(h // 4, 1), w // 3:w // 3 + max(w // 4, 1)] = True
    elif scribbles == "all":
        mask[:] = True
    wts = edge_weights(gray, depth, 1, 2)
    rhs = torch.from_numpy(r.normal(0.0, 4.0, (h, w)).astype(np.float32))
    e = (torch.zeros((h, w)) if zero_start
         else torch.from_numpy(r.normal(0.0, 2.0, (h, w)).astype(np.float32)))
    move = lambda t: t.to(device).contiguous()  # noqa: E731
    return (move(e), move(rhs), move(torch.from_numpy(mask)),
            type(wts)(*(move(t) for t in wts)))


# ----------------------------------------------------------------- the CPU
@pytest.mark.parametrize("h,w", LEVELS_1080P + LEVELS_4K[-2:])
@pytest.mark.parametrize("sweeps", [0, 1, 8, 16, CHUNKED, 200])
def test_smooth_plan_routes_each_level(h, w, sweeps):
    """The coarsest level of 1080p and 4K (67 x 120) is resident: one
    launch a pass, whatever its sweeps; every finer level takes the tiles,
    one launch a pass up to ``MAX_TILE_SWEEPS`` sweeps, then chunks."""
    route, launches = vc_smooth.smooth_plan(h, w, sweeps)
    assert sum(launches) == sweeps and all(n > 0 for n in launches)
    if (h, w) == (67, 120):
        assert route == "resident" and vc_smooth.resident_fits(h, w)
        assert launches == ([sweeps] if sweeps else [])
    else:
        assert route == "tiles" and not vc_smooth.resident_fits(h, w)
        assert len(launches) == -(-sweeps // vc_smooth.MAX_TILE_SWEEPS)
        assert all(n <= vc_smooth.MAX_TILE_SWEEPS for n in launches)


def test_assumed_coarsest_shapes():
    assert LEVELS_1080P == [(1080, 1920), (540, 960), (270, 480), (135, 240), (67, 120)]
    assert LEVELS_4K[-1] == (67, 120) and len(LEVELS_4K) == 6


# (h, w, whether one CTA holds it), at the edges of its threads.
RESIDENT_CASES = [(1, 1, True), (5, 7, True), (67, 120, True), (72, 128, True),
                  (73, 128, False), (9, 1024, True), (10, 1024, False), (17, 500, True),
                  (1, 1025, False), (135, 240, False)]


@pytest.mark.parametrize("h,w,fits", RESIDENT_CASES)
def test_resident_fits_by_threads_and_shared_memory(h, w, fits):
    """A CTA of a warp's multiple of columns and ceil(h / 9) thread rows of
    9 pixels, within 1024 threads and one CTA's shared memory."""
    bx, by = -(-w // 32) * 32, -(-h // vc_smooth.RESIDENT_ROWS)
    assert vc_smooth.resident_fits(h, w) == fits == (bx * by <= vc_smooth.RESIDENT_THREADS)
    assert vc_smooth._smem(by * vc_smooth.RESIDENT_ROWS, bx) <= vc_smooth.SMEM_PER_CTA or not fits


def test_a_1080p_solve_issues_18_smoothing_launches():
    """Two cycles, each a pre- and a post-smoothing pass of 8 sweeps on the
    four finer levels and 200 sweeps at the coarsest: 18 passes, one launch
    each, in place of the ~9,000 kernels of 528 plain sweeps."""
    passes = []
    for _ in range(CFG.vcycles):
        for h, w in LEVELS_1080P[:-1]:
            passes += [(h, w, CFG.vcycle_pre_smooth), (h, w, CFG.vcycle_post_smooth)]
        passes.append((*LEVELS_1080P[-1], CFG.vcycle_coarse_iters))
    plans = [vc_smooth.smooth_plan(*p) for p in passes]
    assert len(passes) == 18 and sum(len(launches) for _, launches in plans) == 18
    assert sum(n for _, _, n in passes) == 528
    assert collections.Counter(route for route, _ in plans) == {"tiles": 16, "resident": 2}


@pytest.mark.parametrize("sweeps", [0, 3])
def test_cpu_takes_the_plain_pass(sweeps):
    """On the CPU ``_smooth_error`` is the plain pass: the sweeps the polish
    ran before the kernels, bit for bit; nothing launches, and the pass is
    counted on the plain route (none for 0 sweeps)."""
    e, rhs, mask, wts = _pass_case("cpu", 37, 53, 5, zero_start=False)
    want = e
    for _ in range(sweeps):
        want = torch.where(mask, 0.0, jacobi_sweep_raw(want, wts) + rhs)
    before = collections.Counter(dispatch.smooth_passes)
    ops.reset_launch_counts()
    got = multigrid._smooth_error(e, rhs, mask, wts, sweeps)
    assert torch.equal(got, want) and torch.equal(vc_smooth.smooth_plain(e, rhs, mask, wts,
                                                                        sweeps), want)
    assert not any(ops.launch_counts().values())
    counted = collections.Counter(dispatch.smooth_passes)
    counted.subtract(before)
    assert +counted == ({"plain": 1} if sweeps else {})


def test_kernel_wrappers_refuse_cpu_tensors():
    e, rhs, mask, wts = _pass_case("cpu", 8, 8, 1)
    with pytest.raises(ValueError, match="CUDA"):
        vc_smooth.vc_smooth_tiles(e, e.clone(), rhs, wts.wr, wts.wd, wts.inv_count,
                                  mask.view(torch.uint8), 1, 1)
    with pytest.raises(ValueError, match="CUDA"):
        vc_smooth.vc_smooth_resident(e, e.clone(), rhs, wts.wr, wts.wd, wts.inv_count,
                                     mask.view(torch.uint8), 1)


def _polish_ms_patterns():
    path = ROOT / "benchmark" / "metrics" / "polish_ms.py"
    spec = importlib.util.spec_from_file_location("polish_ms_patterns", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.K1, mod.K3


def test_kernel_names_stay_inside_the_polish_window():
    """``polish_ms`` opens its window at the last K1 launch and closes it at
    K3: a smoother named like either would cut the polish's time short.
    The smoother's kernels have names of their own."""
    src = (ROOT / "realtimedepthdiffusion_tpu_torch" / "csrc" / "vc_smooth.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\(\w+\)\s+)?(\w+)", src)
    assert sorted(names) == ["vc_smooth_resident_kernel", "vc_smooth_tiles_kernel"]
    k1, k3 = _polish_ms_patterns()
    assert k1.match("jc_sweep_tiles_kernel") and k3.match("defocus_tile_kernel")
    assert not any(p.match(n) for p in (k1, k3) for n in names)


# ---------------------------------------------------------------- the card
def _equal_on_card(got, want, what):
    torch.cuda.synchronize()
    diff = float((got.double() - want.double()).abs().max())
    assert torch.equal(got, want), f"{what}: max abs diff {diff}"


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", LEVELS_1080P)
@pytest.mark.parametrize("sweeps", [8, CHUNKED, 200])
@pytest.mark.parametrize("zero_start", [True, False])
def test_smoother_equals_plain_at_the_level_shapes(dev, h, w, sweeps, zero_start):
    """Each 1080p level shape (67 x 120 is 4K's coarsest too) at 8, a
    chunked count and 200 sweeps, from e = 0 (a pre-smoothing or the coarse
    solve) and from a nonzero e (a post-smoothing), with random scribbles
    and the image's border scribbled: the kernels give the plain pass's
    bits, in the launches ``smooth_plan`` gives."""
    e, rhs, mask, wts = _pass_case(dev, h, w, h * w + sweeps, zero_start=zero_start)
    ops.reset_launch_counts()
    got = vc_smooth.smooth_cuda(e, rhs, mask, wts, sweeps)
    route, launches = vc_smooth.smooth_plan(h, w, sweeps)
    assert ops.launch_counts()["vc_smooth_" + route] == len(launches)
    want = vc_smooth.smooth_plain(e, rhs, mask, wts, sweeps)
    _equal_on_card(got, want, (h, w, sweeps))
    assert not got[mask].any()


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(67, 120), (270, 480)])
@pytest.mark.parametrize("scribbles", ["border", "interior", "all", "none"])
@pytest.mark.parametrize("sweeps", [8, 200])
def test_smoother_equals_plain_by_scribbles(dev, h, w, scribbles, sweeps):
    """Both routes with scribbles on the border only, in a block inside, on
    every pixel (the pass gives 0 everywhere) and nowhere."""
    e, rhs, mask, wts = _pass_case(dev, h, w, 7, scribbles, zero_start=False)
    got = dispatch.smooth_error(e, rhs, mask, wts, sweeps)
    _equal_on_card(got, vc_smooth.smooth_plain(e, rhs, mask, wts, sweeps), (scribbles, h, w))
    if scribbles == "all":
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,fits", RESIDENT_CASES)
@pytest.mark.parametrize("sweeps", [1, 9, 200])
def test_resident_equals_plain_where_it_fits(dev, h, w, fits, sweeps):
    """The resident route on every level one CTA holds; the wrapper refuses
    the others."""
    e, rhs, mask, wts = _pass_case(dev, h, w, h + w, zero_start=False)
    out = torch.empty_like(e)
    args = (e, out, rhs, wts.wr, wts.wd, wts.inv_count, mask.view(torch.uint8), sweeps)
    if not fits:
        with pytest.raises(ValueError, match="does not hold"):
            vc_smooth.vc_smooth_resident(*args)
        return
    vc_smooth.vc_smooth_resident(*args)
    _equal_on_card(out, vc_smooth.smooth_plain(e, rhs, mask, wts, sweeps), (h, w))


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(1, 70), (5, 3), (33, 65), (100, 130), (73, 1100)])
@pytest.mark.parametrize("k", [1, 3, 8, vc_smooth.MAX_TILE_SWEEPS])
def test_tiles_equal_plain_at_every_ring(dev, h, w, k):
    """The tile route at odd shapes (one row, levels smaller than a tile,
    ragged tiles), k sweeps at ring k and fewer sweeps than the ring."""
    e, rhs, mask, wts = _pass_case(dev, h, w, 3 * h + k, zero_start=False)
    for n in sorted({1, k}):
        out = torch.empty_like(e)
        vc_smooth.vc_smooth_tiles(e, out, rhs, wts.wr, wts.wd, wts.inv_count,
                                  mask.view(torch.uint8), n, k)
        _equal_on_card(out, vc_smooth.smooth_plain(e, rhs, mask, wts, n), (h, w, n, k))


def _vcycle_inputs(dev, h, w, seed):
    from realtimedepthdiffusion_tpu_torch import DepthPipeline
    from realtimedepthdiffusion_tpu_torch.core.multigrid import vcycle_warm_config, solve_cascade

    r = np.random.default_rng(seed)
    coarse = r.integers(0, 256, (h // 16 + 1, w // 16 + 1, 3))
    rgb = np.clip(np.kron(coarse, np.ones((16, 16, 1), np.int64))[:h, :w]
                  + r.integers(-4, 5, (h, w, 3)), 0, 255).astype(np.uint8)
    mask = np.zeros((h, w), bool)
    value = np.zeros((h, w), np.uint8)
    for i, d in enumerate((0, 128, 254)):
        y, x = (i + 1) * h // 4, (i + 1) * w // 4
        mask[y:y + 40, x:x + 60], value[y:y + 40, x:x + 60] = True, d
    mask[:3], value[:3] = True, 40  # a scribble along the top border
    cfg = DiffusionConfig(multigrid="vcycle")
    pipe = DepthPipeline(h, w, cfg, device=dev)
    _, gpyr = pipe.prepare_image(rgb)
    m, v = torch.from_numpy(mask).to(dev), torch.from_numpy(value).to(dev)
    warm, _ = solve_cascade(gpyr, m, v, pipe.initial_state(), vcycle_warm_config(cfg))
    return cfg, pipe, gpyr, m, v, warm


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(1080, 1920), (270, 480)])
def test_polish_on_the_kernels_equals_the_plain_polish(dev, monkeypatch, h, w):
    """A whole ``vcycle_polish`` on the card, its passes on the kernels (18
    launches at 1080p: 16 on the tiles, 2 resident) against the same polish
    with every pass on the plain route: equal bit for bit."""
    cfg, _, gpyr, m, v, warm = _vcycle_inputs(dev, h, w, h)
    ops.reset_launch_counts()
    got = multigrid.vcycle_polish(gpyr, m, v, warm, cfg)
    counts = {k: n for k, n in ops.launch_counts().items() if n}
    with monkeypatch.context() as mp:
        mp.setattr(dispatch, "_SMOOTH", (vc_smooth.smooth_plain,) * 2)
        ops.reset_launch_counts()
        want = multigrid.vcycle_polish(gpyr, m, v, warm, cfg)
        assert not any(ops.launch_counts().values())
    _equal_on_card(got, want, (h, w))
    if (h, w) == (1080, 1920):
        assert counts == {"vc_smooth_tiles": 16, "vc_smooth_resident": 2}
    assert torch.equal(got[m], v[m].to(torch.float32))


@pytest.mark.cuda
def test_replayed_vcycle_update_equals_its_eager_solve(dev):
    """A V-cycle pipeline at 270 x 480 captures its solve's graph at the
    first call; each replay equals the eager solve on the same inputs bit
    for bit, and adds its capture's smoothing passes (on the kernel route,
    two a finer level and one at the coarsest, each cycle) and launches."""
    cfg, pipe, gpyr, m, v, _ = _vcycle_inputs(dev, 270, 480, 9)
    state = pipe.initial_state()
    passes = cfg.vcycles * (2 * (pipe.levels - 1) + 1)
    for i in range(3):
        before = collections.Counter(dispatch.smooth_passes)
        ops.reset_launch_counts()
        got = pipe.solve(gpyr, m, v, state)
        counts = {k: n for k, n in ops.launch_counts().items() if n}
        assert ("solve",) in pipe._aot
        assert dispatch.smooth_passes["kernel"] - before["kernel"] == passes, i
        assert dispatch.smooth_passes["plain"] == before["plain"]
        assert counts.get("vc_smooth_tiles", 0) + counts.get("vc_smooth_resident", 0) >= passes
        ops.reset_launch_counts()
        want = pipe._solve_eager(tuple(gpyr), m, v, tuple(state))
        assert {k: n for k, n in ops.launch_counts().items() if n} == counts
        _equal_on_card(got[0], want[0], i)
        assert all(torch.equal(a, b) for a, b in zip(got[1], want[1])), i
        state = got[1]
