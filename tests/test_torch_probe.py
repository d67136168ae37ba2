"""The early exit's residual probe (``ops/probe.py``) on the CPU: its plain
version against the torch sequence the solver's loop ran inline, the
route that ``ops/dispatch.py:level_probe`` picks and records in the exit
log, the session's ``exit.probes_kernel`` counter, and the kernel
wrapper's checks, which refuse CPU tensors before any launch. The kernel
itself runs on the card only (``tests/test_torch_cuda.py``)."""

import math

import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import solver
from realtimedepthdiffusion_tpu_torch.core.weights import edge_weights
from realtimedepthdiffusion_tpu_torch.live.session import DepthSession
from realtimedepthdiffusion_tpu_torch.ops import dispatch, probe
from realtimedepthdiffusion_tpu_torch.ops.sweep import relax_plain
from tests.conftest import synthetic_pair


def _inline(u, mask, wts, metric, n, c, tol, stop, done, probes):
    """The probe as the loop ran it inline before it had a route: the
    residual (``residual_norm`` / ``residual_rms`` as they were written),
    then the bookkeeping."""
    r = relax_plain(u, wts.wl, wts.wr, wts.wu, wts.wd, wts.inv_count) - u
    if metric == "max":
        res = torch.where(mask, 0.0, r).abs().max()
    else:
        r = torch.where(mask, 0.0, r)
        cnt = torch.clamp(torch.where(mask, 0.0, 1.0).sum(), min=1.0)
        res = torch.sqrt((r * r).sum() / cnt)
    live = 1 - stop
    done[0].add_(live, alpha=n)
    done[1].add_(live)
    probes[c] = res
    stop.bitwise_or_(res.ge(tol).logical_not())


def _probe_case(h, w, case, seed=3):
    """(u, mask, wts) of an (h, w) level: a random field under a few
    scribbles; ``nan``: one free pixel NaN; ``masked``: every pixel
    scribbled."""
    r = np.random.default_rng(seed + h * w)
    gray = torch.from_numpy(r.integers(0, 256, (h, w), dtype=np.uint8))
    u = torch.from_numpy((r.random((h, w)) * 255).astype(np.float32))
    mask = torch.from_numpy(r.random((h, w)) < 0.1)
    if case == "masked":
        mask[:] = True
    elif case == "nan":
        mask[h // 2, w // 2] = False
        u[h // 2, w // 2] = math.nan
    return u, mask, edge_weights(gray, u.nan_to_num(), 1, 2, DiffusionConfig())


def _flags(stop, slots=3):
    return (torch.tensor(stop, dtype=torch.int32), torch.tensor([7, 2], dtype=torch.int32),
            torch.full((slots,), -1.0))


@pytest.mark.parametrize("h,w", [(1, 1), (7, 13), (48, 64)])
@pytest.mark.parametrize("case", ["field", "nan", "masked"])
@pytest.mark.parametrize("stop", [0, 1])
@pytest.mark.parametrize("metric", ["rms", "max"])
def test_plain_probe_equals_inline_sequence(h, w, case, stop, metric):
    """``probe_plain`` leaves the residual slot, the counts and the flag as
    the inline sequence did, bit for bit, at a threshold on either side of
    the residual; NaN stops, a fully scribbled level reads 0 (its count
    clamped to 1), a set flag counts nothing and stays set."""
    u, mask, wts = _probe_case(h, w, case)
    res = probe.residual_plain(u, mask, wts, metric)
    if case == "masked":
        assert float(res) == 0.0
    assert math.isnan(float(res)) == (case == "nan")
    for tol in (float(res) * 0.5 + 1e-3, float(res) * 2.0 + 1e-3):
        want, got = _flags(stop), _flags(stop)
        _inline(u, mask, wts, metric, 25, 1, tol, *want)
        probe.probe_plain(u, mask, wts, metric, 25, 1, tol, *got)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
        assert int(got[0]) == int(stop or not float(res) >= tol)
        assert got[1].tolist() == ([7, 2] if stop else [32, 3])


@pytest.mark.parametrize("metric", ["rms", "max"])
def test_solver_residuals_are_the_plain_residual(metric):
    """``residual_rms`` and ``residual_norm``, which the pipeline's
    diagnostics call, are the probe's residual."""
    u, mask, wts = _probe_case(48, 64, "field")
    fn = solver.residual_metric_fn(DiffusionConfig(residual_metric=metric))
    assert torch.equal(fn(u, mask, wts), probe.residual_plain(u, mask, wts, metric))


def test_level_probe_route_and_refusals():
    """A CPU level takes the plain probe; a device with no route and an
    unknown metric are refused before any work."""
    u, mask, wts = _probe_case(7, 13, "field")
    fn, route = dispatch.level_probe(mask, wts, "rms", 1.0)
    assert route == "plain"
    stop, done, probes = _flags(0)
    fn(u, 0, 5, stop, done, probes)
    assert done.tolist() == [12, 3] and probes[0] == probe.residual_plain(u, mask, wts, "rms")
    with pytest.raises(ValueError, match="unsupported device"):
        dispatch.level_probe(mask.to("meta"), wts, "rms", 1.0)
    with pytest.raises(ValueError, match="unknown residual_metric"):
        dispatch.level_probe(mask, wts, "l1", 1.0)


@pytest.mark.parametrize("solver_name", ["red_black", "jacobi_chebyshev"])
def test_exit_log_records_the_probe_route(solver_name):
    """Each level's exit log entry names its probe's route: ``plain`` on
    the CPU, where the loop's probes are the plain version's."""
    u, mask, _ = _probe_case(48, 64, "field")
    gray = torch.from_numpy(np.random.default_rng(1).integers(0, 256, (48, 64), dtype=np.uint8))
    log = []
    solver.solve_level(u, mask, gray, 1, 2, 30, DiffusionConfig(
        solver=solver_name, early_exit=True, residual_check_every=5, tolerance=1e-3), log)
    assert [e["probe"] for e in log] == ["plain"] and 1 <= len(log[0]["probes"]) <= 6


@pytest.mark.parametrize("route,counted", [("kernel", 11), ("plain", None)])
def test_session_counts_kernel_probes(route, counted):
    """``exit.probes_kernel`` counts the issued chunks of the levels whose
    probes ran on the kernel, beside ``exit.chunks_issued``; a session
    whose probes are plain has no such counter."""
    rgb, _, _ = synthetic_pair(32, 48, 3)
    s = DepthSession(rgb, DiffusionConfig(residual_check_every=25), device="cpu")
    s.timer.reset()
    s._count_exits([{"shape": (48, 64), "cap": 120, "tol": 1.0, "probe": route, "iters": 25,
                     "probes": [2.0]},
                    {"shape": (24, 32), "cap": 150, "tol": 1.0, "probe": route, "iters": 50,
                     "probes": [3.0, 0.5]}])
    assert s.timer.counts["exit.chunks_issued"] == 11
    assert s.timer.counts.get("exit.probes_kernel") == counted
    assert ("exit.probes_kernel" in s.timer.totals) == (counted is not None)


def test_kernel_wrapper_refuses_host_tensors():
    """The kernel's wrapper checks its arguments before it loads or
    launches anything: the metric, the level's rank, CPU tensors."""
    u, mask, wts = _probe_case(7, 13, "field")
    planes = (wts.wl, wts.wr, wts.wu, wts.wd, wts.inv_count)
    stop, done, probes = _flags(0)
    partials, ticket = probe.probe_scratch(7, 13, "cpu")
    args = (u, *planes, mask.to(torch.uint8), 5, 0, 1.0, "rms", stop, done, probes, partials,
            ticket)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        probe.residual_probe(*args)
    with pytest.raises(ValueError, match="unknown residual_metric"):
        probe.residual_probe(*args[:10], "mean", *args[11:])
    with pytest.raises(ValueError, match=r"expected \(h, w\)"):
        probe.residual_probe(u[None], *args[1:])


@pytest.mark.parametrize("h,w,blocks", [(1, 1, 1), (16, 16, 1), (16, 17, 2), (192, 192, 144),
                                        (384, 384, 528), (1080, 1920, 528)])
def test_probe_grid_from_the_level_shape(h, w, blocks):
    """A block per 256 pixels, at most ``PROBE_MAX_BLOCKS``; the scratch
    holds a (sum or max, count) slot per block and a ticket at 0."""
    assert probe.probe_blocks(h, w) == blocks
    partials, ticket = probe.probe_scratch(h, w, "cpu")
    assert partials.shape == (2 * blocks,) and partials.dtype == torch.float64
    assert ticket.tolist() == [0] and ticket.dtype == torch.int32
