"""The 4K slice on the CPU: the plain version of K6 (weights derived from u8
planes, ``ops/fused_sweep.py``) against the port's ``edge_weights`` and
against the JAX package's derived-weights megakernel
(``_strip_mega_kernel_uarena``) in interpret mode; the strip route at 4K;
a cascade forced onto K6's route; K3's SAT at DCI 4K; and the TPU-only
kernel variants the port maps onto K1 and K3.

Tolerances: the weights are bit-equal (the same table of exp); a level is
held to the Pallas interpreter at atol 5e-3 gray levels, the JAX suite's
own bar between its kernels and its XLA path (tests/test_pallas.py); a
cascade to JAX ``DepthPipeline.solve`` at RMSE 1e-3 on [0, 1]
(tests/test_golden.py); defocus is integer and exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from realtimedepthdiffusion_tpu.config import DiffusionConfig as JConfig
from realtimedepthdiffusion_tpu.core import effects as jfx
from realtimedepthdiffusion_tpu.ops import pallas_sweep as jps
from realtimedepthdiffusion_tpu.pipeline import DepthPipeline as JPipeline
from realtimedepthdiffusion_tpu_torch import DepthPipeline, interop, ops
from realtimedepthdiffusion_tpu_torch.config import DiffusionConfig
from realtimedepthdiffusion_tpu_torch.core import effects as tfx
from realtimedepthdiffusion_tpu_torch.core import solver
from realtimedepthdiffusion_tpu_torch.core.weights import edge_weights, level_d8
from realtimedepthdiffusion_tpu_torch.ops import defocus, dispatch, fused_sweep, sweep
from tests.conftest import synthetic_pair

LEVEL_RULES = [(0, 3), (1, 3), (3, 3)]  # threshold 0, threshold 4, no depth rule
MiB = 1024 * 1024


def _case(seed, h=49, w=67):
    """gray, mask and a seeded depth that is not integral, so its u8
    truncation (d8) matters to the depth rule."""
    r = np.random.default_rng(seed)
    gray = r.integers(0, 256, (h, w), dtype=np.uint8)
    mask = r.random((h, w)) < 0.06
    value = r.integers(0, 255, (h, w), dtype=np.uint8)
    field = np.kron(r.random((h // 4 + 1, w // 4 + 1)) * 255.0, np.ones((4, 4)))[:h, :w]
    depth = (field + r.random((h, w)) * 0.9).astype(np.float32)
    depth = np.where(mask, value, depth).astype(np.float32)
    return gray, mask, depth


@pytest.mark.parametrize("h,w", [(49, 67), (37, 53)])
@pytest.mark.parametrize("level,max_level", LEVEL_RULES)
def test_derived_weights_equal_edge_weights(h, w, level, max_level):
    gray, _, depth = _case(h + level, h, w)
    g, d = torch.from_numpy(gray), torch.from_numpy(depth)
    got = fused_sweep.derive_weights_plain(g, level_d8(d), level, max_level)
    want = edge_weights(g, d, level, max_level)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and torch.equal(a, b)


def _spy_uarena(monkeypatch):
    calls = []
    real = jps._strips_mega_call_uarena

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(jps, "_strips_mega_call_uarena", spy)
    return calls


@pytest.mark.parametrize("level,max_level", LEVEL_RULES)
def test_fused_level_matches_uarena_kernel(monkeypatch, level, max_level):
    """At 49x67 in 16-row strips this cap lies between the derived-weights
    arena (655,360 bytes) and the f32 arena (884,736), so JAX runs
    ``_strip_mega_kernel_uarena``."""
    gray, mask, depth = _case(level + 7)
    jcfg = JConfig(pallas_arena_vmem_cap=700_000)
    calls = _spy_uarena(monkeypatch)
    want = np.asarray(jps.solve_level_strips(
        jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), level, max_level, 17, jcfg,
        block_h=16, interpret=True))
    assert calls, "JAX did not take the derived-weights kernel"
    abc = solver.abc_schedule(17, DiffusionConfig())
    got = fused_sweep.solve_level_fused_plain(torch.from_numpy(depth), torch.from_numpy(mask),
                                              torch.from_numpy(gray), abc, level, max_level)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=0)
    assert np.array_equal(got.numpy()[mask], depth[mask])


def test_fused_early_exit_matches_uarena_kernel(monkeypatch):
    """The chunked fused level under the early exit against JAX's
    ``solve_level_strips_early_exit`` on the derived-weights kernel. The
    early exit picks its own strips, where the f32 arena is the smaller,
    so the arena is priced out as the JAX suite does. Every probe sits more
    than 5 % from the threshold, so both sides exit after the same chunk."""
    gray, mask, depth = _case(11)
    iters, level, max_level = 17, 1, 3
    kw = dict(early_exit=True, tolerance=2.2e-3, residual_check_every=5)
    calls = _spy_uarena(monkeypatch)
    monkeypatch.setattr(jps, "_arena_bytes", lambda *a, **k: 1 << 60)
    want = np.asarray(jps.solve_level_strips_early_exit(
        jnp.asarray(depth), jnp.asarray(mask), jnp.asarray(gray), level, max_level, iters,
        JConfig(**kw), interpret=True))
    assert calls, "JAX did not take the derived-weights kernel"
    cfg = DiffusionConfig(**kw)
    d, m, g = torch.from_numpy(depth), torch.from_numpy(mask), torch.from_numpy(gray)
    state, run, u_of = fused_sweep.fused_chunks_plain(d, m, g, solver.abc_schedule(iters, cfg),
                                                      level, max_level, cfg)
    log = []
    got = u_of(solver._chunked_early_exit(state, run, u_of, m,
                                          edge_weights(g, d, level, max_level, cfg),
                                          iters, cfg, log)).numpy()
    assert 0 < log[0]["iters"] < iters
    assert all(abs(p - log[0]["tol"]) > 0.05 * log[0]["tol"] for p in log[0]["probes"])
    np.testing.assert_allclose(got, want, atol=5e-3, rtol=0)


# Every level of each size, finest first, with an L2 of 50 MiB, on a card
# that runs K2 clusters of 16 CTAs (the H100) and on one that runs 4: L4,
# L3 and L2 of 1080p (L5, L4 and L3 of 4K) need 4, 8 and 16 CTAs.
ROUTES = {
    ((2160, 3840), 16): ["K6", "K1", "K1", "K2", "K2", "K2"],
    ((2160, 4096), 16): ["K6", "K1", "K1", "K2", "K2", "K2"],
    ((1080, 1920), 16): ["K1", "K1", "K2", "K2", "K2"],
    ((2160, 3840), 4): ["K6", "K1", "K1", "K1", "K1", "K2"],
    ((2160, 4096), 4): ["K6", "K1", "K1", "K1", "K1", "K2"],
    ((1080, 1920), 4): ["K1", "K1", "K1", "K1", "K2"],
}


@pytest.mark.parametrize("hw,max_cluster", list(ROUTES))
def test_strip_route(hw, max_cluster):
    cfg = DiffusionConfig()
    levels = [cfg.level_size(*hw, lv) for lv in range(cfg.num_levels(*hw))]
    assert [sweep.strip_route(h, w, 50 * MiB, max_cluster)
            for h, w in levels] == ROUTES[(hw, max_cluster)]
    assert dispatch.l2_bytes(torch.device("cpu")) == 50 * MiB
    assert sweep.resident_max_cluster(torch.device("cpu")) == 16


@pytest.fixture(scope="module")
def cascade():
    """A default-config cascade at 181x243 (3 levels) by JAX and by the port."""
    rgb, mask, value = synthetic_pair(181, 243)
    jpipe = JPipeline(181, 243, JConfig(backend="xla", fast_start=False))
    _, jg = jpipe.prepare_image(rgb)
    jd, _ = jpipe.solve(jg, jnp.asarray(mask), jnp.asarray(value), jpipe.initial_state())
    pipe = DepthPipeline(181, 243, DiffusionConfig(), device="cpu")
    _, g = pipe.prepare_image(rgb)
    m, v = interop.annotation_from_numpy(mask, value, "cpu")
    d, _ = pipe.solve(g, m, v, pipe.initial_state())
    return {"pipe": pipe, "gpyr": g, "m": m, "v": v, "mask": mask, "value": value,
            "jd": np.asarray(jd), "d": d}


def test_cascade_on_forced_fused_route(cascade, monkeypatch):
    """With no L2, on a card that runs K2 clusters of 4 CTAs, every level that
    K2 cannot hold takes K6's route (L0 and L1 here): bit-equal to the
    normal route on the CPU, within RMSE 1e-3 of JAX, scribbles exact."""
    derived = []
    real = fused_sweep.derive_weights_plain

    def spy(gray, *a, **kw):
        derived.append(tuple(gray.shape))
        return real(gray, *a, **kw)

    monkeypatch.setattr(fused_sweep, "derive_weights_plain", spy)
    monkeypatch.setattr(dispatch, "l2_bytes", lambda device: 0)
    monkeypatch.setattr(sweep, "resident_max_cluster", lambda device: 4)
    pipe = cascade["pipe"]
    d, _ = pipe.solve(cascade["gpyr"], cascade["m"], cascade["v"], pipe.initial_state())
    assert derived == [(90, 121), (181, 243)]
    assert torch.equal(d, cascade["d"])
    d = d.numpy()
    assert float(np.sqrt(np.mean(((d - cascade["jd"]) / 255.0) ** 2))) <= 1e-3
    mask, value = cascade["mask"], cascade["value"]
    assert np.array_equal(d[mask], value[mask].astype(np.float32))


def test_defocus_sat_all_255_at_dci_4k():
    """255*2160*4096 passes 2^31 - 1: the SAT must not wrap into a wrong box."""
    h, w = 2160, 4096
    rgb = torch.full((h, w, 3), 255, dtype=torch.uint8)
    depth = torch.linspace(0.0, 255.0, w).repeat(h, 1)
    with pytest.warns(RuntimeWarning, match="max_half 57"):
        out = defocus.defocus_sat(rgb, depth)
    assert out.dtype == torch.uint8 and tuple(out.shape) == (h, w, 3)
    assert bool((out == 255).all())


@pytest.mark.parametrize("cfg_kw", [
    {"pallas_defocus_variant": "stacked"},
    {"pallas_defocus_variant": "coldiff", "backend": "pallas_interpret"},
])
def test_defocus_variants_equal_defocus_xla(cfg_kw):
    """The TPU's stacked and coldiff defocus kernels give the default
    output; the port computes it under either name."""
    r = np.random.default_rng(97)
    rgb = r.integers(0, 256, (97, 203, 3), dtype=np.uint8)
    depth = (r.random((97, 203)) * 255).astype(np.float32)
    want = np.asarray(jfx.defocus_xla(jnp.asarray(rgb), jnp.asarray(depth), JConfig()))
    got = tfx.defocus(torch.from_numpy(rgb), torch.from_numpy(depth), DiffusionConfig(**cfg_kw))
    assert np.array_equal(got.numpy(), want)


def test_state_prefetch_level_equals_default():
    """``pallas_state_prefetch`` picks a TPU kernel of the same iterate."""
    gray, mask, depth = _case(3)
    args = (torch.from_numpy(depth), torch.from_numpy(mask), torch.from_numpy(gray), 0, 1, 25)
    got = solver.solve_level(*args, DiffusionConfig(pallas_state_prefetch=True))
    assert torch.equal(got, solver.solve_level(*args, DiffusionConfig()))


@pytest.mark.parametrize("k", [1, 8, 12, 16, 17, 32])
def test_fused_tile_shapes_fit(k):
    """K6 runs in K1's CTA shape for its ring: a positive interior, and two
    f32 buffers of the extended tile and its one-pixel ring, 8 bytes a
    pixel, within one CTA's shared memory (35 KB for the 64x64 tile)."""
    bx, by, rows = sweep.tile_config(k)
    assert bx * by <= (512 if rows == 8 else 1024)
    assert bx - 2 * k > 0 and by * rows - 2 * k > 0
    want = (by * rows + 2) * (bx + 2) * fused_sweep.FUSED_BYTES_PER_PX
    assert fused_sweep.FUSED_BYTES_PER_PX == 8
    assert fused_sweep.fused_smem_bytes(k) == want <= sweep.SMEM_PER_CTA
    if k <= 16:
        assert want == 66 * 66 * 8


def test_fused_wrapper_refuses_cpu_tensors():
    ops.reset_launch_counts()
    f = torch.zeros((8, 9))
    m = torch.zeros((8, 9), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        fused_sweep.jc_sweep_fused(f, f, f, f, m, m, m, torch.zeros((4, 3)), torch.zeros(256),
                                   0, 4, 0, True)
    with pytest.raises(ValueError, match="CUDA"):
        fused_sweep.solve_level_fused_cuda(f, m.bool(), m, solver.abc_schedule(4), 0, 1)
    assert ops.launch_counts()["jc_sweep_fused"] == 0
