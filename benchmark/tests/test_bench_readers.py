"""Each per-layer reader on a canned traced record, and the reduction of
profiler events to that record."""

from types import SimpleNamespace as NS

import pytest

from benchmark import spec, trace, work

FAITHFUL = spec.config(spec.load(), "faithful_1080p")["diffusion"]
FAST = spec.config(spec.load(), "fast_1080p")["diffusion"]


def ev(name, start, end):
    return NS(name=name, time_range=NS(start=start, end=end))


def canned(config=FAITHFUL):
    """Two updates in a 10 ms window: K2 1 ms, K1 2 ms, K3 0.5 ms, a copy
    0.5 ms; the host painting, solving and reading back."""
    events = [
        ev("bench.window", 0, 10000),
        ev("bench.paint", 0, 100), ev("bench.solve", 100, 5000), ev("cudaGraphLaunch", 100, 150),
        ev("bench.readback", 5000, 10000), ev("aten::copy_", 5000, 9000),
        ev("void jc_sweep_resident_kernel<16>(float*, float*)", 1000, 2000),
        ev("jc_sweep_tiles_kernel(float const*)", 2000, 4000),
        ev("void (anonymous namespace)::defocus_tile_kernel<64, 2>(U8Image)", 4000, 4500),
        ev("Memcpy DtoH (Device -> Pageable)", 6000, 6500),
        ev("before the window", -500, -100),
    ]
    device = {e.name for e in events if "kernel" in e.name or e.name.startswith("Memcpy")}
    rec = trace.record(events, "bench.window", lambda e: e.name in device)
    rec.update({"updates": 2, "rows": 1080, "cols": 1920, "config": config,
                "spans": {"paint": [1e-5, 3e-5], "readback": [1e-3, 3e-3]},
                "stages": {"upload": (4e-3, 2)}, "pairs": [0.2, 0.4, 0.3]})
    return rec


def test_record():
    rec = canned()
    assert rec["window_s"] == pytest.approx(0.01)
    assert rec["busy_s"] == pytest.approx(0.004)
    assert [k for k, _ in rec["device_ops"]] == ["jc_sweep_tiles_kernel",
                                                 "jc_sweep_resident_kernel",
                                                 "defocus_tile_kernel",
                                                 "Memcpy DtoH (Device -> Pageable)"]
    gaps = dict(rec["idle_gaps"])
    # each gap goes to what the host was doing at its middle
    assert gaps["readback/aten::copy_"] == pytest.approx(0.0015 + 0.0035)
    assert gaps["solve"] == pytest.approx(0.001)
    assert sum(gaps.values()) == pytest.approx(0.006)


READS = {
    "paint_us": 20.0,
    "upload_ms": 2.0,
    "readback_ms": 2.0,
    "kernels_per_update": 1.5,
    "device_ms": 2.0,
    "idle_share": 60.0,
    "idle_share.batch": 60.0,
    "pair_ms.batch": 300.0,
    "roofline.jc_sweep": 100 * 2 * work.jc_cascade_s(1080, 1920, 45, 1000) / 0.003,
    "roofline.defocus": 100 * 2 * work.defocus_s(1080, 1920) / 0.0005,
}


@pytest.mark.parametrize("name", sorted(READS))
def test_reader(name):
    assert spec.reader(name)(canned()) == pytest.approx(READS[name])


def test_update_mfu():
    flops = sum(14 * h * w * n for h, w, n in work.cascade_levels(1080, 1920, 45, 1000))
    flops += 20 * 1080 * 1920
    assert spec.reader("update_mfu")(canned()) == pytest.approx(
        100 * 2 * flops / (0.01 * 67e12))


@pytest.mark.parametrize("name", ["roofline.jc_sweep", "update_mfu"])
def test_data_dependent_work_reads_nothing(name):
    assert spec.reader(name)(canned(FAST)) is None


@pytest.mark.parametrize("name", sorted(READS) + ["update_mfu"])
def test_nothing_to_read(name):
    rec = {"updates": 2, "rows": 8, "cols": 8, "config": FAITHFUL, "device": [],
           "busy_s": 0.0, "window_s": 0.01, "spans": {}, "stages": {}}
    assert spec.reader(name)(rec) is None
