"""The readers of the port's own spans and counters (``metrics/*.py``) on
canned traced records: each reads the value its record implies, and
nothing where the record lacks what it reads (a port that records no
spans)."""

from types import SimpleNamespace as NS

import pytest

from benchmark import spec, trace, work

FAST = spec.config(spec.load(), "fast_1080p")["diffusion"]


def ev(name, start, end):
    return NS(name=name, time_range=NS(start=start, end=end))


def canned(stages):
    """Two updates in a 10 ms window: K4 1 ms and K5 0.5 ms on the card,
    a copy 0.5 ms; ``stages`` as ``drivers/session.py`` hands them over."""
    events = [
        ev("bench.window", 0, 10000),
        ev("bench.solve", 0, 9000), ev("program.call", 100, 2100),
        ev("void rb_sweep_tiles_kernel<8, 4, 2>(float const*, float*)", 1000, 2000),
        ev("rb_sweep_resident_kernel(float*)", 3000, 3500),
        ev("Memcpy DtoH (Device -> Pageable)", 6000, 6500),
    ]
    device = {e.name for e in events if "kernel" in e.name or e.name.startswith("Memcpy")}
    rec = trace.record(events, "bench.window", lambda e: e.name in device)
    rec.update({"updates": 2, "rows": 1080, "cols": 1920, "config": FAST, "stages": stages})
    return rec


STAGES = {
    "upload": (2e-3, 2), "solve": (12e-3, 2),
    "program.call": (5e-3, 3), "program.replay": (3e-3, 3), "program.eager": (1e-3, 1),
    "program.copy_in": (4e-4, 3), "program.copy_out": (2e-4, 3),
    "session.u8_readback": (7e-3, 2), "session.window_solve": (5e-3, 1),
    "exit.chunks_issued": (0.0, 156), "exit.chunks_live": (0.0, 39),
    "exit.px": (0.0, 700000), "exit.px_iters_run": (0.0, 30_000_000),
}
# per update: the K4 and K5 seconds are 1.5e-3 in all
RB_LEAST = work.least_s(11 * 30_000_000, 21 * 700000)
READS = {
    "program_host_ms": 2.5,
    "solve_wait_ms": 3.5,
    "replay_share": 75.0,
    "window_share": 50.0,
    "live_chunk_share": 25.0,
    "roofline.rb_sweep": 100.0 * RB_LEAST / 1.5e-3,
}
# What each reader needs: with these keys gone, it has nothing to read.
NEEDS = {
    "program_host_ms": ["program.call"],
    "solve_wait_ms": ["session.u8_readback"],
    "replay_share": ["program.replay", "program.eager"],
    "window_share": ["program.call"],
    "live_chunk_share": ["exit.chunks_issued"],
    "roofline.rb_sweep": ["exit.px"],
}


@pytest.mark.parametrize("name", sorted(READS))
def test_reader(name):
    assert spec.reader(name)(canned(STAGES)) == pytest.approx(READS[name])


@pytest.mark.parametrize("name", sorted(NEEDS))
def test_reader_without_its_keys(name):
    stages = {k: v for k, v in STAGES.items() if k not in NEEDS[name]}
    assert spec.reader(name)(canned(stages)) is None
    assert spec.reader(name)(canned({})) is None


def test_rb_roofline_work_and_kernels():
    """The least time is the larger of the FLOPs of the iterations run and
    the bytes of the levels' calls; nothing to read where K4 and K5 did not
    run."""
    assert RB_LEAST == pytest.approx(max(11 * 30e6 / 67e12, 21 * 7e5 / 3.35e12))
    rec = canned(STAGES)
    rec["device"] = [d for d in rec["device"] if not d[0].startswith("rb_sweep")]
    assert spec.reader("roofline.rb_sweep")(rec) is None


def test_shares_at_their_ends():
    """window_share reads 0 where the program layer ran and no update was
    windowed; replay_share 100 where every solve replayed."""
    stages = {k: v for k, v in STAGES.items()
              if k not in ("session.window_solve", "program.eager")}
    rec = canned(stages)
    assert spec.reader("window_share")(rec) == 0.0
    assert spec.reader("replay_share")(rec) == 100.0


def test_replay_share_needs_the_device():
    """On the CPU, where the trace holds no device operation, no program is
    captured: nothing to read."""
    rec = canned(STAGES)
    rec["device"] = []
    assert spec.reader("replay_share")(rec) is None
