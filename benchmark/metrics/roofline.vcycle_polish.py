"""roofline.vcycle_polish: per cent of its roofline that the V-cycle's
polish (``core/multigrid.py:vcycle_polish``, plain torch ops replayed from
the update's graph) reaches: the least time of its counted work
(``benchmark/polish_work.py``, from the port's counters
``vcycle.px_sweeps``, ``vcycle.px`` and ``vcycle.cycles``, which the session
keeps while a profiler runs, and the coarsest level's shape) over its device
time (``polish_ms`` times the traced
updates). Nothing to read where the counters are absent or zero (a port
without them, a solve that is not a V-cycle) or ``polish_ms`` reads
nothing."""

from benchmark import polish_work, spec, work

polish_ms = spec.reader("polish_ms")


def read(rec):
    stages = rec.get("stages", {})
    px_sweeps = stages.get("vcycle.px_sweeps", (0.0, 0))[1]
    px = stages.get("vcycle.px", (0.0, 0))[1]
    cycles = stages.get("vcycle.cycles", (0.0, 0))[1]
    ms = polish_ms(rec)
    if not px_sweeps or not px or not cycles or not ms:
        return None
    h, w, _ = work.cascade_levels(rec["rows"], rec["cols"],
                                  rec["config"]["pyramid_base_size"], 1)[-1]
    least = polish_work.least_s(px_sweeps, px, cycles * h * w)
    return 100.0 * least / (ms * 1e-3 * rec["updates"])
