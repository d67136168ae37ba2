"""program_host_ms: mean milliseconds per update of the host in the
program layer (``pipeline.py:_route`` and ``_route_incremental``, and
``utils/program.py:Program``): the port's ``program.call`` span, from a
route's decision to its return (the signature check, the copies in, the
graph's launch, the copies out, or an eager run's launches), as the
session's ``StageTimer`` keeps it over the traced updates."""


def read(rec):
    total, count = rec.get("stages", {}).get("program.call", (0.0, 0))
    return total / rec["updates"] * 1e3 if count else None
