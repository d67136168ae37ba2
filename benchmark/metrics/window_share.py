"""window_share: per cent of the traced updates that took the windowed
re-solve (``core/incremental.py``, behind the session's gate in
``live/session.py:solve``): the count of the port's
``session.window_solve`` span over the updates. 0 where the session's
solves went through the program layer and none took the windowed path;
nothing to read where the record holds no program layer span
(``program.call``), as from a port that records no spans."""


def read(rec):
    stages = rec.get("stages", {})
    if not stages.get("program.call", (0.0, 0))[1]:
        return None
    return 100.0 * stages.get("session.window_solve", (0.0, 0))[1] / rec["updates"]
