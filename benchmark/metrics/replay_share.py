"""replay_share: per cent of the program layer's solves over the traced
updates that replayed a captured graph: the counts of the port's
``program.replay`` span over those of ``program.replay`` and
``program.eager`` (``utils/program.py:Program``, ``pipeline.py:_eager``).
Nothing to read where the trace holds no device operation: on the CPU no
program is captured, and each is its eager function."""


def read(rec):
    stages = rec.get("stages", {})
    replays = stages.get("program.replay", (0.0, 0))[1]
    eager = stages.get("program.eager", (0.0, 0))[1]
    if not rec.get("device") or not replays + eager:
        return None
    return 100.0 * replays / (replays + eager)
