"""live_chunk_share: per cent of the early exit's chunks issued over the
traced updates whose probe ran before the exit
(``core/solver.py:_chunked_early_exit``): the port's counters
``exit.chunks_live`` over ``exit.chunks_issued``, which the session keeps
while a profiler runs. Every chunk of a level's cap is issued on a card;
the rest are dead chunks, launches that leave the state as it is."""


def read(rec):
    stages = rec.get("stages", {})
    issued = stages.get("exit.chunks_issued", (0.0, 0))[1]
    live = stages.get("exit.chunks_live", (0.0, 0))[1]
    return 100.0 * live / issued if issued else None
