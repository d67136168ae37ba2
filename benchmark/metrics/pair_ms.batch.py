"""pair_ms.batch: the median over the traced call's pairs of the server's
own per-pair latency (``serve.solve_pairs``' ``stats_out``: from the
pair's dispatch to its completed readback), in milliseconds."""

import statistics


def read(rec):
    pairs = rec.get("pairs")
    return statistics.median(pairs) * 1e3 if pairs else None
