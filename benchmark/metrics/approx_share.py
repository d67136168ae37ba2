"""approx_share: per cent of the defocus renders over the traced updates
whose half-widths were snapped to the approximate blur's steps
(``ops/defocus.py``, K3's ``half_rule``): the port's counters
``defocus.approx`` over ``defocus.renders``, which the session keeps while
a profiler runs. Nothing to read where the counters are absent (a port
without them) or no render was counted."""


def read(rec):
    stages = rec.get("stages", {})
    renders = stages.get("defocus.renders", (0.0, 0))[1]
    approx = stages.get("defocus.approx", (0.0, 0))[1]
    return 100.0 * approx / renders if renders else None
