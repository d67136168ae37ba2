"""polish_ms: device milliseconds per traced update of the V-cycle's polish
(``core/multigrid.py:vcycle_polish``), which runs inside the update's
replayed graph and so has no span of its own there.

In each update the polish lies between the warm cascade's last K1 launch
(``jc_sweep_tiles_kernel``, level 0 being the last level it solves) and the
defocus kernel K3 (``defocus_*_kernel``, or the table route's ``sat_*``
first). The reader adds the device time of every operation in that window,
K1 and K3 excluded, over the traced updates, and divides by the updates.
Besides the polish (its annotation pyramid, the levels' weights, the
cycles, the final clip of u) the window holds the solve's clip of the depth
for the effect. The record keeps each operation's length in the order the
profiler sorts its events, by start; the graph runs on one stream, so the
window's operations never overlap and their lengths add up to the union of
their intervals. Nothing to read where the solve is not a V-cycle, or where
no window closes (no K1 or no K3 in the trace)."""

import re

K1 = re.compile(r"^jc_sweep_tiles_kernel$")
K3 = re.compile(r"^(defocus_\w+_kernel|sat_\w+_kernel)$")


def read(rec):
    if rec["config"]["multigrid"] != "vcycle":
        return None
    total, windows, acc = 0.0, 0, None
    for name, _, seconds in rec.get("device", ()):
        if K1.match(name):
            acc = 0.0
        elif K3.match(name):
            if acc is not None:
                total += acc
                windows += 1
            acc = None
        elif acc is not None:
            acc += seconds
    return total / rec["updates"] * 1e3 if windows else None
