"""roofline.rb_sweep: per cent of their roofline that the red-black SOR
kernels K4 and K5 (``csrc/rb_sweep.cu``) reach: the least time of the
work the traced updates' early exits ran over K4's and K5's device time
in the trace. The work is the port's counters, which the session keeps
while a profiler runs: ``exit.px_iters_run`` (each level's or window's
pixels times the iterations run before the exit) and ``exit.px`` (its
pixels, once per level call). Chunks issued after the exit do no work, so
their launches count as time without work. Nothing to read where the
record has no such counters or neither kernel ran."""

from benchmark import trace, work

# One red-black SOR update of a pixel: the weighted sum of four neighbours
# (4 multiplies, 3 adds), times the reciprocal weight (1), and the
# over-relaxed step u + omega * (r - u) (1 multiply, 2 adds): 11 FLOPs.
RB_FLOPS_PER_PX = 11
# Per level call: u in, the horizontal and vertical pair weights and the
# reciprocal sum in (float32 each), the scribble mask in (1 byte), u out.
RB_BYTES_PER_PX = 4 + 4 + 4 + 4 + 1 + 4


def read(rec):
    stages = rec.get("stages", {})
    px = stages.get("exit.px", (0.0, 0))[1]
    if not px:
        return None
    t = trace.device_seconds(rec, r"^rb_sweep_(tiles|resident)_kernel$")
    if t <= 0:
        return None
    px_iters = stages.get("exit.px_iters_run", (0.0, 0))[1]
    return 100.0 * work.least_s(RB_FLOPS_PER_PX * px_iters, RB_BYTES_PER_PX * px) / t
