"""roofline.jc_fused: per cent of its roofline that the Jacobi-Chebyshev
kernel K6 (``csrc/fused_sweep.cu``, the levels whose weight planes outgrow
the L2 cache) reaches: the least time of the work the traced updates sent
down that route (``work.py``, from the port's counters
``sweep.fused_px_sweeps`` and ``sweep.fused_px``, which the session keeps
while a profiler runs) over K6's device time in the trace. The work is the
algorithm's, 14 FLOPs a pixel and sweep and 21 bytes a pixel per call,
whichever kernel does it. Nothing to read where the counters are absent or
zero (a port without them, a solve that routes no level there), or where
K6 did not run."""

from benchmark import trace, work


def read(rec):
    stages = rec.get("stages", {})
    px = stages.get("sweep.fused_px", (0.0, 0))[1]
    px_sweeps = stages.get("sweep.fused_px_sweeps", (0.0, 0))[1]
    t = trace.device_seconds(rec, r"^jc_sweep_fused_kernel$")
    if not px or not px_sweeps or t <= 0:
        return None
    least = work.least_s(work.JC_FLOPS_PER_PX * px_sweeps, work.JC_BYTES_PER_PX * px)
    return 100.0 * least / t
