"""roofline.jc_sweep: per cent of their roofline that the Jacobi-Chebyshev
sweep kernels K1 and K2 (``csrc/sweep.cu``) reach: the least time of the
traced updates' fixed-count cascades (``work.py``, from the levels' shapes
and sweeps) over K1's and K2's device time in the trace. Nothing to read
where the solve is not a fixed-count Jacobi-Chebyshev cascade re-run in
full every update, or where neither kernel ran."""

from benchmark import trace, work


def read(rec):
    c = rec["config"]
    if (c["solver"] != "jacobi_chebyshev" or c["early_exit"] or c["multigrid"] != "cascadic"
            or c["incremental_iterations"] != 0):
        return None
    t = trace.device_seconds(rec, r"^jc_sweep_(tiles|resident)_kernel$")
    if t <= 0:
        return None
    least = work.jc_cascade_s(rec["rows"], rec["cols"], c["pyramid_base_size"],
                              c["max_iterations"])
    return 100.0 * rec["updates"] * least / t
