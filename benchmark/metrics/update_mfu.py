"""update_mfu: per cent of the card's FP32 peak that a whole update
reaches: the floating-point operations of the traced updates' fixed-count
cascades and defocus (``work.py``) over the traced window times the peak.
It bounds the kernels' rooflines from above, whichever kernels run. Nothing
to read where the solve's work depends on the data (an early exit, the
windowed re-solve)."""

from benchmark import work


def read(rec):
    c = rec["config"]
    if (c["solver"] != "jacobi_chebyshev" or c["early_exit"] or c["multigrid"] != "cascadic"
            or c["incremental_iterations"] != 0 or not rec.get("busy_s")):
        return None
    h, w = rec["rows"], rec["cols"]
    flops = sum(work.JC_FLOPS_PER_PX * lh * lw * n for lh, lw, n in
                work.cascade_levels(h, w, c["pyramid_base_size"], c["max_iterations"]))
    flops += work.DEFOCUS_OPS_PER_PX * h * w
    return 100.0 * rec["updates"] * flops / (rec["window_s"] * work.PEAK_FLOP_S)
