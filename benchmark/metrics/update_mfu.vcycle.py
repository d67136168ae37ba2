"""update_mfu.vcycle: per cent of the card's FP32 peak that a whole
V-cycle update reaches: the floating-point operations of the traced
updates' warm cascades (``work.cascade_levels`` at the warm budget,
``max_iterations * vcycle_warm_fraction`` and at least ``4 *
chebyshev_s``, 14 FLOPs a pixel and sweep), their polishes (from the port's
counter ``vcycle.px_sweeps``, ``benchmark/polish_work.py``) and their
defocus, over the traced window times the peak. It bounds the polish's and
the kernels' shares from above, whichever kernels run. Nothing to read
where the solve is not a fixed-count Jacobi-Chebyshev V-cycle re-run in
full every update, or where the polish's counter is absent (a port
without it)."""

from benchmark import polish_work, work


def read(rec):
    c = rec["config"]
    px_sweeps = rec.get("stages", {}).get("vcycle.px_sweeps", (0.0, 0))[1]
    if (c["multigrid"] != "vcycle" or c["solver"] != "jacobi_chebyshev" or c["early_exit"]
            or c["incremental_iterations"] != 0 or not px_sweeps or not rec.get("busy_s")):
        return None
    h, w = rec["rows"], rec["cols"]
    warm = max(int(c["max_iterations"] * c["vcycle_warm_fraction"]), 4 * c["chebyshev_s"])
    cascade = sum(work.JC_FLOPS_PER_PX * lh * lw * n for lh, lw, n in
                  work.cascade_levels(h, w, c["pyramid_base_size"], warm))
    flops = (rec["updates"] * (cascade + work.DEFOCUS_OPS_PER_PX * h * w)
             + polish_work.flops(px_sweeps))
    return 100.0 * flops / (rec["window_s"] * work.PEAK_FLOP_S)
