"""roofline.defocus: per cent of its roofline that the defocus kernel K3
(``csrc/defocus.cu``, every route) reaches: the least time of one defocus
of the image per update (``work.py``) over K3's device time in the trace."""

from benchmark import trace, work


def read(rec):
    t = trace.device_seconds(rec, r"^(defocus_\w+_kernel|sat_\w+_kernel)$")
    if t <= 0:
        return None
    return 100.0 * rec["updates"] * work.defocus_s(rec["rows"], rec["cols"]) / t
