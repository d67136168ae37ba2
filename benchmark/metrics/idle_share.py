"""idle_share: per cent of the traced window of a live session in which
the device ran nothing: 100 * (1 - busy / window)."""


def read(rec):
    if not rec.get("busy_s"):
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
