"""device_ms: milliseconds per update in which the device ran anything
(the union of its kernel, memcpy and memset intervals), over the traced
window."""


def read(rec):
    return rec["busy_s"] / rec["updates"] * 1e3 if rec.get("busy_s") else None
