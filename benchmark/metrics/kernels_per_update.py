"""kernels_per_update: device kernel launches per update in the traced
window (a replayed graph's kernel nodes count one each); memcpy and memset
are not counted."""


def read(rec):
    n = sum(1 for _, kind, _ in rec.get("device", ()) if kind == "kernel")
    return n / rec["updates"] if n else None
