"""paint_us: mean host microseconds of one ``DepthSession.paint`` call (the
native brush and the dirty-rect merge), from the benchmark's own span
around each call in the traced updates."""


def read(rec):
    spans = rec.get("spans", {}).get("paint")
    return sum(spans) / len(spans) * 1e6 if spans else None
