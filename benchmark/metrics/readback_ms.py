"""readback_ms: mean milliseconds of reading the effect image back to the
host (``session.artistic.cpu().numpy()``), from the benchmark's own span."""


def read(rec):
    spans = rec.get("spans", {}).get("readback")
    return sum(spans) / len(spans) * 1e3 if spans else None
