"""upload_ms: mean milliseconds of the session's "upload" stage per
update (``live/session.py:solve``; the program's ``StageTimer``, host clock
ending at a device sync), over the traced updates."""


def read(rec):
    total, count = rec.get("stages", {}).get("upload", (0.0, 0))
    return total / count * 1e3 if count else None
