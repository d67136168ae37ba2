"""solve_wait_ms: mean milliseconds per update that the session waits for
its u8 depth map (``live/session.py:solve``, the port's
``session.u8_readback`` span: the solve's remaining device work and the
map's copy to the host), over the traced updates."""


def read(rec):
    total, count = rec.get("stages", {}).get("session.u8_readback", (0.0, 0))
    return total / rec["updates"] * 1e3 if count else None
