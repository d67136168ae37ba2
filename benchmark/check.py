"""The comparison that decides ``correct``: what the timed path returned
against the configuration's reference (``reference/<config>.py`` where it
has one, else ``reference/plain.py``: ``spec.reference``), number by
number, each number held to its limit (``limits/<cell>.json``).

The numbers, each the worst over the updates or pairs compared:

- ``u8_rmse``: root mean square of the u8 depth map's difference, in gray
  levels;
- ``effect_rmse``: the same of the effect image, over its three channels;
- ``state_rmse``: the worst level's root mean square difference of the
  depth state the next update starts from, in depth units (0-255);
- ``scribble_err``: the largest gap between the u8 map and the scribbled
  value at a scribbled pixel (an exact comparison: limit 0);
- ``missing``: the pairs of a batch with no depth or no effect PNG (limit 0).
"""

from __future__ import annotations

import math
import sys

import numpy as np
import torch


def rmse(a, b) -> float:
    """Root mean square of a - b, in float64."""
    if isinstance(a, torch.Tensor):
        d = a.to(torch.float64) - b.to(device=a.device, dtype=torch.float64)
        return float(torch.sqrt(torch.mean(d * d)))
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return float(np.sqrt(np.mean(d * d)))


def compare(u8, effect, state, ref_u8, ref_effect, ref_state, mask, value) -> dict:
    """The numbers of one update (``state`` None for a batch's pair): the
    program's u8 map, effect image and depth state against the
    reference's; ``mask``/``value`` the scribbles the reference painted."""
    out = {
        "u8_rmse": rmse(u8, ref_u8),
        "effect_rmse": rmse(effect, ref_effect),
        "scribble_err": float(np.abs(u8[mask].astype(np.int32)
                                     - value[mask].astype(np.int32)).max(initial=0)),
    }
    if state is not None:
        out["state_rmse"] = max(rmse(a, b) for a, b in zip(state, ref_state))
    return out


def worst(rows) -> dict:
    """Each number's worst reading over ``rows`` (NaN wins)."""
    out = {}
    for row in rows:
        for k, v in row.items():
            if k not in out or not (v <= out[k]):
                out[k] = v
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, checks): every number within its limit, none NaN, and
    every limit read; ``checks`` maps each name to its value and limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, math.nan)
        checks[name] = {"value": v if math.isfinite(v) else None, "limit": limit}
        ok = ok and (v <= limit)
    return bool(ok), checks


def print_checks(checks: dict) -> None:
    """Each number beside its limit, as the last lines on stderr."""
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
