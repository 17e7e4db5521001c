"""The numbers that decide `correct`, each beside its limit.

Frames: the 8-bit frames against the reference's, by their mean absolute
difference in levels.
"""

import numpy as np

def frame_numbers(prog: list, ref: list) -> dict:
    """prog, ref: uint8 frames [H, W, 3] in pairs -> {frame_mae}: the
    largest mean absolute difference of a pair, in levels."""
    return {"frame_mae": max(
        float(np.abs(p.astype(np.int16) - r.astype(np.int16)).mean())
        for p, r in zip(prog, ref))}


def with_limits(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every limit of the workload file; a
    number that was not measured, or is not finite, reads as not met."""
    out = {}
    for name, limit in limits.items():
        v = numbers.get(name)
        ok = v is not None and np.isfinite(v)
        out[name] = {"value": float(v) if ok else float("inf"),
                     "limit": float(limit)}
    return out
