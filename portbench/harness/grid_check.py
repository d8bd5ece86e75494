"""The check of the pathfinder's grid-flow answers: every pair's eight
GridFlowResult arrays against the reference's."""

from __future__ import annotations

import numpy as np
import torch

from .clip import pair_at

FIELDS = ("raw_next_pts", "flow", "next_pts", "pts", "modulus", "ang", "good", "status")
FLOATS = ("raw_next_pts", "modulus", "ang")


def host_arrays(res) -> list[np.ndarray]:
    """Copies of a result's eight arrays (the app's may be views of a
    buffer that the next chunk overwrites)."""
    return [np.array(getattr(res, f)) for f in FIELDS]


def compare(ctx, got: list, attempted: int, stream: int = 0) -> tuple[dict, int]:
    """Over the `attempted` pairs due, `got[k - 1]` holding pair k's
    arrays: bad_pairs, those missing or whose integer or boolean arrays
    (flow, next_pts, pts, good, status) differ from the reference's; and
    the largest gap of each float array (raw_next_pts in px, modulus, ang
    in radians, the shorter way round the circle: an angle at -pi and one
    at pi are the same direction). With `control`, the reference in bf16 stands in for the
    port."""
    s = ctx.streams[stream]
    ref = ctx.lk_pairs(stream)
    if ctx.control:
        ctl = ctx.lk_pairs(stream, torch.bfloat16)
        got = [ctl.host(*pair_at(k, s.n)) for k in range(1, len(got) + 1)]
    bad = abs(len(got) - attempted)
    gaps = dict.fromkeys(FLOATS, 0.0)
    for k in range(1, min(len(got), attempted) + 1):
        want = dict(zip(FIELDS, ref.host(*pair_at(k, s.n))))
        mine = dict(zip(FIELDS, got[k - 1]))
        if any(mine[f].shape != want[f].shape for f in FIELDS):
            bad += 1
            gaps = dict.fromkeys(FLOATS, float("inf"))
            continue
        if any(not np.array_equal(mine[f], want[f]) for f in FIELDS if f not in FLOATS):
            bad += 1
        for f in FLOATS:
            d = np.abs(mine[f].astype(np.float64) - want[f].astype(np.float64))
            if f == "ang":
                d = np.minimum(d, 2.0 * np.pi - d)
            gaps[f] = max(gaps[f], float(np.nan_to_num(d, nan=np.inf).max()))
    return {"bad_pairs": bad, "raw_next_pts_max_px": gaps["raw_next_pts"], "modulus_max": gaps["modulus"],
            "ang_max_rad": gaps["ang"]}, bad
