"""The port's counterpart of the repository's __graft_entry__.py::entry: one
single-device step of the flagship pipeline (grid LK flow -> radial
normalize -> robust filter -> danger values and FOE, beside the dense
Farneback field) with example arguments at 720p.

The multi-device dry run (__graft_entry__.py::dryrun_multichip) waits for
the multi-device layer (ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from .core import FarnebackParams, measurement_grid
from .flow.dense import farneback_flow
from .flow.device import resolve_device
from .flow.lk_grid import lk_grid_flow
from .nav.danger import danger_values
from .nav.foe import estimate_foe


def entry(device: torch.device | str = "cuda", h: int = 720, w: int = 1280):
    """(step, example_args): step(prev_gray, gray) on (h, w) float32 frames
    in [0, 255] returns a dict of the grid flow (JAX's default LKParams(),
    the exact path), its `good` mask, the danger values, the FOE and its
    residual, and the dense flow at FarnebackParams(); example_args are two
    seeded uniform-noise frames on `device` (the GPU unless "cpu")."""
    dev = resolve_device(device)
    pts = torch.from_numpy(measurement_grid(h, w, 30)).to(dev)

    def step(prev_gray: torch.Tensor, gray: torch.Tensor) -> dict:
        res = lk_grid_flow(prev_gray, gray, pts, device=dev)
        danger = danger_values(res.modulus)
        foe, foe_resid = estimate_foe(res.pts.to(torch.float32), res.flow.to(torch.float32), res.good)
        dense = farneback_flow(prev_gray, gray, FarnebackParams(), device=dev)
        return {
            "flow": res.flow,
            "good": res.good,
            "danger": danger,
            "foe": foe,
            "foe_resid": foe_resid,
            "dense_flow": dense,
        }

    rng = np.random.RandomState(0)
    prev = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(dev)
    cur = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(dev)
    return step, (prev, cur)
