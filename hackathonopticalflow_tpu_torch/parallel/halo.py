"""Halo exchange over a mesh axis (port of
hackathonopticalflow_tpu/parallel/halo.py).

The building block for spatially tiled dense flow: each rank owns a
contiguous row block of the frame and needs `halo` rows from each
neighbour to evaluate windowed operators near its block edges (SURVEY.md
§5.7a). Two paired ppermute shifts, nearest neighbours only, no
all-gather.
"""

from __future__ import annotations

import torch

from .collectives import axis_index, axis_size, ppermute
from .mesh import Mesh

MODES = ("edge", "reflect", "constant")


def halo_exchange_rows(x: torch.Tensor, halo: int, mesh: Mesh, axis: str = "tile", mode: str = "edge") -> torch.Tensor:
    """Extend this rank's row block x (H_tile, ...) with `halo` rows from
    each neighbour along `axis`: (H_tile + 2 halo, ...).

    The first and last tiles pad their outer side with `mode`: "edge"
    replicates the outer row (the conv border the single-device kernels
    use at true frame borders), "reflect" mirrors without repeating it,
    "constant" pads zeros."""
    if mode not in MODES:
        raise ValueError(f"unknown halo mode {mode!r}; one of {MODES}")
    if halo < 1 or halo + (mode == "reflect") > x.shape[0]:
        raise ValueError(f"halo {halo} ({mode}) must be at least 1 and fit the tile's {x.shape[0]} rows")
    ax = mesh.axis(axis)
    n, idx = axis_size(ax), axis_index(ax)
    # the previous tile's bottom rows become our top halo, the next
    # tile's top rows our bottom halo
    from_prev = ppermute(x[-halo:], [(i, (i + 1) % n) for i in range(n)], ax)
    from_next = ppermute(x[:halo], [(i, (i - 1) % n) for i in range(n)], ax)
    if idx == 0:
        if mode == "edge":
            from_prev = x[:1].expand(halo, *x.shape[1:])
        elif mode == "reflect":
            from_prev = x[1 : halo + 1].flip(0)
        else:
            from_prev = torch.zeros_like(from_prev)
    if idx == n - 1:
        if mode == "edge":
            from_next = x[-1:].expand(halo, *x.shape[1:])
        elif mode == "reflect":
            from_next = x[-halo - 1 : -1].flip(0)
        else:
            from_next = torch.zeros_like(from_next)
    return torch.cat([from_prev, x, from_next], dim=0)
