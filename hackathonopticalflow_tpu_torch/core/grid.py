"""Measurement grid (port of hackathonopticalflow_tpu/core/grid.py).

The reference's centred grid (pathfinder_viewer.py:255-267): when the cell
count along an axis is even, the indent grows by half a step so the grid
stays centred; coordinates are truncated to ints, then cast to float32.
"""

from __future__ import annotations

import numpy as np


def measurement_grid(height: int, width: int, step: int = 30) -> np.ndarray:
    """(N, 2) float32 [x, y] points in x-major order: every y of the first
    x, then the next x."""
    if width // step % 2 == 1:
        indent_w = width % step / 2
    else:
        indent_w = (width % step + step) / 2
    if height // step % 2 == 1:
        indent_h = height % step / 2
    else:
        indent_h = (height % step + step) / 2
    xs = np.arange(indent_w, width, step).astype(int)
    ys = np.arange(indent_h, height, step).astype(int)
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    return np.stack([xx.ravel(), yy.ravel()], axis=-1).astype(np.float32)


def grid_shape(height: int, width: int, step: int = 30) -> tuple[int, int]:
    """(n_x, n_y) cell counts of the measurement grid."""
    pts = measurement_grid(height, width, step)
    return len(np.unique(pts[:, 0])), len(np.unique(pts[:, 1]))
