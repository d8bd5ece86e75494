"""Host-side drawing: rasterization primitives and the reference's layers
(the port's copies of hackathonopticalflow_tpu/viz/draw.py and layers.py)."""

from .draw import add_layers, circle, line, polylines, put_text, rectangle
from .layers import (
    draw_flow,
    draw_grid,
    draw_grid_vectors,
    draw_hsv,
    draw_sparse_hsv,
    draw_sparse_lamps,
    draw_tracks,
    mark_points,
)

__all__ = [
    "polylines", "circle", "rectangle", "line", "put_text", "add_layers",
    "draw_flow", "draw_grid", "draw_hsv", "draw_sparse_lamps", "draw_sparse_hsv",
    "draw_grid_vectors", "draw_tracks", "mark_points",
]
