"""Host-side drawing: rasterization primitives, the reference's layers and
the metrics plotter (the port's copies of hackathonopticalflow_tpu/viz/
draw.py, layers.py and plotter.py)."""

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
from .plotter import Plotter, draw_plot

__all__ = [
    "polylines", "circle", "rectangle", "line", "put_text", "add_layers",
    "draw_flow", "draw_grid", "draw_hsv", "draw_sparse_lamps", "draw_sparse_hsv",
    "draw_grid_vectors", "draw_tracks", "mark_points", "Plotter", "draw_plot",
]
