"""Grid LK flow, dense Farneback flow and the trajectory tracker (ports of
hackathonopticalflow_tpu/flow/lk_grid.py, flow/dense.py and
flow/tracker.py). The names below are the JAX package's flow re-exports."""

from .dense import farneback_flow, farneback_flow_video
from .lk_grid import GridFlowResult, lk_grid_flow, lk_grid_flow_video
from .tracker import TrackerState, init_tracker, track_step

__all__ = [
    "lk_grid_flow",
    "lk_grid_flow_video",
    "GridFlowResult",
    "farneback_flow",
    "farneback_flow_video",
    "TrackerState",
    "init_tracker",
    "track_step",
]
