"""Applications on the port (ports of hackathonopticalflow_tpu/apps/)."""

from .dense_viewer import DenseViewerApp, DenseViewerConfig
from .pathfinder import PathfinderApp, PathfinderConfig
from .tracker_app import TrackerApp, TrackerAppConfig

__all__ = [
    "PathfinderApp",
    "PathfinderConfig",
    "DenseViewerApp",
    "DenseViewerConfig",
    "TrackerApp",
    "TrackerAppConfig",
]
