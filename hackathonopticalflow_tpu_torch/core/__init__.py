from .config import (
    PROTO_FILTER,
    TRACKER_LK,
    FarnebackParams,
    FeatureParams,
    FilterParams,
    GridParams,
    LKParams,
    NormalizeParams,
    TrackerParams,
)
from .grid import measurement_grid

__all__ = [
    "LKParams", "NormalizeParams", "FilterParams", "FarnebackParams",
    "FeatureParams", "TrackerParams", "GridParams", "TRACKER_LK", "PROTO_FILTER",
    "measurement_grid",
]
