from .config import (
    TRACKER_LK,
    FarnebackParams,
    FeatureParams,
    FilterParams,
    LKParams,
    NormalizeParams,
    TrackerParams,
)
from .grid import measurement_grid

__all__ = [
    "LKParams", "NormalizeParams", "FilterParams", "FarnebackParams",
    "FeatureParams", "TrackerParams", "TRACKER_LK", "measurement_grid",
]
