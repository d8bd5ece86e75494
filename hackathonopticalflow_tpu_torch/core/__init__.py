from .config import FilterParams, LKParams, NormalizeParams
from .grid import measurement_grid

__all__ = ["LKParams", "NormalizeParams", "FilterParams", "measurement_grid"]
