from .config import FarnebackParams, FilterParams, LKParams, NormalizeParams
from .grid import measurement_grid

__all__ = ["LKParams", "NormalizeParams", "FilterParams", "FarnebackParams", "measurement_grid"]
