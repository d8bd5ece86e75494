"""Radial normalization, the robust masks, danger values, FOE, the camera,
relative pose and bundle adjustment (ports of hackathonopticalflow_tpu/nav/;
the odometry glue is nav/odometry.py, the metrics nav/metrics.py)."""

from .ba import BAState, BAStats, bundle_adjust, rodrigues, so3_log
from .camera import Pinhole
from .danger import danger_image, danger_values
from .filter import robust_mask, robust_mask_masked
from .foe import estimate_foe
from .normalize import radial_normalize, radial_normalize_dense
from .pose import RelativePose, estimate_relative_pose

__all__ = [
    "radial_normalize",
    "radial_normalize_dense",
    "robust_mask",
    "robust_mask_masked",
    "danger_values",
    "danger_image",
    "estimate_foe",
    "Pinhole",
    "estimate_relative_pose",
    "RelativePose",
    "BAState",
    "BAStats",
    "bundle_adjust",
    "rodrigues",
    "so3_log",
]
