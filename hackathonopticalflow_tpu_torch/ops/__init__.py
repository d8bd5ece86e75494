"""Frame preparation, grid templates, the window kernel, the rect gather
kernel, the LK level kernel, pyramidal LK, Shi-Tomasi corners, statistics,
color conversions, dense image primitives, the coefficient warp kernel and
Farneback (ports of hackathonopticalflow_tpu/ops/). The names below are
the JAX package's ops re-exports; importing them builds no kernel (each
builds at its first launch)."""

from .color import bgr2gray, bgr2hsv, gray2bgr, hsv2bgr, saturating_add
from .deriv import scharr_deriv, sobel_deriv
from .farneback import farneback
from .features import good_features_to_track, min_eig_map
from .image import (
    box_sum,
    gaussian_blur,
    gaussian_kernel1d,
    resize_area,
    resize_bilinear,
    sep_conv2d,
    threshold_binary,
)
from .lk import LKResult, pyr_lk
from .patch import extract_patches
from .pyramid import build_pyramid, pyr_down
from .stats import histogram256, median, percentile
from .warp import bilinear_sample, warp_image

__all__ = [
    "sep_conv2d",
    "gaussian_kernel1d",
    "gaussian_blur",
    "box_sum",
    "resize_bilinear",
    "resize_area",
    "threshold_binary",
    "bgr2gray",
    "gray2bgr",
    "bgr2hsv",
    "hsv2bgr",
    "saturating_add",
    "pyr_down",
    "build_pyramid",
    "scharr_deriv",
    "sobel_deriv",
    "extract_patches",
    "bilinear_sample",
    "warp_image",
    "median",
    "percentile",
    "histogram256",
    "pyr_lk",
    "LKResult",
    "farneback",
    "min_eig_map",
    "good_features_to_track",
]
