"""Scharr and Sobel derivatives (port of hackathonopticalflow_tpu/ops/deriv.py).

Both are separable 3-tap correlations with reflect-101 borders. Sobel's
taps are integers, so on integer images its passes are exact in float32
in either pass order."""

from __future__ import annotations

import torch

from .image import sep_conv2d

_SCHARR_SMOOTH = [3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0]
_DIFF = [-1.0, 0.0, 1.0]
_SOBEL_SMOOTH = [1.0, 2.0, 1.0]


def scharr_deriv(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dI/dx, dI/dy) with Scharr 3x3 taps, normalized by 1/32."""
    ix = sep_conv2d(img, _SCHARR_SMOOTH, _DIFF)
    iy = sep_conv2d(img, _DIFF, _SCHARR_SMOOTH)
    return ix, iy


def sobel_deriv(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Aperture-3 Sobel derivatives (unnormalized, like cv2.Sobel); the
    Shi-Tomasi detector's gradients (cornerMinEigenVal)."""
    ix = sep_conv2d(img, _SOBEL_SMOOTH, _DIFF)
    iy = sep_conv2d(img, _DIFF, _SOBEL_SMOOTH)
    return ix, iy
