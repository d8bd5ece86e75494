"""Scharr derivatives (port of hackathonopticalflow_tpu/ops/deriv.py)."""

from __future__ import annotations

import torch

from .image import sep_conv2d

_SCHARR_SMOOTH = [3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0]
_DIFF = [-1.0, 0.0, 1.0]


def scharr_deriv(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(dI/dx, dI/dy) with Scharr 3x3 taps, normalized by 1/32."""
    ix = sep_conv2d(img, _SCHARR_SMOOTH, _DIFF)
    iy = sep_conv2d(img, _DIFF, _SCHARR_SMOOTH)
    return ix, iy
