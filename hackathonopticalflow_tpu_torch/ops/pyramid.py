"""Gaussian pyramids: cv2.pyrDown in float, or with OpenCV's u8 level
storage (port of hackathonopticalflow_tpu/ops/pyramid.py)."""

from __future__ import annotations

import torch

from .image import sep_conv2d

_PYR_K = [1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0]


def pyr_down(img: torch.Tensor, quantize_u8: bool = False) -> torch.Tensor:
    """cv2.pyrDown: 5-tap smoothing, every other pixel (ceil-halved size).
    quantize_u8 reproduces OpenCV's uint8 level storage, floor(x + 0.5)
    clipped to [0, 255]. Float dtype is kept."""
    out = sep_conv2d(img, _PYR_K, _PYR_K)[..., ::2, ::2]
    if quantize_u8:
        out = torch.clamp(torch.floor(out + 0.5), 0.0, 255.0)
    return out


def build_pyramid(img: torch.Tensor, max_level: int, quantize_u8: bool = False) -> list[torch.Tensor]:
    """Levels [0..max_level]; level 0 is the input image. quantize_u8=True
    matches buildOpticalFlowPyramid's uint8 levels (the LK path)."""
    levels = [img]
    for _ in range(max_level):
        levels.append(pyr_down(levels[-1], quantize_u8=quantize_u8))
    return levels
