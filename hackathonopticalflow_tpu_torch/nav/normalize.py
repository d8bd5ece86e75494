"""Radial (focus-of-expansion) flow-magnitude normalization (port of
hackathonopticalflow_tpu/nav/normalize.py::radial_normalize)."""

from __future__ import annotations

import torch

from ..core import NormalizeParams


def radial_normalize(
    modulus: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    half_w: float,
    half_h: float,
    params: NormalizeParams = NormalizeParams(),
) -> torch.Tensor:
    """modulus / (offset + sqrt(dist_to_center)) * gain, elementwise."""
    dist_center = torch.sqrt((half_w - x) ** 2 + (half_h - y) ** 2)
    return modulus / (params.offset + torch.sqrt(dist_center)) * params.gain
