"""Radial (focus-of-expansion) flow-magnitude normalization (port of
hackathonopticalflow_tpu/nav/normalize.py)."""

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
    """modulus / (offset + sqrt(dist_to_center)) * gain, elementwise; a
    stream-batched (B, N) modulus broadcasts against the shared (N,)
    point coordinates."""
    dist_center = torch.sqrt((half_w - x) ** 2 + (half_h - y) ** 2)
    return modulus / (params.offset + torch.sqrt(dist_center)) * params.gain


def radial_normalize_dense(flow: torch.Tensor, params: NormalizeParams = NormalizeParams()) -> torch.Tensor:
    """Dense variant over a (..., H, W, 2) flow field: the normalized
    magnitude (..., H, W)."""
    h, w = flow.shape[-3:-1]
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)
    m = torch.sqrt(flow[..., 0] ** 2 + flow[..., 1] ** 2)
    return radial_normalize(m, xs, ys, int(w / 2), int(h / 2), params)
