"""Danger-point scoring (port of hackathonopticalflow_tpu/nav/danger.py).

The reference renders filtered points as red "lamps" whose brightness is
min(50 + 2*m, 255) (pathfinder_viewer.py:210-217, the math inside
`draw_sparse_lamps` minus the rendering); rasterization lives in
viz/layers.py.
"""

from __future__ import annotations

import torch


def danger_values(modulus: torch.Tensor) -> torch.Tensor:
    """Brightness of each danger lamp: min(50 + 2*m, 255)."""
    return torch.clamp(50.0 + modulus * 2.0, max=255.0)


def danger_image(
    pts: torch.Tensor,
    values: torch.Tensor,
    good: torch.Tensor,
    height: int,
    width: int,
) -> torch.Tensor:
    """(H, W) float32 map: each point's value where good (0 elsewhere),
    the largest where points share a pixel; points clipped into the
    frame."""
    x = torch.clamp(pts[:, 0], 0, width - 1).to(torch.int64)
    y = torch.clamp(pts[:, 1], 0, height - 1).to(torch.int64)
    vals = torch.where(good, values, torch.zeros_like(values)).to(torch.float32)
    img = torch.zeros(height * width, dtype=torch.float32, device=values.device)
    img = img.scatter_reduce(0, y * width + x, vals, reduce="amax", include_self=True)
    return img.reshape(height, width)
