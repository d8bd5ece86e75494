"""Robust reduction statistics (port of
hackathonopticalflow_tpu/ops/stats.py::median, percentile).

np.median / np.percentile semantics, as the JAX functions document:
torch.median returns the LOWER middle value for an even count (the 1080p
grid has 2304 points), so the middle pair is averaged here."""

from __future__ import annotations

import math

import torch


def median(x: torch.Tensor) -> torch.Tensor:
    """np.median of a 1-D tensor: mean of the middle pair for even N."""
    v = torch.sort(x.reshape(-1)).values
    n = v.numel()
    return (v[(n - 1) // 2] + v[n // 2]) * 0.5


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile of a 1-D tensor, linear interpolation. The rank is
    computed on the host and the interpolation in float64, rounded once
    to x's dtype (XLA's float32 rounding of jnp.percentile may differ by
    a few ULPs)."""
    v = torch.sort(x.reshape(-1)).values
    n = v.numel()
    pos = q / 100.0 * (n - 1)
    lo = min(max(math.floor(pos), 0), n - 1)
    hi = min(lo + 1, n - 1)
    a, b = v[lo].double(), v[hi].double()
    return (a + (b - a) * (pos - lo)).to(v.dtype)
