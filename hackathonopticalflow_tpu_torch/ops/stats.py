"""Robust reduction statistics (port of
hackathonopticalflow_tpu/ops/stats.py::median, percentile, masked_median
and masked_percentile).

np.median / np.percentile semantics, as the JAX functions document:
torch.median returns the LOWER middle value for an even count (the 1080p
grid has 2304 points), so the middle pair is averaged here. The masked
forms keep static shapes (invalid entries sort last as +inf) and read
nothing back to the host: their ranks are tensors."""

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


def _masked_sorted(x: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x with invalid entries +inf, sorted; count of valid entries)."""
    vals = torch.sort(torch.where(mask, x, torch.full_like(x, math.inf))).values
    return vals, mask.sum()


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of the 1-D x where mask is True (inf where none is)."""
    vals, n = _masked_sorted(x, mask)
    last = x.shape[0] - 1
    hi = torch.clamp(n // 2, 0, last)
    lo = torch.clamp(hi - (1 - n % 2), 0, last)
    return 0.5 * (vals[lo] + vals[hi])


def masked_percentile(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile(x[mask], q) with static shapes, the rank in float32
    as JAX computes it (nan where no entry is valid)."""
    vals, n = _masked_sorted(x, mask)
    last = x.shape[0] - 1
    pos = (n - 1).to(torch.float32) * (q / 100.0)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, last)
    hi = torch.clamp(lo + 1, 0, last)
    frac = pos - lo.to(torch.float32)
    take_hi = torch.where(hi < n, vals[hi], vals[torch.clamp(n - 1, 0, last)])
    return vals[lo] * (1 - frac) + take_hi * frac
