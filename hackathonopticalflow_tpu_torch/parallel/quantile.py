"""Distributed robust statistics (port of
hackathonopticalflow_tpu/parallel/quantile.py).

The reference's vector filter takes a full-frame median / 99th percentile
(pathfinder_viewer.py:173). Under spatial tiling those become reductions
across ranks (SURVEY.md §5.8). Two strategies:

- exact: all_gather the per-tile values (the step-30 grid at 1080p is only
  ~2.3k floats) and reduce locally with ops/stats.py (np.median's
  even-count rule; np.percentile's interpolation in float64);
- histogram: psum a fixed-width histogram and invert its CDF, O(bins)
  communication whatever the element count, for dense per-pixel
  statistics.

Each is called by every rank of the axis with its own values and returns
the statistic on every rank.
"""

from __future__ import annotations

import torch

from ..ops.stats import median, percentile
from .collectives import all_gather, psum
from .mesh import Mesh


def distributed_median(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Exact np.median over the values of every rank of `axis`."""
    return median(all_gather(x.reshape(-1), mesh.axis(axis)))


def distributed_percentile(x: torch.Tensor, q: float, mesh: Mesh, axis: str) -> torch.Tensor:
    """Exact np.percentile (linear interpolation) over the values of every
    rank of `axis`."""
    return percentile(all_gather(x.reshape(-1), mesh.axis(axis)), q)


def psum_histogram_quantile(
    x: torch.Tensor,
    q: float,
    mesh: Mesh,
    axis: str,
    lo: float,
    hi: float,
    bins: int = 4096,
) -> torch.Tensor:
    """Approximate quantile from a psum-reduced histogram over [lo, hi]:
    the centre of the first bin whose cumulative count reaches q% of the
    total. Error bounded by the bin width (hi - lo) / bins."""
    xc = torch.clamp(x.reshape(-1).to(torch.float32), lo, hi)
    idx = torch.clamp(((xc - lo) / (hi - lo) * bins).to(torch.int32), 0, bins - 1)
    hist = torch.zeros(bins, dtype=torch.int32, device=x.device)
    hist.scatter_add_(0, idx.to(torch.int64), torch.ones_like(idx))
    cdf = torch.cumsum(psum(hist, mesh.axis(axis)), 0, dtype=torch.int32)
    target = q / 100.0 * cdf[-1].to(torch.float32)
    bin_idx = torch.clamp(torch.searchsorted(cdf.to(torch.float32), target[None]), 0, bins - 1)[0]
    return lo + (bin_idx.to(torch.float32) + 0.5) * (hi - lo) / bins
