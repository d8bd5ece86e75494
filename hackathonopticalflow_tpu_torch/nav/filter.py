"""Robust statistical filtering of normalized flow magnitudes (port of
hackathonopticalflow_tpu/nav/filter.py::robust_mask)."""

from __future__ import annotations

import torch

from ..core import FilterParams
from ..ops.stats import median, percentile


def robust_mask(
    modulus: torch.Tensor, params: FilterParams = FilterParams()
) -> torch.Tensor:
    """Keep median*median_factor < m (< P(upper_percentile) when set)."""
    lo = median(modulus) * params.median_factor
    mask = modulus > lo
    if params.upper_percentile is not None:
        mask = mask & (modulus < percentile(modulus, params.upper_percentile))
    return mask
