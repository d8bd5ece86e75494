"""Robust statistical filtering of normalized flow magnitudes (port of
hackathonopticalflow_tpu/nav/filter.py::robust_mask, robust_mask_masked).

The statistics are taken over the last axis: a stream-batched (B, N)
input gets one median and one percentile per stream, as `jax.vmap` of the
JAX functions gives."""

from __future__ import annotations

import torch

from ..core import FilterParams
from ..ops.stats import masked_median, masked_percentile, median, percentile


def robust_mask(
    modulus: torch.Tensor, params: FilterParams = FilterParams()
) -> torch.Tensor:
    """Keep median*median_factor < m (< P(upper_percentile) when set), the
    statistics per row of the last axis."""
    lo = median(modulus)[..., None] * params.median_factor
    mask = modulus > lo
    if params.upper_percentile is not None:
        mask = mask & (modulus < percentile(modulus, params.upper_percentile)[..., None])
    return mask


def robust_mask_masked(
    modulus: torch.Tensor, valid: torch.Tensor, params: FilterParams = FilterParams()
) -> torch.Tensor:
    """robust_mask whose statistics ignore invalid entries (fixed-capacity
    point tables); invalid entries are never kept."""
    lo = masked_median(modulus, valid)[..., None] * params.median_factor
    mask = valid & (modulus > lo)
    if params.upper_percentile is not None:
        mask = mask & (modulus < masked_percentile(modulus, valid, params.upper_percentile)[..., None])
    return mask
