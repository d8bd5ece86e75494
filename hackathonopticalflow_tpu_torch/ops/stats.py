"""Robust reduction statistics (port of
hackathonopticalflow_tpu/ops/stats.py::median, percentile, masked_median,
masked_percentile, histogram256 and kmeans).

np.median / np.percentile semantics, as the JAX functions document:
torch.median returns the LOWER middle value for an even count (the 1080p
grid has 2304 points), so the middle pair is averaged here. The four
statistics reduce over the last axis and keep any leading axes, as
`jax.vmap` of the JAX functions does: a stream-batched (B, N) input gives
one median per stream, never one pooled over the streams. The masked forms
keep static shapes (invalid entries sort last as +inf) and read nothing
back to the host: their ranks are tensors."""

from __future__ import annotations

import math

import torch


def _take(v: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """v[..., idx] for one index per row (idx has v's leading shape)."""
    return torch.gather(v, -1, idx[..., None])[..., 0]


def median(x: torch.Tensor) -> torch.Tensor:
    """np.median over the last axis: mean of the middle pair for an even
    count."""
    v = torch.sort(x, dim=-1).values
    n = v.shape[-1]
    return (v[..., (n - 1) // 2] + v[..., n // 2]) * 0.5


def percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile over the last axis, linear interpolation. The rank
    is computed on the host and the interpolation in float64, rounded once
    to x's dtype (XLA's float32 rounding of jnp.percentile may differ by
    a few ULPs)."""
    v = torch.sort(x, dim=-1).values
    n = v.shape[-1]
    pos = q / 100.0 * (n - 1)
    lo = min(max(math.floor(pos), 0), n - 1)
    hi = min(lo + 1, n - 1)
    a, b = v[..., lo].double(), v[..., hi].double()
    return (a + (b - a) * (pos - lo)).to(v.dtype)


def _masked_sorted(x: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(x with invalid entries +inf, sorted along the last axis; count of
    valid entries per row)."""
    vals = torch.sort(torch.where(mask, x, torch.full_like(x, math.inf)), dim=-1).values
    return vals, mask.sum(-1)


def masked_median(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median over the last axis of x where mask is True (inf where none
    is)."""
    vals, n = _masked_sorted(x, mask)
    last = x.shape[-1] - 1
    hi = torch.clamp(n // 2, 0, last)
    lo = torch.clamp(hi - (1 - n % 2), 0, last)
    return 0.5 * (_take(vals, lo) + _take(vals, hi))


def masked_percentile(x: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """np.percentile(x[mask], q) over the last axis with static shapes, the
    rank in float32 as JAX computes it (nan where no entry is valid)."""
    vals, n = _masked_sorted(x, mask)
    last = x.shape[-1] - 1
    pos = (n - 1).to(torch.float32) * (q / 100.0)
    lo = torch.clamp(torch.floor(pos).to(torch.int64), 0, last)
    hi = torch.clamp(lo + 1, 0, last)
    frac = pos - lo.to(torch.float32)
    take_hi = torch.where(hi < n, _take(vals, hi), _take(vals, torch.clamp(n - 1, 0, last)))
    return _take(vals, lo) * (1 - frac) + take_hi * frac


def histogram256(x: torch.Tensor) -> torch.Tensor:
    """cv2.calcHist parity for uint8 data: 256 int32 bins over [0, 256) of
    all of x (values truncated toward zero, then clipped)."""
    xi = torch.clamp(x.to(torch.int32), 0, 255).reshape(-1).to(torch.int64)
    return torch.bincount(xi, minlength=256).to(torch.int32)


def kmeans(
    samples: torch.Tensor,
    k: int,
    iters: int = 10,
    init_centers: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lloyd k-means over (N, D) samples (or (N,)) -> (compactness,
    labels, centers), JAX's stand-in for cv2.kmeans: `iters` rounds of
    assignment (one (N, K) distance matrix, the first nearest centre on a
    tie) and update (each centre the mean of its samples; an empty
    cluster keeps its centre). Deterministic: centres default to evenly
    spaced samples in the order of their first coordinate."""
    samples = samples.to(torch.float32)
    n = samples.shape[0]
    if samples.dim() == 1:
        samples = samples[:, None]
    if init_centers is None:
        order = torch.sort(samples[:, 0], stable=True).indices
        idx = torch.arange(k, device=samples.device) * (n // k) + (n // k) // 2
        centers = samples[order[idx]]
    else:
        centers = init_centers.to(device=samples.device, dtype=torch.float32)

    def assign(c):
        d2 = ((samples[:, None, :] - c[None]) ** 2).sum(-1)  # (N, K)
        d2_min, labels = torch.min(d2, dim=1)
        return labels, d2_min

    for _ in range(iters):
        labels, _ = assign(centers)
        onehot = (labels[:, None] == torch.arange(k, device=samples.device)[None]).to(torch.float32)
        counts = onehot.sum(0)[:, None]  # (K, 1)
        sums = onehot.T @ samples  # (K, D)
        centers = torch.where(counts > 0, sums / torch.clamp(counts, min=1.0), centers)
    labels, d2 = assign(centers)
    return d2.sum(), labels, centers
