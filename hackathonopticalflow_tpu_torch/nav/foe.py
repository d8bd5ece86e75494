"""Focus-of-expansion estimation (port of hackathonopticalflow_tpu/nav/foe.py).

Under pure forward translation flow vectors radiate from the FOE e, so each
flow vector (p, f) constrains e to the line through p with direction f.
Least squares over all vectors,

    minimize sum_i w_i * || (e - p_i) x f_i / |f_i| ||^2,

is a 2x2 linear solve.
"""

from __future__ import annotations

import torch


def estimate_foe(
    pts: torch.Tensor,
    flow: torch.Tensor,
    weights: torch.Tensor | None = None,
    eps: float = 1e-6,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Least-squares FOE from sparse flow.

    pts: (N, 2) point positions; flow: (N, 2) flow vectors; weights:
    optional (N,) confidence (e.g. the robust-filter mask). Returns (foe_xy
    (2,), mean squared line distance residual ())."""
    f = flow.to(torch.float32)
    p = pts.to(torch.float32)
    mag = torch.sqrt(torch.sum(f * f, dim=-1, keepdim=True))
    d = f / torch.clamp(mag, min=eps)
    n = torch.stack([-d[:, 1], d[:, 0]], dim=-1)  # normal to the flow
    w = torch.ones(p.shape[0], dtype=torch.float32, device=p.device) if weights is None else weights.to(torch.float32)
    w = w * (mag[:, 0] > eps)
    # sum_i w_i (n_i n_i^T) e = sum_i w_i n_i (n_i . p_i)
    nnT = torch.einsum("n,ni,nj->ij", w, n, n)
    rhs = torch.einsum("n,ni,n->i", w, n, torch.sum(n * p, dim=-1))
    a = nnT + eps * torch.eye(2, dtype=torch.float32, device=p.device)
    e = torch.linalg.solve_ex(a, rhs, check_errors=False).result
    resid = torch.sum(n * (e[None, :] - p), dim=-1)
    mean_sq = torch.sum(w * resid * resid) / torch.clamp(torch.sum(w), min=1.0)
    return e, mean_sq
