"""Accuracy metrics: endpoint error (EPE) and absolute trajectory error (ATE)
(port of hackathonopticalflow_tpu/nav/metrics.py; the ATE and the track
EPE are host numpy, as there)."""

from __future__ import annotations

import numpy as np
import torch


def _percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation percentile of all of x, as jnp.percentile: the
    fractional rank in float32, the two neighbours weighted by it."""
    v = torch.sort(x.reshape(-1)).values
    pos = torch.tensor(q, dtype=torch.float32) / 100.0 * (v.numel() - 1)
    lo, hi = int(torch.floor(pos)), int(torch.ceil(pos))
    w_hi = (pos - lo).to(v.device)
    return v[lo] * (1.0 - w_hi) + v[hi] * w_hi


def endpoint_error(flow: torch.Tensor, flow_ref: torch.Tensor) -> dict:
    """EPE statistics between two flow fields or point sets (..., 2)."""
    d = torch.sqrt(torch.sum((flow - flow_ref) ** 2, dim=-1))
    return {
        "mean": torch.mean(d),
        "p50": _percentile(d, 50),
        "p95": _percentile(d, 95),
        "max": torch.max(d),
    }


def ate_umeyama(traj: np.ndarray, traj_ref: np.ndarray, with_scale: bool = True) -> dict:
    """Absolute trajectory error after Umeyama alignment (similarity or
    rigid) of (N, 3) position sequences: the standard monocular-SLAM ATE."""
    x = np.asarray(traj, np.float64)
    y = np.asarray(traj_ref, np.float64)
    mu_x = x.mean(axis=0)
    mu_y = y.mean(axis=0)
    xc = x - mu_x
    yc = y - mu_y
    cov = yc.T @ xc / len(x)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_x = (xc**2).sum() / len(x)
        s = np.trace(np.diag(D) @ S) / var_x if var_x > 0 else 1.0
    else:
        s = 1.0
    t = mu_y - s * R @ mu_x
    aligned = (s * (R @ x.T)).T + t
    err = np.linalg.norm(aligned - y, axis=-1)
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "mean": float(err.mean()),
        "max": float(err.max()),
        "scale": float(s),
    }


def track_endpoint_error(
    traj_a: np.ndarray, len_a: np.ndarray, traj_b: np.ndarray, len_b: np.ndarray
) -> float:
    """Mean 2D distance between matched trajectory heads (tracker
    regression metric between two tracker states)."""
    heads_a = [traj_a[i, len_a[i] - 1] for i in range(len(len_a)) if len_a[i] > 0]
    heads_b = [traj_b[i, len_b[i] - 1] for i in range(len(len_b)) if len_b[i] > 0]
    if not heads_a or not heads_b:
        return float("nan")
    A = np.asarray(heads_a)
    B = np.asarray(heads_b)
    d = np.linalg.norm(A[:, None] - B[None, :], axis=-1)
    return float(d.min(axis=1).mean())
