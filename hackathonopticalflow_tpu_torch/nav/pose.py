"""Frame-to-frame relative pose from tracked correspondences (port of
hackathonopticalflow_tpu/nav/pose.py).

A weighted 8-point essential-matrix estimate inside a fixed-round RANSAC
scored by Sampson error, then the cheirality choice among the four (R, t)
decompositions. Every function takes leading batch dimensions where the
JAX package vmaps: points (..., N, 2), so the keyframe pairs of all the
windows of a clip solve as one batch.

RANSAC samples: JAX draws jax.random.categorical(PRNGKey(seed), logits,
(rounds, 8)), which is argmax(gumbel(PRNGKey(seed), (rounds, 8, N)) +
logits, -1). The port takes the same argmax over Gumbel noise from
`_gumbel`, a torch.Generator seeded with `seed`; the tests replace
`_gumbel` with JAX's draws, so both packages fit the same samples. One
draw serves every pair of a batch, as one key serves every vmapped pair in
JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RelativePose(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3) unit norm (monocular scale gauge)
    E: torch.Tensor  # (..., 3, 3) essential matrix
    inliers: torch.Tensor  # (..., N) bool
    n_inliers: torch.Tensor  # (...) int64


def _gumbel(seed: int, shape: tuple[int, ...], device) -> torch.Tensor:
    """Standard Gumbel noise, -log(-log(U)) in float32, from a generator
    seeded with `seed`: the same draw on every call."""
    g = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(shape, generator=g, dtype=torch.float32, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _homogeneous(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _eight_point(p0: torch.Tensor, p1: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Weighted 8-point essential estimate from normalized coords: p0, p1
    (..., N, 2), w (..., N) -> (..., 3, 3)."""
    x0, y0 = p0[..., 0], p0[..., 1]
    x1, y1 = p1[..., 0], p1[..., 1]
    ones = torch.ones_like(x0)
    # p1^T E p0 = 0: the rows of A are kron(p1, p0)
    A = torch.stack([x1 * x0, x1 * y0, x1, y1 * x0, y1 * y0, y1, x0, y0, ones], dim=-1)
    A = A * w[..., None]
    vt = torch.linalg.svd(A, full_matrices=False).Vh
    e = vt[..., -1, :].reshape(*vt.shape[:-2], 3, 3)
    # enforce the essential-matrix spectrum (1, 1, 0)
    u, _, vt2 = torch.linalg.svd(e)
    return (u * torch.tensor([1.0, 1.0, 0.0], dtype=e.dtype, device=e.device)) @ vt2


def _sampson(E: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """Sampson distance (..., N) of normalized correspondences under E
    (..., 3, 3)."""
    h0 = _homogeneous(p0)
    h1 = _homogeneous(p1)
    Ex0 = h0 @ E.transpose(-1, -2)  # E p0
    Etx1 = h1 @ E  # E^T p1
    num = torch.sum(h1 * Ex0, dim=-1) ** 2
    den = Ex0[..., 0] ** 2 + Ex0[..., 1] ** 2 + Etx1[..., 0] ** 2 + Etx1[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def _triangulate_depths(
    R: torch.Tensor, t: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-view depths solving z1 x1 = z0 R x0 + t per point in least
    squares. R (..., 3, 3), t (..., 3), points (..., N, 2) -> (z0, z1)."""
    h0 = _homogeneous(p0)
    h1 = _homogeneous(p1)
    Rx0 = h0 @ R.transpose(-1, -2)
    # least squares in (z0, z1): || z0 Rx0 - z1 h1 + t ||^2
    a = torch.sum(Rx0 * Rx0, dim=-1)
    b = -torch.sum(Rx0 * h1, dim=-1)
    c = torch.sum(h1 * h1, dim=-1)
    d = -torch.sum(Rx0 * t[..., None, :], dim=-1)
    e = torch.sum(h1 * t[..., None, :], dim=-1)
    det = torch.clamp(a * c - b * b, min=1e-12)
    return (c * d - b * e) / det, (a * e - b * d) / det


def decompose_essential(
    E: torch.Tensor, p0: torch.Tensor, p1: torch.Tensor, w: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The (R, t) of the four decompositions with the largest cheirality
    support (weighted count of positive depths in both views)."""
    u, _, vt = torch.linalg.svd(E)
    # keep proper rotations
    u = u * torch.sign(torch.linalg.det(u))[..., None, None]
    vt = vt * torch.sign(torch.linalg.det(vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype, device=E.device)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    tt = u[..., :, 2]
    cands_R = torch.stack([R1, R1, R2, R2], dim=-3)  # (..., 4, 3, 3)
    cands_t = torch.stack([tt, -tt, tt, -tt], dim=-2)  # (..., 4, 3)
    z0, z1 = _triangulate_depths(cands_R, cands_t, p0[..., None, :, :], p1[..., None, :, :])
    scores = torch.sum(w[..., None, :] * ((z0 > 0) & (z1 > 0)), dim=-1)  # (..., 4)
    best = torch.argmax(scores, dim=-1)
    pick_R = torch.gather(cands_R, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3))[..., 0, :, :]
    pick_t = torch.gather(cands_t, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    return pick_R, pick_t


def estimate_relative_pose(
    p0: torch.Tensor,
    p1: torch.Tensor,
    valid: torch.Tensor | None = None,
    ransac_rounds: int = 16,
    sample_size: int = 8,
    inlier_thresh: float = 1e-5,
    seed: int = 0,
) -> RelativePose:
    """Relative pose from normalized correspondences p0 -> p1 (..., N, 2).

    Fixed-round RANSAC: each round fits an 8-point model on a sample of the
    valid points and scores it by Sampson error; the best model's inliers
    feed a final weighted refit. `inlier_thresh` is in squared normalized
    coords. Nothing is read back to the host."""
    n = p0.shape[-2]
    dev = p0.device
    if valid is None:
        valid = torch.ones(p0.shape[:-1], dtype=torch.bool, device=dev)
    wv = valid.to(torch.float32)
    # sample only valid slots (the track table is a fixed-capacity pool);
    # the finite -1e9 keeps an all-invalid row free of NaN
    logits = torch.where(valid, 0.0, -1e9).to(torch.float32)
    noise = _gumbel(seed, (ransac_rounds, sample_size, n), dev)
    idx = torch.argmax(noise + logits[..., None, None, :], dim=-1)  # (..., R, S)

    batch = p0.shape[:-2]
    w = torch.zeros(*batch, ransac_rounds, n, dtype=torch.float32, device=dev)
    w = w.scatter(-1, idx, 1.0) * wv[..., None, :]
    p0r, p1r = p0[..., None, :, :], p1[..., None, :, :]
    Es = _eight_point(p0r, p1r, w)  # (..., R, 3, 3)
    # integer counts: ties stay exact, and argmax takes the first, as JAX
    scores = torch.sum((_sampson(Es, p0r, p1r) < inlier_thresh) & valid[..., None, :], dim=-1)
    best = torch.argmax(scores, dim=-1)
    E0 = torch.gather(Es, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3))[..., 0, :, :]
    inl = (_sampson(E0, p0, p1) < inlier_thresh) & valid

    # final refit on the inliers
    E = _eight_point(p0, p1, inl.to(torch.float32))
    inl = (_sampson(E, p0, p1) < inlier_thresh) & valid
    R, t = decompose_essential(E, p0, p1, inl.to(torch.float32))
    return RelativePose(R=R, t=t, E=E, inliers=inl, n_inliers=torch.sum(inl, dim=-1))
