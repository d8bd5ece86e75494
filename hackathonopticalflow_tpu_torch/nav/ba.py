"""Windowed bundle adjustment with a Schur complement (port of
hackathonopticalflow_tpu/nav/ba.py).

M keyframe poses (world->camera, so(3) rotation vector + t) and L landmarks
(world 3D), a dense observation table z (M, L, 2) in normalized camera
coords with a validity mask. Levenberg-damped Gauss-Newton on

    r_{kl} = proj(R_k X_l + t_k) - z_{kl}

with the landmark blocks C_l (3x3) inverted in a batch and the reduced
camera system

    (B - E C^-1 E^T + lambda I) delta_c = v - E C^-1 w

solved densely (6M x 6M). Gauge: pose 0 is pinned and the monocular scale
is fixed by renormalizing ||t_1|| after each step.

Every function takes leading batch dimensions (the JAX package vmaps or
lax.maps the single-window form): rvecs (..., M, 3), points (..., L, 3),
obs (..., M, L, 2), so the windows of one clip solve as one batch. The
loop never reads a value back to the host: steps are accepted with
torch.where, and the solves are the unchecked `_ex` forms.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def _identity(x):
    return x


def _cross_matrix(k: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) [k]_x."""
    zero = torch.zeros_like(k[..., 0])
    return torch.stack(
        [
            torch.stack([zero, -k[..., 2], k[..., 1]], dim=-1),
            torch.stack([k[..., 2], zero, -k[..., 0]], dim=-1),
            torch.stack([-k[..., 1], k[..., 0], zero], dim=-1),
        ],
        dim=-2,
    )


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    """so(3) vectors (..., 3) -> rotation matrices (..., 3, 3), safe at 0."""
    theta = torch.sqrt(torch.sum(w * w, dim=-1) + 1e-24)
    K = _cross_matrix(w / theta[..., None])
    s = torch.sin(theta)[..., None, None]
    c = torch.cos(theta)[..., None, None]
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    R = eye + s * K + (1.0 - c) * (K @ K)
    return torch.where((theta < 1e-9)[..., None, None], eye, R)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> so(3) vectors (..., 3), safe near 0."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(c)
    axis_raw = torch.stack(
        [R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]], dim=-1
    )
    s = torch.sin(theta)
    scale = torch.where(torch.abs(s) < 1e-7, 0.5, theta / (2.0 * torch.clamp(s, min=1e-12)))
    return axis_raw * scale[..., None]


class BAState(NamedTuple):
    rvecs: torch.Tensor  # (..., M, 3) world->cam rotation vectors
    tvecs: torch.Tensor  # (..., M, 3)
    points: torch.Tensor  # (..., L, 3) world landmarks
    obs: torch.Tensor  # (..., M, L, 2) normalized observations
    mask: torch.Tensor  # (..., M, L) bool validity


class BAStats(NamedTuple):
    cost: torch.Tensor  # (...) final weighted SSE
    initial_cost: torch.Tensor
    n_obs: torch.Tensor


def _residuals_and_jacobians(state: BAState):
    """Residuals r (..., M, L, 2), pose Jacobians Jc (..., M, L, 2, 6) and
    point Jacobians Jp (..., M, L, 2, 3)."""
    Rs = rodrigues(state.rvecs)  # (..., M, 3, 3)
    pc = torch.einsum("...mij,...lj->...mli", Rs, state.points) + state.tvecs[..., :, None, :]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = x / zs
    v = y / zs
    r = torch.stack([u, v], dim=-1) - state.obs

    # d(u, v) / d(pc): (..., M, L, 2, 3)
    zi = 1.0 / zs
    zero = torch.zeros_like(zi)
    dproj = torch.stack(
        [torch.stack([zi, zero, -u * zi], dim=-1), torch.stack([zero, zi, -v * zi], dim=-1)], dim=-2
    )
    # d pc / d t = I; d pc / d w = -[pc]_x (left perturbation R <- (I + [dw]_x) R)
    d_dw = -_cross_matrix(pc)
    Jc = torch.cat([torch.einsum("...ab,...bc->...ac", dproj, d_dw), dproj], dim=-1)  # [dw | dt]
    Jp = torch.einsum("...mlab,...mbc->...mlac", dproj, Rs)
    return r, Jc, Jp


def _schur_terms(r, Jc, Jp, weights):
    """Per-landmark contributions to the reduced camera system. weights:
    (..., M, L) float, the validity mask times any IRLS robust weight."""
    w = weights.to(r.dtype)[..., None, None]
    Jc_w = Jc * w
    Jp_w = Jp * w
    B = torch.einsum("...mlai,...mlaj->...mij", Jc_w, Jc)  # (..., M, 6, 6) camera blocks
    C = torch.einsum("...mlai,...mlaj->...lij", Jp_w, Jp)  # (..., L, 3, 3) landmark blocks
    E = torch.einsum("...mlai,...mlaj->...mlij", Jc_w, Jp)  # (..., M, L, 6, 3)
    v = -torch.einsum("...mlai,...mla->...mi", Jc_w, r)
    wg = -torch.einsum("...mlai,...mla->...li", Jp_w, r)
    return B, C, E, v, wg


def _solve_reduced(B, C, E, v, wg, lam, fix_first: bool = True, preduce=_identity):
    """The damped reduced camera solve and the landmarks' back-substitution.
    lam: a scalar or a (...) tensor. preduce reduces landmark-sharded
    contributions across devices (the identity on one device)."""
    m = B.shape[-3]
    lam = torch.as_tensor(lam, dtype=B.dtype, device=B.device)[..., None, None, None]
    eye3 = torch.eye(3, dtype=B.dtype, device=B.device)
    eye6 = torch.eye(6, dtype=B.dtype, device=B.device)
    Cinv = torch.linalg.inv_ex(C + lam * eye3, check_errors=False).inverse  # (..., L, 3, 3)
    ECinv = torch.einsum("...mlij,...ljk->...mlik", E, Cinv)
    ECET = preduce(torch.einsum("...mlik,...nlpk->...mnip", ECinv, E))  # (..., M, N, 6, 6)
    B = preduce(B)
    S = -ECET
    idx = torch.arange(m, device=B.device)
    S[..., idx, idx, :, :] += B + lam * eye6
    rhs = preduce(v - torch.einsum("...mlik,...lk->...mi", ECinv, wg))  # (..., M, 6)

    S2 = S.transpose(-3, -2).reshape(*S.shape[:-4], 6 * m, 6 * m)
    rhs2 = rhs.reshape(*rhs.shape[:-2], 6 * m)
    if fix_first:
        # pin pose 0: identity rows and columns, zero rhs
        S2 = S2.clone()
        S2[..., :6, :] = 0.0
        S2[..., :, :6] = 0.0
        S2[..., :6, :6] = eye6
        rhs2 = rhs2.clone()
        rhs2[..., :6] = 0.0
    dc = torch.linalg.solve_ex(S2, rhs2[..., None], check_errors=False).result[..., 0]
    dc = dc.reshape(*dc.shape[:-1], m, 6)
    # back-substitute the landmarks: dx = Cinv (w - E^T dc)
    dp = torch.einsum("...lij,...lj->...li", Cinv, wg - torch.einsum("...mlij,...mi->...lj", E, dc))
    return dc, dp


def _huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weights for the Huber loss on the per-observation residual
    NORM: 1 inside delta, delta / ||r|| outside. (..., M, L)."""
    rn = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-24)
    return torch.clamp(delta / rn, max=1.0)


def _cost(state: BAState, preduce=_identity, huber_delta=None) -> torch.Tensor:
    """Weighted SSE (or Huber cost) over the masked observations, (...)."""
    r, _, _ = _residuals_and_jacobians(state)
    sq = torch.sum(r * r, dim=-1)
    if huber_delta is not None:
        # Huber rho on the residual norm: r^2 inside, 2 delta ||r|| - delta^2
        # outside (rho == r^2 in the interior, so costs compare with SSE)
        rn = torch.sqrt(sq + 1e-24)
        sq = torch.where(rn <= huber_delta, sq, 2.0 * huber_delta * rn - huber_delta**2)
    return preduce(torch.sum(state.mask * sq, dim=(-2, -1)))


def bundle_adjust(
    state: BAState,
    iters: int = 10,
    lam: float = 1e-4,
    fix_scale: bool = True,
    preduce=_identity,
    huber_delta: float | None = None,
) -> tuple[BAState, BAStats]:
    """Levenberg-damped Gauss-Newton with Schur reduction, a fixed number
    of iterations. A step is accepted only where it lowers the cost (per
    window of a batch); lambda shrinks by 0.7 on acceptance and grows by 4
    on rejection.

    huber_delta: residual-norm scale (normalized camera coords) of a Huber
    robust loss, applied by IRLS re-weighting of the normal equations; None
    keeps the plain SSE."""
    init_cost = _cost(state, preduce, huber_delta)
    m = state.tvecs.shape[-2]
    if m > 1:
        t1_norm = torch.linalg.vector_norm(state.tvecs[..., 1, :], dim=-1)
    lam_c = torch.full(init_cost.shape, lam, dtype=torch.float32, device=init_cost.device)
    st = state
    for _ in range(iters):
        r, Jc, Jp = _residuals_and_jacobians(st)
        wts = st.mask.to(r.dtype)
        if huber_delta is not None:
            wts = wts * _huber_weights(r, huber_delta)
        B, C, E, v, wg = _schur_terms(r, Jc, Jp, wts)
        dc, dp = _solve_reduced(B, C, E, v, wg, lam_c, preduce=preduce)
        # left perturbation of the whole transform pc' = exp(dw) pc + dt
        # (the -[pc]_x Jacobian): R <- exp(dw) R, t <- exp(dw) t + dt
        dR = rodrigues(dc[..., :3])
        new_rvecs = so3_log(dR @ rodrigues(st.rvecs))
        new_tvecs = torch.einsum("...mij,...mj->...mi", dR, st.tvecs) + dc[..., 3:]
        new_points = st.points + dp
        if fix_scale and m > 1:
            scale = t1_norm / torch.clamp(torch.linalg.vector_norm(new_tvecs[..., 1, :], dim=-1), min=1e-12)
            new_tvecs = new_tvecs * scale[..., None, None]
            new_points = new_points * scale[..., None, None]
        cand = st._replace(rvecs=new_rvecs, tvecs=new_tvecs, points=new_points)
        improved = _cost(cand, preduce, huber_delta) < _cost(st, preduce, huber_delta)
        keep = improved[..., None, None]
        st = st._replace(
            rvecs=torch.where(keep, cand.rvecs, st.rvecs),
            tvecs=torch.where(keep, cand.tvecs, st.tvecs),
            points=torch.where(keep, cand.points, st.points),
        )
        lam_c = torch.where(improved, lam_c * 0.7, lam_c * 4.0)
    return st, BAStats(
        cost=_cost(st, preduce, huber_delta),
        initial_cost=init_cost,
        n_obs=preduce(torch.sum(st.mask, dim=(-2, -1))),
    )
