"""Ring-scheduled distributed bundle adjustment, keyframes sharded (port
of hackathonopticalflow_tpu/parallel/ba_ring.py; SURVEY.md §5.7b, the
ring-attention pattern applied to BA factor blocks).

ba_dist.py shards the landmark axis and psums the reduced camera system.
This module shards the keyframe axis instead, for large windows:

- each rank owns a camera shard's observation table (Mloc, L) and
  computes only its own residuals and Jacobians (the (M, L) work is what
  dominates BA); poses and landmarks are small and stay replicated, so
  the update and the gauge fixes run alike on every rank;
- the landmark Hessians C (L, 3, 3) and gradients w (L, 3) are sums over
  cameras: one psum each;
- the cross-camera Schur blocks E_m C^-1 E_n^T couple camera shards, so
  each rank whitens its factor G_m = E_m chol(C^-1) and the shards rotate
  around a ppermute ring: after n - 1 shifts every rank holds its row
  block of the reduced system as (Mloc x Mloc) outer products G_i G_j^T;
- the row blocks are all-gathered (M^2 6x6 blocks) and the pinned (6M,
  6M) system is solved on every rank; the landmarks' back-substitution
  psums the shards' E^T dc terms.

Step for step it is nav/ba.py::bundle_adjust (same damping,
accept/reject and gauge fixes); the solves are the unchecked `_ex` forms.
"""

from __future__ import annotations

import torch

from ..nav.ba import BAState, BAStats, _residuals_and_jacobians, _schur_terms, rodrigues, so3_log
from .collectives import all_gather, axis_index, axis_size, ppermute, psum, shard_rows
from .mesh import Mesh, MeshAxis


def shard_keyframes(state: BAState, mesh: Mesh, axis_name: str = "win") -> BAState:
    """This rank's shard of a window: poses and points whole, obs (M/n, L,
    2) and mask (M/n, L), on the mesh's device."""
    dev = mesh.device
    return BAState(
        rvecs=state.rvecs.to(dev),
        tvecs=state.tvecs.to(dev),
        points=state.points.to(dev),
        obs=shard_rows(state.obs, mesh, axis_name, 0),
        mask=shard_rows(state.mask, mesh, axis_name, 0),
    )


def _local_cost(rvecs_l, tvecs_l, points, obs_l, mask_l, ax: MeshAxis) -> torch.Tensor:
    st = BAState(rvecs=rvecs_l, tvecs=tvecs_l, points=points, obs=obs_l, mask=mask_l)
    r, _, _ = _residuals_and_jacobians(st)
    return psum(torch.sum(mask_l * torch.sum(r * r, dim=-1)), ax)


def ring_bundle_adjust(
    state: BAState,
    mesh: Mesh,
    axis_name: str = "win",
    iters: int = 10,
    lam: float = 1e-4,
    fix_scale: bool = True,
) -> tuple[BAState, BAStats]:
    """Windowed BA of this rank's keyframe shard (shard_keyframes: the
    keyframe count must divide by the axis size), the Schur factors
    exchanged on a ppermute ring. Poses and points are replicated and come
    back equal on every rank; the stats are the window's."""
    ax = mesh.axis(axis_name)
    n, idx = axis_size(ax), axis_index(ax)
    rvecs, tvecs, points, obs_l, mask_l = state
    m = rvecs.shape[0]
    mloc = obs_l.shape[0]
    if mloc * n != m:
        raise ValueError(f"keyframe count {m} not divisible by {n} ranks (shard of {mloc})")
    fwd = [(i, (i + 1) % n) for i in range(n)]
    mine = slice(idx * mloc, (idx + 1) * mloc)
    dev, dt = rvecs.device, rvecs.dtype
    eye3 = torch.eye(3, dtype=dt, device=dev)
    eye6 = torch.eye(6, dtype=dt, device=dev)

    def cost_of(rv, tv, pts):
        return _local_cost(rv[mine], tv[mine], pts, obs_l, mask_l, ax)

    init_cost = cost_of(rvecs, tvecs, points)
    t1_norm = torch.linalg.vector_norm(tvecs[1]) if m > 1 else 1.0
    rv, tv, pts = rvecs, tvecs, points
    lam_c = torch.tensor(lam, dtype=torch.float32, device=dev)
    for _ in range(iters):
        st_l = BAState(rvecs=rv[mine], tvecs=tv[mine], points=pts, obs=obs_l, mask=mask_l)
        r, Jc, Jp = _residuals_and_jacobians(st_l)
        B_l, C_p, E_l, v_l, wg_p = _schur_terms(r, Jc, Jp, mask_l.to(r.dtype))
        C = psum(C_p, ax)
        wg = psum(wg_p, ax)
        Cinv = torch.linalg.inv_ex(C + lam_c * eye3, check_errors=False).inverse
        # whitened factor: E Cinv E^T = (E Lc)(E Lc)^T, Lc = chol(Cinv)
        Lc = torch.linalg.cholesky_ex(Cinv, check_errors=False).L
        G_l = torch.einsum("mlij,ljk->mlik", E_l, Lc)

        s_rows = torch.zeros((mloc, m, 6, 6), dtype=G_l.dtype, device=dev)
        G_rot = G_l
        for k in range(n):
            src = (idx - k) % n  # whose factor this round's visitor is
            s_rows[:, src * mloc : (src + 1) * mloc] = -torch.einsum("mlij,nlkj->mnik", G_l, G_rot)
            if k < n - 1:
                G_rot = ppermute(G_rot, fwd, ax)
        # diagonal camera blocks and damping
        cams = torch.arange(mloc, device=dev)
        s_rows[cams, idx * mloc + cams] += B_l + lam_c * eye6
        rhs_l = v_l - torch.einsum("mlij,ljk,lk->mi", E_l, Cinv, wg)

        S = all_gather(s_rows, ax).reshape(m, m, 6, 6)
        rhs = all_gather(rhs_l, ax).reshape(m, 6)
        S2 = S.permute(0, 2, 1, 3).reshape(6 * m, 6 * m)
        rhs2 = rhs.reshape(6 * m).clone()
        # pin pose 0 (the gauge, as nav/ba.py)
        S2[:6, :] = 0.0
        S2[:, :6] = 0.0
        S2[:6, :6] = eye6
        rhs2[:6] = 0.0
        dc = torch.linalg.solve_ex(S2, rhs2[:, None], check_errors=False).result[:, 0].reshape(m, 6)

        et_dc = psum(torch.einsum("mlij,mi->lj", E_l, dc[mine]), ax)
        dp = torch.einsum("lij,lj->li", Cinv, wg - et_dc)

        # replicated pose and landmark update: nav/ba.py's arithmetic
        dR = rodrigues(dc[:, :3])
        new_rv = so3_log(dR @ rodrigues(rv))
        new_tv = torch.einsum("mij,mj->mi", dR, tv) + dc[:, 3:]
        new_pts = pts + dp
        if fix_scale and m > 1:
            scale = t1_norm / torch.clamp(torch.linalg.vector_norm(new_tv[1]), min=1e-12)
            new_tv = new_tv * scale
            new_pts = new_pts * scale
        c_old = cost_of(rv, tv, pts)
        improved = cost_of(new_rv, new_tv, new_pts) < c_old
        rv = torch.where(improved, new_rv, rv)
        tv = torch.where(improved, new_tv, tv)
        pts = torch.where(improved, new_pts, pts)
        lam_c = torch.where(improved, lam_c * 0.7, lam_c * 4.0)
    return (
        BAState(rvecs=rv, tvecs=tv, points=pts, obs=obs_l, mask=mask_l),
        BAStats(cost=cost_of(rv, tv, pts), initial_cost=init_cost, n_obs=psum(torch.sum(mask_l), ax)),
    )
