"""Ego-motion odometry: tracker -> keyframe windows -> triangulation ->
windowed bundle adjustment -> pose chain (port of
hackathonopticalflow_tpu/nav/odometry.py).

1. `collect_tracks` runs the tracker over a clip, recording each frame's
   head positions, liveness and each slot's BIRTH frame (a reused slot
   would otherwise alias two physical tracks).
2. `select_keyframes` picks keyframes by rotation-compensated parallax.
3. `build_window` assembles a keyframe window's dense (M, L, 2)
   observation table, masking inconsistent and short tracks.
4. `init_window_poses` chains per-pair essential-matrix poses (nav/pose.py)
   at unit step scale, or with closed-form landmark scale votes.
5. `triangulate` initializes the landmarks by DLT; `window_ba` refines the
   window with Schur BA (nav/ba.py).
6. `ego_motion_track` runs sliding windows, stitches them in a pose graph
   and returns the global keyframe chain, BA-refined and raw.

Tracking and keyframe selection run on `device` (the GPU unless the
caller passes device="cpu"); the window solves (pose RANSAC, chain,
triangulation, gate, Schur BA) run on `geometry_device`, the host CPU by
default, as the JAX package's _geometry_device places them: tens of
poses and hundreds of landmarks a window, solves that are latency-bound
and tiny, and on a GPU wait on the device thousands of times a clip. The
pose-graph stitch is host numpy in both packages. The windows of one clip that share a
shape solve as ONE batch with a leading window dimension (what the JAX
package's lax.map computes window by window); the keyframe pairs'
parallax is one batched call. Each group's results come back in one
packed copy.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import TrackerParams
from ..flow.device import resolve_device
from ..flow.tracker import _heads, init_tracker, track_step, track_video
from .ba import BAState, bundle_adjust, rodrigues, so3_log
from .camera import Pinhole
from .pose import estimate_relative_pose


def _np_rodrigues(w: np.ndarray) -> np.ndarray:
    """Host Rodrigues (nav/ba.py's rodrigues) for the pose-graph stitch,
    which composes a few hundred 3x3 rotations per clip."""
    theta = float(np.sqrt(np.dot(w, w) + 1e-24))
    if theta < 1e-9:
        return np.eye(3)
    k = w / theta
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def _np_so3_log(R: np.ndarray) -> np.ndarray:
    """Host inverse Rodrigues (nav/ba.py's so3_log)."""
    c = np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0)
    theta = np.arccos(c)
    axis_raw = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    s = np.sin(theta)
    scale = 0.5 if abs(s) < 1e-7 else theta / (2.0 * max(s, 1e-12))
    return axis_raw * scale


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """jnp.nanmedian over the last dim: NaNs ignored, an even count
    averages the middle pair (torch.nanmedian takes the lower one), NaN
    where no entry is valid."""
    v = torch.sort(x, dim=-1).values  # NaNs sort last
    n = torch.sum(~torch.isnan(x), dim=-1, keepdim=True).to(x.dtype)
    q = 0.5 * (n - 1.0)
    lo, hi = torch.floor(q), torch.ceil(q)
    w_hi = q - lo
    lo = torch.clamp(torch.minimum(lo, n - 1.0), min=0.0).to(torch.int64)
    hi = torch.clamp(torch.minimum(hi, n - 1.0), min=0.0).to(torch.int64)
    out = torch.gather(v, -1, lo) * (1.0 - w_hi) + torch.gather(v, -1, hi) * w_hi
    return out[..., 0]


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    #: keyframes per BA window
    window: int = 4
    #: frames between keyframes; None: adaptive selection (select_keyframes)
    kf_stride: int | None = None
    #: adaptive selector: required ratio of candidate parallax to the
    #: single-frame residual floor (both rotation-compensated medians)
    kf_alpha: float = 2.5
    #: adaptive selector: absolute parallax floor (px)
    kf_min_px: float = 2.0
    #: adaptive selector: minimum shared live tracks of a candidate
    kf_min_tracks: int = 24
    kf_min_stride: int = 2
    kf_max_stride: int = 6
    #: keyframes shared between consecutive windows
    overlap: int = 3
    ba_iters: int = 12
    ba_lambda: float = 1e-4
    min_track_obs: int = 2  # min keyframe observations to keep a track
    min_depth: float = 1e-3  # cheirality floor for triangulated depths
    #: RANSAC inlier gate in SQUARED normalized coords; None: 1 px at the
    #: camera's focal length (resolved by ego_motion_track)
    inlier_thresh: float | None = None
    #: pre-BA reprojection gate in normalized coords; None: 3 px
    max_reproj: float | None = None
    #: window-init translation scales from closed-form landmark votes
    #: (True) or the unit-step gauge (False)
    scale_votes: bool = False
    #: Huber robust-loss scale for BA in PIXELS; None: plain SSE
    huber_px: float | None = 2.0
    #: resolved normalized-coordinate Huber delta (set by ego_motion_track
    #: from huber_px)
    huber_delta: float | None = None


class TrackTable(NamedTuple):
    pos: np.ndarray  # (F, T, 2) head positions per frame
    alive: np.ndarray  # (F, T) bool
    birth: np.ndarray  # (F, T) int32, the frame the slot's track began


def _packed(heads: torch.Tensor, alive: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """(..., T, 4) float32 [x, y, alive, length]: alive is 0/1 and length
    at most trajectory_len, both exact in float32."""
    return torch.cat([heads, alive.to(torch.float32)[..., None], length.to(torch.float32)[..., None]], dim=-1)


def collect_tracks(
    frames,
    params: TrackerParams = TrackerParams(),
    chunk: int = 32,
    device: torch.device | str = "cuda",
) -> TrackTable:
    """Run the tracker over (F, H, W) frames (ndarray or tensor, uint8
    welcome) and return its per-frame rows. A seeding step on (frames[0],
    frames[0]), then track_video over chunks of `chunk` steps; each
    chunk's (n, T, 4) history comes back in one packed device-to-host
    copy. Runs on `device` (the GPU unless device="cpu")."""
    device = resolve_device(device)
    frames = torch.as_tensor(frames)
    if frames.dtype != torch.uint8:
        frames = frames.to(torch.float32)
    f0 = frames[0].to(device)
    state = track_step(init_tracker(params, device), f0, f0, params, device=device)
    rows = [_packed(_heads(state), state.alive, state.length)[None].cpu().numpy()]
    idx = 1
    while idx < len(frames):
        # the chunk covers steps idx..idx+n-1; frames[idx-1] carries the pair
        n = min(chunk, len(frames) - idx)
        state, hist = track_video(frames[idx - 1 : idx + n], params, state, device=device)
        rows.append(_packed(*hist).cpu().numpy())
        idx += n
    arr = np.concatenate(rows)
    fidx = np.arange(len(frames)).reshape(-1, 1)
    return TrackTable(
        pos=arr[..., :2],
        alive=arr[..., 2] > 0.5,
        birth=fidx - arr[..., 3].astype(np.int32) + 1,
    )


def build_window(table: TrackTable, kf_idx: np.ndarray, cfg: OdometryConfig) -> tuple[np.ndarray, np.ndarray]:
    """Dense observation table for keyframes kf_idx: (M, L, 2) positions +
    (M, L) mask. A slot contributes only where it is alive AND hosts the
    same physical track as at the window's last keyframe (births equal)."""
    pos = table.pos[kf_idx]  # (M, T, 2)
    alive = table.alive[kf_idx]
    birth = table.birth[kf_idx]
    mask = alive & (birth == birth[-1][None, :])
    keep = mask.sum(0) >= max(cfg.min_track_obs, 2)
    return pos, mask & keep[None, :]


def _rotation_residual_px(p0: torch.Tensor, p1: torch.Tensor, ok: torch.Tensor, fx: float) -> torch.Tensor:
    """Median pixel residual after the best rotation-only alignment of the
    two frames' bearing vectors (Kabsch over the correspondence
    covariance): the translation-induced parallax. p0, p1 (..., T, 2)
    (broadcast against each other), ok (..., T) -> (...)."""
    b0 = torch.cat([p0, torch.ones_like(p0[..., :1])], dim=-1)
    b1 = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    b0 = b0 / torch.linalg.vector_norm(b0, dim=-1, keepdim=True)
    b1 = b1 / torch.linalg.vector_norm(b1, dim=-1, keepdim=True)
    H = torch.einsum("...n,...ni,...nj->...ij", ok.to(torch.float32), b1, b0)
    u, _, vt = torch.linalg.svd(H)
    d = torch.linalg.det(u @ vt)
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    R = (u * diag[..., None, :]) @ vt
    rb = b0 @ R.transpose(-1, -2)
    z = torch.where(torch.abs(rb[..., 2]) < 1e-6, 1e-6, rb[..., 2])
    proj = rb[..., :2] / z[..., None]
    err = torch.linalg.vector_norm(proj - p1, dim=-1) * fx
    return _nanmedian(torch.where(ok, err, torch.nan))


def select_keyframes(
    table: TrackTable, cam: Pinhole, cfg: OdometryConfig, device: torch.device | str = "cuda"
) -> np.ndarray:
    """Adaptive keyframe selection (cfg.kf_stride is None).

    Greedy walk: from keyframe a, the rotation-compensated median parallax
    of frame a+1 (the clip's per-step residual floor: track noise and
    blur) and of every candidate a+s, s in [kf_min_stride, kf_max_stride].
    The next keyframe is the first candidate whose parallax clears
    max(kf_alpha * floor, kf_min_px), bounded by track survival
    (kf_min_tracks shared live tracks). The parallax of every (anchor,
    candidate) pair is one batched call on `device` and one fetch; the
    walk runs on the host."""
    device = resolve_device(device)
    f = len(table.pos)
    lo, hi = cfg.kf_min_stride, cfg.kf_max_stride
    if f < 2 or lo > f - 1:
        return np.asarray([0])
    anchors = np.arange(f - 1)
    # column 0: the a+1 noise floor; columns 1..: candidates a+lo..a+hi,
    # clipped to the last frame (the walk slices the clipped ones off)
    cand_mat = np.concatenate(
        [anchors[:, None] + 1, np.minimum(anchors[:, None] + np.arange(lo, hi + 1)[None, :], f - 1)], axis=1
    )
    # the same physical track at both ends: alive at both, births equal
    ok = (
        table.alive[anchors][:, None, :]
        & table.alive[cand_mat]
        & (table.birth[cand_mat] == table.birth[anchors][:, None, :])
    )  # (f-1, K, T)
    npos = cam.normalize(table.pos).to(device)
    res_all = _rotation_residual_px(
        npos[anchors][:, None], npos[cand_mat], torch.from_numpy(ok).to(device), cam.fx
    ).cpu().numpy()  # (f-1, K)
    n_shared_all = ok.sum(-1)

    kf = [0]
    while kf[-1] < f - 1:
        a = kf[-1]
        n_c = min(a + hi, f - 1) - (a + lo) + 1
        if n_c <= 0:
            break
        cand = np.arange(a + lo, a + lo + n_c)
        if n_c == 1:
            kf.append(int(cand[0]))
            continue
        floor = res_all[a, 0]
        res = res_all[a, 1 : 1 + n_c]
        n_shared = n_shared_all[a, 1 : 1 + n_c]
        thresh = max(cfg.kf_alpha * (floor if np.isfinite(floor) else 0.0), cfg.kf_min_px)
        # candidates past the track-survival bound are ineligible (the
        # first stays, so the walk always advances)
        alivec = (n_shared >= cfg.kf_min_tracks) | (np.arange(n_c) == 0)
        eligible = np.nan_to_num(res, nan=np.inf) >= thresh
        hit = np.flatnonzero(eligible & alivec)
        pick = hit[0] if len(hit) else int(np.flatnonzero(alivec)[-1])  # else the furthest surviving
        kf.append(int(cand[pick]))
    return np.asarray(kf)


def triangulate(obs: torch.Tensor, mask: torch.Tensor, rvecs: torch.Tensor, tvecs: torch.Tensor) -> torch.Tensor:
    """Batched DLT: landmark l minimizes ||A_l X|| with A_l stacked from the
    masked rows u P[2] - P[0], v P[2] - P[1] over keyframes, solved by the
    smallest eigenvector of the (4, 4) normal matrix. obs (..., M, L, 2),
    mask (..., M, L), poses (..., M, 3) -> points (..., L, 3)."""
    P = torch.cat([rodrigues(rvecs), tvecs[..., None]], dim=-1)  # (..., M, 3, 4)
    u = obs[..., 0, None]
    v = obs[..., 1, None]
    r0 = u * P[..., :, None, 2, :] - P[..., :, None, 0, :]  # (..., M, L, 4)
    r1 = v * P[..., :, None, 2, :] - P[..., :, None, 1, :]
    w = mask.to(obs.dtype)[..., None]
    A = torch.cat([r0 * w, r1 * w], dim=-3)  # (..., 2M, L, 4)
    M4 = torch.einsum("...mli,...mlj->...lij", A, A)
    X = torch.linalg.eigh(M4).eigenvectors[..., 0]  # the smallest eigenvalue's
    wcomp = X[..., 3]
    wsafe = torch.where(torch.abs(wcomp) < 1e-9, 1e-9, wcomp)
    return X[..., :3] / wsafe[..., None]


def _reproj_mask(points, rvecs, tvecs, obs, mask, cfg: OdometryConfig) -> torch.Tensor:
    """Drop observations behind a camera or with a gross reprojection
    error (normalized coords) before BA; a landmark keeps >= 2 views."""
    max_err = cfg.max_reproj if cfg.max_reproj is not None else 5e-2
    pc = torch.einsum("...mij,...lj->...mli", rodrigues(rvecs), points) + tvecs[..., :, None, :]
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    err = torch.linalg.vector_norm(pc[..., :2] / zs[..., None] - obs, dim=-1)
    ok = mask & (z > cfg.min_depth) & (err < max_err)
    return ok & (torch.sum(ok, dim=-2) >= 2)[..., None, :]


def _scale_votes(a: torch.Tensor, bdir: torch.Tensor, uv: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
    """Per-landmark closed-form scale s solving u = (a_x + s b_x) / (a_z +
    s b_z): the median of the valid votes of both image axes."""
    u = uv[..., 0]
    v = uv[..., 1]
    num_u = u * a[..., 2] - a[..., 0]
    den_u = bdir[0] - u * bdir[2]
    num_v = v * a[..., 2] - a[..., 1]
    den_v = bdir[1] - v * bdir[2]
    s_u = num_u / torch.where(torch.abs(den_u) < 1e-9, 1e-9, den_u)
    s_v = num_v / torch.where(torch.abs(den_v) < 1e-9, 1e-9, den_v)
    votes = torch.cat([s_u, s_v])
    vok = torch.cat([ok & (torch.abs(den_u) > 1e-6), ok & (torch.abs(den_v) > 1e-6)])
    return _nanmedian(torch.where(vok, votes, torch.nan))


def _init_chain_core(obs: torch.Tensor, mask: torch.Tensor, thresh: float):
    """Unit-step essential chain: per-pair RANSAC over the M-1 keyframe
    pairs of every window at once, composed pair by pair, then the
    landmarks triangulated. obs (..., M, L, 2) -> (rvecs, tvecs, points)."""
    m = obs.shape[-3]
    pair_ok = mask[..., :-1, :] & mask[..., 1:, :]
    rp = estimate_relative_pose(obs[..., :-1, :, :], obs[..., 1:, :, :], pair_ok, inlier_thresh=thresh)
    R = torch.eye(3, dtype=obs.dtype, device=obs.device).expand(*obs.shape[:-3], 3, 3)
    t = torch.zeros(*obs.shape[:-3], 3, dtype=obs.dtype, device=obs.device)
    Rs, ts = [R], [t]
    for k in range(m - 1):
        R_rel = rp.R[..., k, :, :]
        t = (R_rel @ t[..., None])[..., 0] + rp.t[..., k, :]  # unit step scale (the window gauge)
        R = R_rel @ R
        Rs.append(R)
        ts.append(t)
    rv = so3_log(torch.stack(Rs, dim=-3))
    tv = torch.stack(ts, dim=-2)
    return rv, tv, triangulate(obs, mask, rv, tv)


def init_window_poses(obs, mask, cfg: OdometryConfig) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Chained essential-matrix initialization of one window, on obs's
    device (an ndarray's is the CPU).

    Pose 0 is identity; pose 1 gets unit translation (the window's scale
    gauge); with cfg.scale_votes each further step's scale is the median
    closed-form vote of the landmarks triangulated from the poses so far
    (a sequential host loop); without it every step is unit scale.
    Returns (rvecs (M, 3), tvecs (M, 3), points (L, 3))."""
    obs = torch.as_tensor(obs)
    mask = torch.as_tensor(mask, device=obs.device)
    thresh = cfg.inlier_thresh if cfg.inlier_thresh is not None else 1e-5
    if not cfg.scale_votes:
        return tuple(x.cpu().numpy() for x in _init_chain_core(obs, mask, thresh))
    dev = obs.device
    rvecs = [np.zeros(3, np.float32)]
    tvecs = [np.zeros(3, np.float32)]
    for k in range(1, obs.shape[0]):
        rp = estimate_relative_pose(obs[k - 1], obs[k], mask[k - 1] & mask[k], inlier_thresh=thresh)
        R_rel = rp.R.cpu().numpy()
        t_rel = rp.t.cpu().numpy()
        R_k = R_rel @ rodrigues(torch.from_numpy(rvecs[-1])).numpy()
        t_base = R_rel @ tvecs[-1]
        s = 1.0
        if k > 1:
            pts3 = triangulate(obs[:k], mask[:k], torch.from_numpy(np.stack(rvecs)).to(dev),
                               torch.from_numpy(np.stack(tvecs)).to(dev))
            # votes from the landmarks seen both before k and at k
            seen = (mask[:k].sum(0) >= 2) & mask[k]
            a = torch.einsum("ij,lj->li", torch.from_numpy(R_k).to(dev), pts3) + torch.from_numpy(t_base).to(dev)
            s = float(_scale_votes(a, rp.t, obs[k], seen))
            if not np.isfinite(s) or s <= 1e-6:
                s = 1.0
        rvecs.append(so3_log(torch.from_numpy(R_k)).numpy().astype(np.float32))
        tvecs.append((t_base + s * t_rel).astype(np.float32))
    rv = np.stack(rvecs)
    tv = np.stack(tvecs)
    pts3 = triangulate(obs, mask, torch.from_numpy(rv).to(dev), torch.from_numpy(tv).to(dev))
    return rv, tv, pts3.cpu().numpy()


def _window_solve(obs: torch.Tensor, mask: torch.Tensor, cfg: OdometryConfig) -> torch.Tensor:
    """Whole-window solve of a (W, M, L, ...) stack: chain init ->
    reprojection gate -> Schur BA. Returns one packed (W, 12 M + 3)
    float32 tensor: refined rvecs and tvecs, raw rvecs and tvecs, the
    initial and final cost and the observation count (exact in float32)."""
    thresh = cfg.inlier_thresh if cfg.inlier_thresh is not None else 1e-5
    rv0, tv0, pts3 = _init_chain_core(obs, mask, thresh)
    ok = _reproj_mask(pts3, rv0, tv0, obs, mask, cfg)
    state = BAState(rvecs=rv0, tvecs=tv0, points=pts3, obs=obs, mask=ok)
    refined, stats = bundle_adjust(state, iters=cfg.ba_iters, lam=cfg.ba_lambda, huber_delta=cfg.huber_delta)
    w = obs.shape[0]
    return torch.cat(
        [x.reshape(w, -1) for x in (refined.rvecs, refined.tvecs, rv0, tv0)]
        + [torch.stack([stats.initial_cost, stats.cost, stats.n_obs.to(torch.float32)], dim=-1)],
        dim=-1,
    )


def _unpack_window(row: np.ndarray, m: int) -> tuple[np.ndarray, np.ndarray, dict]:
    """One window's packed row -> (rvecs, tvecs, stats)."""
    rv, tv, rv0, tv0 = (row[i * 3 * m : (i + 1) * 3 * m].reshape(m, 3) for i in range(4))
    c0, c, n = row[12 * m :]
    return rv, tv, {"raw_rvecs": rv0, "raw_tvecs": tv0, "cost0": float(c0), "cost": float(c), "n_obs": int(n)}


def window_ba(obs, mask, cfg: OdometryConfig) -> tuple[np.ndarray, np.ndarray, dict]:
    """One window, on obs's device (an ndarray's is the CPU): init -> gate
    -> BA. Returns (rvecs, tvecs, stats)."""
    obs = torch.as_tensor(obs)
    mask = torch.as_tensor(mask, device=obs.device)
    m = obs.shape[0]
    if not cfg.scale_votes:
        return _unpack_window(_window_solve(obs[None], mask[None], cfg)[0].cpu().numpy(), m)
    rv, tv, pts3 = init_window_poses(obs, mask, cfg)
    rv_t, tv_t, pts_t = (torch.from_numpy(x).to(obs.device) for x in (rv, tv, pts3))
    ok = _reproj_mask(pts_t, rv_t, tv_t, obs, mask, cfg)
    state = BAState(rvecs=rv_t, tvecs=tv_t, points=pts_t, obs=obs, mask=ok)
    refined, stats = bundle_adjust(state, iters=cfg.ba_iters, lam=cfg.ba_lambda, huber_delta=cfg.huber_delta)
    return (
        refined.rvecs.cpu().numpy(),
        refined.tvecs.cpu().numpy(),
        {"raw_rvecs": rv, "raw_tvecs": tv, "cost0": float(stats.initial_cost), "cost": float(stats.cost),
         "n_obs": int(stats.n_obs)},
    )


def _geodesic_mean(Rs: list[np.ndarray]) -> np.ndarray:
    """so(3) geodesic mean of a few nearby rotations (one Gauss iteration
    from the first)."""
    if len(Rs) == 1:
        return Rs[0]
    R0 = Rs[0]
    w = np.mean([_np_so3_log(R @ R0.T) for R in Rs], axis=0)
    return _np_rodrigues(w) @ R0


def stitch_pose_graph(
    windows: list[tuple[np.ndarray, np.ndarray]], starts: list[int]
) -> tuple[np.ndarray, np.ndarray]:
    """Cross-window pose-graph stitching.

    Each window (rvecs (M, 3), tvecs (M, 3) world->cam, its own scale
    gauge) contributes, for every keyframe step k -> k+1 it covers, a
    relative rotation R_{k+1} R_k^T and a step vector in keyframe k's
    CAMERA frame. The chain is solved in closed form: window log-scales
    chain by the mean log step-length ratio over the shared steps; shared
    relative rotations average geodesically, shared steps after scale
    alignment; the global chain composes the averaged steps. Returns
    (centers (K, 3), rotations (K, 3, 3) world->cam)."""
    nsteps = max(s + len(rv) for (rv, _), s in zip(windows, starts)) - 1
    rels: list[list] = [[] for _ in range(nsteps)]  # (R_rel, d_cam, widx)
    for widx, ((rv, tv), s) in enumerate(zip(windows, starts)):
        Rs = np.stack([_np_rodrigues(r) for r in rv])
        Cs = np.stack([-(R.T @ t) for R, t in zip(Rs, tv)])
        for j in range(len(rv) - 1):
            d_cam = Rs[j] @ (Cs[j + 1] - Cs[j])  # cam-j frame, window scale
            rels[s + j].append((Rs[j + 1] @ Rs[j].T, d_cam, widx))
    logs = np.zeros(len(windows))
    for w in range(1, len(windows)):
        votes = []
        for k in range(nsteps):
            d_prev = [d for (_, d, i) in rels[k] if i == w - 1]
            d_cur = [d for (_, d, i) in rels[k] if i == w]
            if d_prev and d_cur:
                np_prev = np.linalg.norm(d_prev[0])
                np_cur = np.linalg.norm(d_cur[0])
                if np_prev > 1e-9 and np_cur > 1e-9:
                    votes.append(np.log(np_prev) - np.log(np_cur))
        logs[w] = logs[w - 1] + (np.mean(votes) if votes else 0.0)
    scales = np.exp(logs)
    chain_R = [np.eye(3)]
    chain_C = [np.zeros(3)]
    for k in range(nsteps):
        if not rels[k]:
            break
        R_rel = _geodesic_mean([R for (R, _, _) in rels[k]])
        d = np.mean([scales[i] * d for (_, d, i) in rels[k]], axis=0)
        chain_C.append(chain_C[-1] + chain_R[-1].T @ d)
        chain_R.append(R_rel @ chain_R[-1])
    return np.stack(chain_C), np.stack(chain_R)


class EgoMotionResult(NamedTuple):
    kf_idx: np.ndarray  # (K,) frame indices of keyframes
    centers: np.ndarray  # (K, 3) BA-refined camera centers (global chain)
    rotations: np.ndarray  # (K, 3, 3) world->cam
    raw_centers: np.ndarray  # (K, 3) raw essential-chain centers
    stats: list  # per-window dicts


def resolve_config(cfg: OdometryConfig, cam: Pinhole) -> OdometryConfig:
    """cfg with its camera-dependent gates set where they are None: the
    RANSAC gate at 1 px, the reprojection gate at 3 px and the Huber delta
    at huber_px, all at the camera's focal length."""
    return dataclasses.replace(
        cfg,
        inlier_thresh=cfg.inlier_thresh if cfg.inlier_thresh is not None else cam.sq_norm_thresh(1.0),
        max_reproj=cfg.max_reproj if cfg.max_reproj is not None else 3.0 / cam.fx,
        huber_delta=cfg.huber_delta
        if cfg.huber_delta is not None
        else (cfg.huber_px / cam.fx if cfg.huber_px is not None else None),
    )


def ego_motion_track(
    frames,
    tracker_params: TrackerParams,
    cam: Pinhole,
    cfg: OdometryConfig = OdometryConfig(),
    table: TrackTable | None = None,
    device: torch.device | str = "cuda",
    geometry_device: torch.device | str = "cpu",
) -> EgoMotionResult:
    """Ego-motion over a clip of (H, W) frames: tracking (collect_tracks)
    and keyframes on `device` (the GPU unless device="cpu"), the windowed
    BA on `geometry_device` (the host CPU unless the caller passes
    another), then the pose-graph stitch on the host. Pass a precomputed
    `table` to rerun the geometry without re-tracking (frames are then
    unused)."""
    device = resolve_device(device)
    geometry_device = resolve_device(geometry_device)
    cfg = resolve_config(cfg, cam)
    if table is None:
        table = collect_tracks(frames, tracker_params, device=device)
    f = len(table.pos)
    kf_idx = select_keyframes(table, cam, cfg, device) if cfg.kf_stride is None else np.arange(0, f, cfg.kf_stride)
    if len(kf_idx) < 2:
        raise ValueError("clip too short for a keyframe window")
    m = cfg.window
    stride = max(m - cfg.overlap, 1)
    entries: list = []  # (start, obs, mask)
    start = 0
    while start < len(kf_idx) - 1:
        idx = kf_idx[start : start + m]
        if len(idx) < 2:
            break
        pos, mask = build_window(table, idx, cfg)
        entries.append((start, cam.normalize(pos), mask))
        start += stride
    wins_ba: dict = {}
    wins_raw: dict = {}
    stats_by_start: dict = {}
    if cfg.scale_votes:
        # sequential dependence through the growing map: window by window
        for st_i, obs, mask in entries:
            rv, tv, st = window_ba(obs.to(geometry_device), mask, cfg)
            wins_ba[st_i] = (rv, tv)
            wins_raw[st_i] = (st["raw_rvecs"], st["raw_tvecs"])
            stats_by_start[st_i] = st
    else:
        # same-shape windows (the tail one can be short) solve as one batch
        groups: dict[int, list] = {}
        for e in entries:
            groups.setdefault(e[1].shape[0], []).append(e)
        for gm, ents in groups.items():
            obs_b = torch.stack([e[1] for e in ents]).to(geometry_device)
            mask_b = torch.from_numpy(np.stack([e[2] for e in ents])).to(geometry_device)
            rows = _window_solve(obs_b, mask_b, cfg).cpu().numpy()  # one fetch per group
            for (st_i, _, _), row in zip(ents, rows):
                rv, tv, st = _unpack_window(row, gm)
                wins_ba[st_i] = (rv, tv)
                wins_raw[st_i] = (st["raw_rvecs"], st["raw_tvecs"])
                stats_by_start[st_i] = st
    starts = sorted(wins_ba)
    chain_C, chain_R = stitch_pose_graph([wins_ba[s] for s in starts], starts)
    raw_C, _ = stitch_pose_graph([wins_raw[s] for s in starts], starts)
    k = len(chain_C)
    return EgoMotionResult(
        kf_idx=kf_idx[:k],
        centers=chain_C,
        rotations=chain_R,
        raw_centers=raw_C[:k],
        stats=[stats_by_start[s] for s in starts],
    )
