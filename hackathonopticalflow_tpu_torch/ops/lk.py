"""Pyramidal Lucas-Kanade (port of hackathonopticalflow_tpu/ops/lk.py).

Two paths, chosen by params.grid_step; every level runs
`ops/lk_level.py::lk_level`.

- grid_step set: the static measurement grid. Templates come from the
  grid extractor (`ops/grid_templates.py`: the `grid_templates` kernel on
  the GPU, cut from the three level planes). Each level's crop is one of
  three:
  - at the top level of the lanes kernel, anchored at the point's grid
    position with margin iter_margin_top ("centred": the JAX lanes
    kernels' slab is that crop);
  - below the top with a rescue there (rescue_large, and rescue_levels
    None or above the level), centred at the point's clipped coarse
    estimate with margin rescue_margin ("centred");
  - everywhere else (every level of grid_kernel="blocked"; the lanes
    levels without a rescue), cut from the grid-anchored slab at the
    coarse estimate with margin iter_margin (iter_margin_top at the top)
    ("anchored"): a point whose crop does not fit in its slab freezes
    and keeps the coarse estimate, as the JAX kernels' phase A does.
- grid_step None: arbitrary points (the tracker's). Templates are
  bilinear windows at each point (`extract_patches_multi`, the
  `patch_bilinear` kernel on the GPU); points whose template window lies
  outside the frame get zero templates, which the level's spectral gate
  rejects. With points_lanes, crops are centred at each point's init,
  clipped to [-(win+2), size+2] (JAX use_pallas + points_lanes); with a
  slab_margin, the v1 slab geometry (JAX lk_iterate, or its XLA slab
  path); with neither, the exact path (JAX's default LKParams(): each
  iteration reads its window from the plane).

Frames may carry a stream axis: prepare_frame takes (B, H, W), and
pyr_lk_prepared then tracks the same points in every stream, laid out
stream-major (B * N rows, stream b's at rows b*N .. b*N+N-1), with one
`lk_level` launch per level for all streams; its results are (B, N, ...).
The cached index tensors stay per grid: streams share them.

Level 0 also gives OpenCV's err, the mean |window - template| at each
point's final position, 0 where status is false: always on the
arbitrary-point paths and with compute_err on the grid path, as the JAX
package does.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..core import LKParams, measurement_grid
from .deriv import scharr_deriv
from .image import reflect101_pad
from .lk_level import lk_level
from .grid_templates import _axis_bases, axis_key, grid_templates
from .patch import extract_patches, extract_patches_multi
from .pyramid import build_pyramid


class LKResult(NamedTuple):
    next_pts: torch.Tensor  # (N, 2) float32
    status: torch.Tensor  # (N,) bool — False where tracking failed at level 0
    err: torch.Tensor  # (N,) float32 — mean |window residual| at level 0 (zeros on the grid path without compute_err)


class PreparedFrame(NamedTuple):
    """Per-frame quantized pyramid levels and Scharr derivatives, padded
    for window sampling; built once per frame of a clip."""

    img_p: tuple  # per level: ([B,] H+2p, W+2p) reflect-101 padded image
    dix_p: tuple  # per level: zero-padded d/dx
    diy_p: tuple  # per level: zero-padded d/dy


def _frame_pad(params: LKParams) -> int:
    """Window-sampling border pad (the JAX package's value): the window
    plus 2; the grid path's slab margins and init-centred crops; the
    init-centred crops of points_lanes (26 px for TRACKER_LK; 17 for its
    v1 form)."""
    win_w, win_h = params.win_size
    pad = max(win_w, win_h) + 2
    if params.grid_step is not None:
        half = (max(win_w, win_h) - 1) // 2
        m = max(params.slab_margin_x, params.slab_margin_y, params.iter_margin_top)
        pad = max(pad, half + m + 2)
        if params.rescue_large:
            pad = max(pad, _init_centered_pad(win_w, win_h, params.rescue_margin))
    if params.points_lanes:
        pad = max(pad, _init_centered_pad(win_w, win_h, _point_margin(params)))
    return pad


def _point_margin(params: LKParams) -> int:
    """Crop margin of the arbitrary-point path."""
    return params.slab_margin if params.slab_margin is not None else 8


def _init_centered_pad(win_w: int, win_h: int, margin: int) -> int:
    """Border pad of the init-centred crop: the clipped init reaches
    win + 2 beyond the frame and the crop margin past it. Includes the JAX
    package's 8-aligned x slack so both pad identically."""
    crop_x = win_w + 1 + 2 * margin
    slack = (-crop_x) % 8
    return max(win_w + margin + 3 + slack, win_h + margin + 3)


GRID_KERNELS = ("lanes", "blocked")


def _check_params(params: LKParams) -> None:
    if params.grid_kernel not in GRID_KERNELS:
        raise ValueError(f"grid_kernel must be one of {GRID_KERNELS}, got {params.grid_kernel!r}")


def prepare_frame(img: torch.Tensor, params: LKParams) -> PreparedFrame:
    """img: (H, W) grayscale in [0, 255] (any dtype; cast to float32), or
    (B, H, W), one frame per stream: every level keeps the stream axis."""
    _check_params(params)
    pad = _frame_pad(params)
    pyr = build_pyramid(img.to(torch.float32), params.max_level, quantize_u8=True)
    imgs, dxs, dys = [], [], []
    for lv in pyr:
        dx, dy = scharr_deriv(lv)
        imgs.append(reflect101_pad(lv, pad).contiguous())
        dxs.append(torch.nn.functional.pad(dx, (pad, pad, pad, pad)))
        dys.append(torch.nn.functional.pad(dy, (pad, pad, pad, pad)))
    return PreparedFrame(img_p=tuple(imgs), dix_p=tuple(dxs), diy_p=tuple(dys))


def _halfwin(params: LKParams, device) -> torch.Tensor:
    """(2,) float32 [(win_w - 1) / 2, (win_h - 1) / 2] on `device`. Made
    once per window and device: a tensor built from the host at every
    level costs a pageable copy and a stream sync each."""
    return _halfwin_on(tuple(params.win_size), torch.device(device))


@functools.lru_cache(maxsize=16)
def _halfwin_on(win_size: tuple, device: torch.device) -> torch.Tensor:
    win_w, win_h = win_size
    return torch.tensor(
        [(win_w - 1) * 0.5, (win_h - 1) * 0.5], dtype=torch.float32, device=device
    )


@functools.lru_cache(maxsize=16)
def _grid_axes(h: int, w: int, step: int) -> tuple[tuple, tuple]:
    """(xs, ys): the axis coordinates of measurement_grid(h, w, step), as
    tuples of ints."""
    g = measurement_grid(h, w, step)
    return tuple(np.unique(g[:, 0]).astype(int).tolist()), tuple(np.unique(g[:, 1]).astype(int).tolist())


@functools.lru_cache(maxsize=32)
def _slab_bases(xs: tuple, ys: tuple, level: int, off_x: float, off_y: float, device: torch.device) -> torch.Tensor:
    """(N, 2) int32 grid-anchored slab origins [x, y] at `level`, x-major,
    on `device`; made once per grid, level, offset and device, as
    _halfwin_on is."""
    bx, _ = _axis_bases(xs, level, off_x)
    by, _ = _axis_bases(ys, level, off_y)
    base = np.stack(np.meshgrid(bx, by, indexing="ij"), -1).reshape(-1, 2)
    return torch.as_tensor(base.astype(np.int32), device=device)


def _anchored(level: int, params: LKParams) -> bool:
    """Whether a grid level cuts its crops from grid-anchored slabs: every
    level of the blocked kernel; below the top, the lanes levels without a
    rescue (JAX ops/lk.py:575-579)."""
    if params.grid_kernel == "blocked":
        return True
    if level == params.max_level:
        return False
    rescue = params.rescue_large and (params.rescue_levels is None or level < params.rescue_levels)
    return not rescue


def _anchored_crops(
    tl0: torch.Tensor, grid_xy: tuple, level: int, m: int, params: LKParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """(crop_org (N, 2) int32, fits (N,) bool) of the grid-anchored crops,
    the grid kernels' phase A (JAX lk_pallas2.py:130-159,
    lk_pallas3.py:119-126, 167-177). Each point's slab sits at its grid
    anchor: (win+1+2*margin) px per axis from _axis_bases(coords, level,
    halfwin + margin), margins (slab_margin_x, slab_margin_y), or
    ((128-win_w-1)//2, slab_margin_y) for the blocked kernel, whose slab is
    128 px wide. The crop of win+1+2m px starts at clip(floor(tl0) - base -
    m, 0, slack) inside it; a point whose unclipped offset leaves [0,
    slack] does not fit and freezes. The slack is Rx - crop_x for blocked,
    Rx - round_up(crop_x, 8) for lanes (unless Rx == crop_x): at window 45
    and m 12, 58 and 56 px."""
    win_w, win_h = params.win_size
    blocked = params.grid_kernel == "blocked"
    mx = (128 - win_w - 1) // 2 if blocked else params.slab_margin_x
    my = params.slab_margin_y
    rx, ry = win_w + 1 + 2 * mx, win_h + 1 + 2 * my
    crop_x, crop_y = win_w + 1 + 2 * m, win_h + 1 + 2 * m
    if not blocked and rx != crop_x:
        crop_x = -(-crop_x // 8) * 8
    slack_x, slack_y = rx - crop_x, ry - crop_y
    if slack_x < 0 or slack_y < 0:
        raise ValueError(f"crop {crop_y}x{crop_x} larger than the {ry}x{rx} slab")
    xs, ys = grid_xy
    base = _slab_bases(axis_key(xs), axis_key(ys), level, (win_w - 1) * 0.5 + mx,
                       (win_h - 1) * 0.5 + my, tl0.device)
    # stream-major points: each stream's rows meet the one grid's bases
    n = base.shape[0]
    raw = (torch.floor(tl0).to(torch.int32).view(-1, n, 2) - base - m).view(-1, 2)
    fits = (raw[:, 0] >= 0) & (raw[:, 0] <= slack_x) & (raw[:, 1] >= 0) & (raw[:, 1] <= slack_y)
    off = torch.stack([raw[:, 0].clamp(0, slack_x), raw[:, 1].clamp(0, slack_y)], dim=-1)
    return (base + off.view(-1, n, 2)).view(-1, 2), fits


def level_inputs(
    prev_prep: PreparedFrame,
    next_prep: PreparedFrame,
    grid_xy: tuple,
    next_center: torch.Tensor,
    level: int,
    params: LKParams,
) -> tuple[tuple, dict]:
    """The arguments of `lk_level` (all but status0) for one level of the
    grid path: templates at the grid points of `prev_prep`, search in
    `next_prep` from `next_center`. With a stream axis, next_center holds
    the streams' points stream-major. Returns ((tmpl, plane_p, pad, tl0,
    crop_org), keyword arguments)."""
    xs, ys = grid_xy
    win_w, win_h = params.win_size
    pad = _frame_pad(params)
    img_prev_p = prev_prep.img_p[level]
    h = img_prev_p.shape[-2] - 2 * pad
    w = img_prev_p.shape[-1] - 2 * pad
    tmpl = grid_templates(img_prev_p, prev_prep.dix_p[level], prev_prep.diy_p[level], xs, ys, level,
                          win_w, win_h, pad)

    tl0 = next_center - _halfwin(params, next_center.device)
    if _anchored(level, params):
        geometry = "anchored"
        m = params.iter_margin_top if level == params.max_level else params.iter_margin
        crop_org, active0 = _anchored_crops(tl0, grid_xy, level, m, params)
    else:
        geometry, active0 = "centred", None
        if level == params.max_level:
            # the top-level init is the grid anchor: the crop is anchored there
            m = params.iter_margin_top
        else:
            # init-centred crop; wild inits are clipped just enough to keep
            # the crop inside the padded plane (they stay beyond the oob gate)
            m = params.rescue_margin
            tl0 = torch.stack(
                [
                    torch.clamp(tl0[:, 0], -(win_w + 2.0), w + 2.0),
                    torch.clamp(tl0[:, 1], -(win_h + 2.0), h + 2.0),
                ],
                dim=-1,
            )
        crop_org = torch.floor(tl0).to(torch.int32) - m
    statics = dict(
        m=m, win_w=win_w, win_h=win_h, level_w=w, level_h=h,
        max_iters=params.max_iters, eps2=float(max(params.eps, 0.0) ** 2),
        is_level0=(level == 0), min_eig_threshold=params.min_eig_threshold,
        geometry=geometry, active0=active0,
    )
    return (tmpl, next_prep.img_p[level], pad, tl0.contiguous(), crop_org), statics


def _level0_err(
    plane_p: torch.Tensor,
    next_tl: torch.Tensor,
    iw: torch.Tensor,
    status: torch.Tensor,
    pad: int,
    params: LKParams,
) -> torch.Tensor:
    """OpenCV's err: mean |window at next_tl - template image iw|, 0 where
    status is false (JAX ops/lk.py:364-369, 645-653, 683-690)."""
    win_w, win_h = params.win_size
    jw = extract_patches(plane_p, next_tl + float(pad), win_h, win_w)
    err = (jw - iw).abs().sum(dim=(1, 2)) / (win_w * win_h)
    return torch.where(status, err, torch.zeros_like(err))


def _level_lk_static_grid(
    prev_prep: PreparedFrame,
    next_prep: PreparedFrame,
    grid_xy: tuple,
    next_center: torch.Tensor,
    status: torch.Tensor,
    level: int,
    params: LKParams,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """One level of the grid path. Returns (next_center,
    status, err), err None except at level 0 with compute_err."""
    args, statics = level_inputs(
        prev_prep, next_prep, grid_xy, next_center, level, params
    )
    next_tl, status = lk_level(*args, status, **statics)
    err = None
    if level == 0 and params.compute_err:
        tmpl, plane_p, pad = args[:3]
        err = _level0_err(plane_p, next_tl, tmpl[:, 0], status, pad, params)
    return next_tl + _halfwin(params, next_tl.device), status, err


def point_level_inputs(
    prev_prep: PreparedFrame,
    next_prep: PreparedFrame,
    pts: torch.Tensor,
    next_center: torch.Tensor,
    level: int,
    params: LKParams,
) -> tuple[tuple, dict, torch.Tensor]:
    """The arguments of `lk_level` (all but status0) for one level of the
    arbitrary-point path: templates at pts / 2^level in `prev_prep`
    (zeroed where the template window lies outside the frame), search in
    `next_prep` from `next_center`. With a stream axis, pts and
    next_center hold the streams' points stream-major. Returns ((tmpl,
    plane_p, pad, tl0, crop_org), keyword arguments, template image) — the
    last unzeroed, for err."""
    win_w, win_h = params.win_size
    pad = _frame_pad(params)
    halfwin = _halfwin(params, pts.device)
    img_prev_p = prev_prep.img_p[level]
    h = img_prev_p.shape[-2] - 2 * pad
    w = img_prev_p.shape[-1] - 2 * pad

    tmpl_tl = pts * (1.0 / (1 << level)) - halfwin
    it = torch.floor(tmpl_tl)
    oob_tmpl = (it[:, 0] < -win_w) | (it[:, 0] >= w) | (it[:, 1] < -win_h) | (it[:, 1] >= h)
    planes = torch.stack([img_prev_p, prev_prep.dix_p[level], prev_prep.diy_p[level]], dim=-3)
    tmpl = extract_patches_multi(planes, tmpl_tl + float(pad), win_h, win_w, quantize=True)
    # the spectral gate rejects a zero template: at level 0 its status dies
    tmpl_k = torch.where(oob_tmpl[:, None, None, None], torch.zeros_like(tmpl), tmpl)

    m = _point_margin(params)
    tl0 = next_center - halfwin
    if not params.points_lanes and params.slab_margin is None:
        geometry, m = "exact", 0
    elif params.points_lanes:
        # init-centred crop; wild inits are clipped just enough to keep the
        # crop inside the padded plane (they stay beyond the oob gate)
        geometry = "centred"
        tl0 = torch.stack(
            [
                torch.clamp(tl0[:, 0], -(win_w + 2.0), w + 2.0),
                torch.clamp(tl0[:, 1], -(win_h + 2.0), h + 2.0),
            ],
            dim=-1,
        )
    else:
        geometry = "v1"
    crop_org = torch.floor(tl0).to(torch.int32) - m  # (unused in "exact")
    statics = dict(
        m=m, win_w=win_w, win_h=win_h, level_w=w, level_h=h,
        max_iters=params.max_iters, eps2=float(max(params.eps, 0.0) ** 2),
        is_level0=(level == 0), min_eig_threshold=params.min_eig_threshold,
        geometry=geometry,
    )
    args = (tmpl_k, next_prep.img_p[level], pad, tl0.contiguous(), crop_org)
    return args, statics, tmpl[:, 0]


def _level_lk(
    prev_prep: PreparedFrame,
    next_prep: PreparedFrame,
    pts: torch.Tensor,
    next_center: torch.Tensor,
    status: torch.Tensor,
    level: int,
    params: LKParams,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """One level of the arbitrary-point path. Returns (next_center,
    status, err), err None except at level 0, where the JAX package
    computes it whatever compute_err says (its ops/lk.py:364-369,
    408-413, 483-488)."""
    args, statics, iw = point_level_inputs(prev_prep, next_prep, pts, next_center, level, params)
    next_tl, status = lk_level(*args, status, **statics)
    err = None
    if level == 0:
        err = _level0_err(args[1], next_tl, iw, status, args[2], params)
    return next_tl + _halfwin(params, next_tl.device), status, err


def pyr_lk(
    img_prev: torch.Tensor,
    img_next: torch.Tensor,
    pts: torch.Tensor,
    params: LKParams = LKParams(),
) -> LKResult:
    """Track pts (N, 2) [x, y] from img_prev to img_next ((H, W) grayscale
    in [0, 255], or (B, H, W): the same points in every stream, results
    (B, N, ...)). With params.grid_step set, pts must be
    measurement_grid(H, W, params.grid_step)."""
    prep_prev = prepare_frame(img_prev, params)
    prep_next = prepare_frame(img_next, params)
    return pyr_lk_prepared(prep_prev, prep_next, pts, params)


def pyr_lk_prepared(
    prep_prev: PreparedFrame,
    prep_next: PreparedFrame,
    pts: torch.Tensor,
    params: LKParams = LKParams(),
) -> LKResult:
    """pyr_lk over frames prepared with prepare_frame (the video form).
    Frames with a stream axis B track pts (N, 2) in every stream, as B * N
    stream-major points, and give results of shape (B, N, ...)."""
    _check_params(params)
    pts = pts.to(torch.float32)
    n_pts = pts.shape[0]
    streams = prep_prev.img_p[0].shape[0] if prep_prev.img_p[0].dim() == 3 else None
    if streams is not None:
        pts = pts.repeat(streams, 1)  # stream-major: stream b's rows b*N ..
    if params.grid_step is not None:
        pad = _frame_pad(params)
        h = prep_prev.img_p[0].shape[-2] - 2 * pad
        w = prep_prev.img_p[0].shape[-1] - 2 * pad
        grid_xy = _grid_axes(h, w, params.grid_step)
        n_grid = len(grid_xy[0]) * len(grid_xy[1])
        if n_grid != n_pts:
            raise ValueError(
                f"pts must be measurement_grid({h}, {w}, {params.grid_step}): "
                f"expected {n_grid} points, got {n_pts}"
            )

        def level_step(center, status, level):
            return _level_lk_static_grid(prep_prev, prep_next, grid_xy, center, status, level, params)
    else:

        def level_step(center, status, level):
            return _level_lk(prep_prev, prep_next, pts, center, status, level, params)

    status = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    next_center = pts * (1.0 / (1 << params.max_level))
    for level in range(params.max_level, -1, -1):
        if level != params.max_level:
            next_center = next_center * 2.0
        next_center, status, err = level_step(next_center, status, level)
    if err is None:
        err = torch.zeros(pts.shape[0], dtype=torch.float32, device=pts.device)
    res = LKResult(next_pts=next_center, status=status, err=err)
    if streams is not None:
        res = LKResult(*(f.reshape(streams, n_pts, *f.shape[1:]) for f in res))
    return res
