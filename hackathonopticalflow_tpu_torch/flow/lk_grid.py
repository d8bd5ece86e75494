"""Grid-point LK flow with radial normalization and robust filtering: the
reference's `get_flow_lk` loop (pathfinder_viewer.py:144-193). Port of
hackathonopticalflow_tpu/flow/lk_grid.py.

1. backward pyramidal LK: flow measured current -> previous frame;
2. magnitude/angle; radial normalization m / (5 + sqrt(dist)) * 30;
3. reconstructed endpoints, reference rounding int32(x + 0.5);
4. robust mask median*1.0 < m < P99.
All points are returned with a good/bad mask (no ragged compaction).

Frames may carry a stream axis: (B, H, W) frames and one shared (N, 2)
grid give fields of shape (B, N, ...), each stream's as its own call gives
it (the statistics of step 4 per stream), from one LK launch per level for
all streams; that is what `jax.vmap` of the JAX function computes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core import FilterParams, LKParams, NormalizeParams
from ..nav.filter import robust_mask
from ..nav.normalize import radial_normalize
from ..ops.lk import PreparedFrame, _frame_pad, prepare_frame, pyr_lk, pyr_lk_prepared
from ..utils.graphs import graphed
from .device import resolve_device


class GridFlowResult(NamedTuple):
    # shapes of one stream; a stream-batched call prefixes (B,)
    raw_next_pts: torch.Tensor  # (N, 2) float32 — LK output before normalize
    flow: torch.Tensor  # (N, 2) int32 — normalized rounded endpoint - point
    next_pts: torch.Tensor  # (N, 2) int32 — normalized rounded endpoints
    pts: torch.Tensor  # (N, 2) int32 — rounded measurement points
    modulus: torch.Tensor  # (N,) float32 — normalized magnitudes
    ang: torch.Tensor  # (N,) float32 — flow angles
    good: torch.Tensor  # (N,) bool — passed the robust filter
    status: torch.Tensor  # (N,) bool — LK track status


def _round_ref(x: torch.Tensor) -> torch.Tensor:
    """np.int32(x + 0.5) parity: add 0.5 then truncate toward zero."""
    return torch.trunc(x + 0.5).to(torch.int32)


def pack_grid_result(res: GridFlowResult) -> torch.Tensor:
    """Flatten a batched GridFlowResult (leading axes L: T steps, and a
    stream axis if any) into one (*L, 10*N) float32 tensor, so a consumer
    copies ONE buffer to the host per chunk. `pts` is left out: it is the
    constant grid the caller holds. int32 fields round-trip through f32,
    exact for |v| < 2^24."""
    lead = res.modulus.shape[:-1]
    f32 = torch.float32
    return torch.cat(
        [
            res.raw_next_pts.reshape(*lead, -1),
            res.flow.to(f32).reshape(*lead, -1),
            res.next_pts.to(f32).reshape(*lead, -1),
            res.modulus,
            res.ang,
            res.good.to(f32),
            res.status.to(f32),
        ],
        dim=-1,
    )


def unpack_grid_result(packed: np.ndarray, pts_i: np.ndarray) -> GridFlowResult:
    """Host-side inverse of pack_grid_result: `packed` is the (*L, 10*N)
    array on the host, `pts_i` the (N, 2) int32 rounded grid. Fields are
    numpy arrays of shape (*L, N, ...)."""
    lead = packed.shape[:-1]
    n = pts_i.shape[0]
    o = [0, 2 * n, 4 * n, 6 * n, 7 * n, 8 * n, 9 * n, 10 * n]
    return GridFlowResult(
        raw_next_pts=packed[..., o[0] : o[1]].reshape(*lead, n, 2),
        flow=packed[..., o[1] : o[2]].reshape(*lead, n, 2).astype(np.int32),
        next_pts=packed[..., o[2] : o[3]].reshape(*lead, n, 2).astype(np.int32),
        pts=np.ascontiguousarray(np.broadcast_to(pts_i, (*lead, n, 2))),
        modulus=packed[..., o[3] : o[4]],
        ang=packed[..., o[4] : o[5]],
        good=packed[..., o[5] : o[6]] != 0.0,
        status=packed[..., o[6] : o[7]] != 0.0,
    )


def _post_lk(
    res,
    pts: torch.Tensor,
    h: int,
    w: int,
    norm: NormalizeParams,
    filt: FilterParams,
) -> GridFlowResult:
    """Radial normalization + robust filtering + reference rounding
    (pathfinder_viewer.py:159-176) applied to an LK result of shape
    ([B,] N, ...); the (N, 2) points are shared by the streams."""
    half_w = int(w / 2)
    half_h = int(h / 2)
    flow_raw = res.next_pts - pts
    fx, fy = flow_raw[..., 0], flow_raw[..., 1]
    x, y = pts[:, 0], pts[:, 1]
    ang = torch.atan2(fy, fx)
    modulus = torch.sqrt(fx * fx + fy * fy)
    modulus = radial_normalize(modulus, x, y, half_w, half_h, norm)
    nfx = modulus * torch.cos(ang)
    nfy = modulus * torch.sin(ang)
    next_pts = _round_ref(torch.stack([x + nfx, y + nfy], dim=-1))
    pts_i = _round_ref(pts).expand_as(next_pts)
    good = robust_mask(modulus, filt)
    return GridFlowResult(
        raw_next_pts=res.next_pts,
        flow=next_pts - pts_i,
        next_pts=next_pts,
        pts=pts_i,
        modulus=modulus,
        ang=ang,
        good=good,
        status=res.status,
    )


def lk_grid_flow(
    prev_gray: torch.Tensor,
    gray: torch.Tensor,
    pts: torch.Tensor,
    lk: LKParams = LKParams(),
    norm: NormalizeParams = NormalizeParams(),
    filt: FilterParams = FilterParams(),
    device: torch.device | str = "cuda",
) -> GridFlowResult:
    """prev_gray/gray: (H, W) grayscale in [0, 255] (uint8 welcome: they
    move to `device` as they are and are cast there), or (B, H, W), one
    frame per stream; pts: (N, 2), shared by the streams. Fields are (N,
    ...) or (B, N, ...). Runs on the GPU unless device="cpu", as one
    captured graph a call (`_pair_flow`)."""
    device = resolve_device(device)
    return _pair_flow(prev_gray.to(device, non_blocking=True), gray.to(device, non_blocking=True),
                      pts.to(device=device, dtype=torch.float32), lk, norm, filt)


@graphed
def _pair_flow(prev_gray, gray, pts, lk, norm, filt) -> GridFlowResult:
    """lk_grid_flow's device work."""
    prev_gray = prev_gray.to(torch.float32)
    gray = gray.to(torch.float32)
    h, w = gray.shape[-2:]
    # backward flow: track grid points from the current frame into the
    # previous one
    res = pyr_lk(gray, prev_gray, pts, lk)
    return _post_lk(res, pts, h, w, norm, filt)


def lk_grid_flow_video(
    frames: torch.Tensor,
    pts: torch.Tensor,
    lk: LKParams = LKParams(),
    norm: NormalizeParams = NormalizeParams(),
    filt: FilterParams = FilterParams(),
    device: torch.device | str = "cuda",
) -> GridFlowResult:
    """Whole-clip form: (T, H, W) uint8 frames -> GridFlowResult batched
    over the T-1 steps. Frames move to `device` (the GPU unless
    device="cpu") as uint8 and are cast there; each frame's prepared
    pyramid is built once and carried to the next step as the previous
    frame. Each step (`_video_step`) runs as one captured graph on the
    GPU, the carried levels copied in as its input, as the JAX package's
    scan runs its body."""
    device = resolve_device(device)
    frames = frames.to(device)
    pts = pts.to(device=device, dtype=torch.float32)
    prev_planes = prepare_frame(frames[0], lk).img_p
    steps = []
    for t in range(1, frames.shape[0]):
        res, prev_planes = _video_step(prev_planes, frames[t], pts, lk, norm, filt)
        steps.append(res)
    return GridFlowResult(*(torch.stack(f) for f in zip(*steps)))


def search_frame(planes: tuple) -> PreparedFrame:
    """The previous frame as the grid flow reads it: the backward flow
    searches its padded image levels and takes its templates from the
    current frame, so a clip step carries these levels alone (a third of
    the pyramid's bytes)."""
    return PreparedFrame(img_p=planes, dix_p=(), diy_p=())


@graphed
def _video_step(
    prev_planes: tuple, frame: torch.Tensor, pts: torch.Tensor, lk, norm, filt
) -> tuple[GridFlowResult, tuple]:
    """One step of lk_grid_flow_video: the frame's pyramid and the flow of
    the pair (result, the frame's padded image levels for the next
    step)."""
    cur_prep = prepare_frame(frame, lk)
    res = lk_grid_flow_prepared(search_frame(prev_planes), cur_prep, pts, lk, norm, filt)
    return res, cur_prep.img_p


def lk_grid_flow_prepared(
    prev_prep: PreparedFrame,
    cur_prep: PreparedFrame,
    pts: torch.Tensor,
    lk: LKParams = LKParams(),
    norm: NormalizeParams = NormalizeParams(),
    filt: FilterParams = FilterParams(),
) -> GridFlowResult:
    """lk_grid_flow over frames prepared with `ops/lk.py::prepare_frame`
    (with or without a stream axis), on their device; pts (N, 2) float32
    there. A clip loop prepares each frame once and carries it to the next
    step as the previous frame."""
    pad = _frame_pad(lk)
    h, w = (s - 2 * pad for s in cur_prep.img_p[0].shape[-2:])
    # viewer semantics: the current frame is the LK template source
    res = pyr_lk_prepared(cur_prep, prev_prep, pts, lk)
    return _post_lk(res, pts, h, w, norm, filt)
