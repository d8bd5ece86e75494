"""Shi-Tomasi + forward-backward LK trajectory tracker: the reference's
SparseOF.py:22-92 loop. Port of hackathonopticalflow_tpu/flow/tracker.py.

Per frame: track each live trajectory's head forward with pyramidal LK,
track the result backward, keep the tracks whose forward-backward error
is below fb_max_dist px (SparseOF.py:35-38), append the new head (length
capped at trajectory_len, SparseOF.py:47-48), and every detect_interval-th
frame detect new Shi-Tomasi corners away from live tracks (radius-5
exclusion mask, SparseOF.py:60-73) into free slots.

The state is a fixed-capacity table, as in the JAX package: (max_tracks,
trajectory_len, 2) positions with per-track lengths and liveness; every
slot is tracked every frame. frame_idx is a Python int, so the detection
branch costs no read from the device. On the GPU a step runs as one of
two captured graphs, with detection and without (`utils/graphs.py`; the
JAX package's step takes the branch with lax.cond).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import TrackerParams
from ..ops.features import Corners, good_features_to_track
from ..ops.lk import PreparedFrame, prepare_frame, pyr_lk_prepared
from ..utils.graphs import graphed
from ..utils.profiling import span
from .device import resolve_device


class TrackerState(NamedTuple):
    traj: torch.Tensor  # (T, L, 2) float32 — trajectory positions
    length: torch.Tensor  # (T,) int32 — valid entries per trajectory
    alive: torch.Tensor  # (T,) bool
    frame_idx: int  # frames stepped so far


def init_tracker(params: TrackerParams = TrackerParams(), device: torch.device | str = "cuda") -> TrackerState:
    """An empty track table on `device` (the GPU unless device="cpu"; the
    entry points move a state to theirs)."""
    device = resolve_device(device)
    t, l = params.max_tracks, params.trajectory_len
    return TrackerState(
        traj=torch.zeros((t, l, 2), dtype=torch.float32, device=device),
        length=torch.zeros((t,), dtype=torch.int32, device=device),
        alive=torch.zeros((t,), dtype=torch.bool, device=device),
        frame_idx=0,
    )


def _to(state: TrackerState, device: torch.device) -> TrackerState:
    return state._replace(
        traj=state.traj.to(device), length=state.length.to(device), alive=state.alive.to(device)
    )


def _heads(state: TrackerState) -> torch.Tensor:
    """Last valid point of each trajectory (slot 0's entry where empty)."""
    idx = torch.clamp(state.length.to(torch.int64) - 1, 0, state.traj.shape[1] - 1)
    return state.traj[torch.arange(state.traj.shape[0], device=idx.device), idx]


def _detect_mask(heads: torch.Tensor, alive: torch.Tensor, h: int, w: int, radius: int = 5) -> torch.Tensor:
    """(h, w) uint8 mask, 255 except for radius-5 zero discs at live track
    heads (SparseOF.py:61-66)."""
    r = radius
    dev = heads.device
    d = torch.arange(-r, r + 1, device=dev)
    dy, dx = torch.meshgrid(d, d, indexing="ij")
    inside = (dx * dx + dy * dy) <= r * r
    # torch.round, like jnp.round, rounds half to even
    hx = torch.round(heads[:, 0]).to(torch.int64)
    hy = torch.round(heads[:, 1]).to(torch.int64)
    ys = torch.clamp(hy[:, None, None] + dy[None], 0, h - 1)
    xs = torch.clamp(hx[:, None, None] + dx[None], 0, w - 1)
    val = torch.where(alive[:, None, None] & inside[None], 0, 255).to(torch.int32)
    mask = torch.full((h * w,), 255, dtype=torch.int32, device=dev)
    mask = mask.scatter_reduce(0, (ys * w + xs).reshape(-1), val.reshape(-1), "amin")
    return mask.reshape(h, w).to(torch.uint8)


def _append(state: TrackerState, new_heads: torch.Tensor, keep: torch.Tensor) -> TrackerState:
    """Append new_heads to the kept trajectories (shift left at
    capacity); the rest die."""
    t, l = state.traj.shape[:2]
    at_cap = state.length >= l
    shifted = torch.roll(state.traj, -1, dims=1)
    traj = torch.where((keep & at_cap)[:, None, None], shifted, state.traj)
    idx = torch.clamp(torch.where(at_cap, l - 1, state.length), 0, l - 1).to(torch.int64)
    updated = traj.clone()
    updated[torch.arange(t, device=idx.device), idx] = new_heads
    traj = torch.where(keep[:, None, None], updated, traj)
    length = torch.where(keep, torch.clamp(state.length + 1, max=l), state.length)
    return state._replace(traj=traj, length=length, alive=keep)


def _spawn(state: TrackerState, corners: Corners) -> TrackerState:
    """Seed single-point trajectories from the valid corners in the free
    slots, lowest free slot first.

    The JAX package writes the corners it does not take to slot T-1 as
    dummy rows carrying that slot's old values; when slot T-1 is itself
    taken, the rows collide in one scatter. Here the untaken rows go to a
    spare row past the table, which is then dropped: only taken rows are
    written."""
    t = state.traj.shape[0]
    dev = state.traj.device
    order = torch.argsort(state.alive.to(torch.int32), stable=True)  # free slots first
    n_free = (~state.alive).sum()
    k = corners.pts.shape[0]
    take = corners.valid & (torch.arange(k, device=dev) < n_free)
    slot = torch.where(take, order[:k], t)
    traj = torch.cat([state.traj, state.traj.new_zeros((1,) + state.traj.shape[1:])])
    length = torch.cat([state.length, state.length.new_zeros(1)])
    alive = torch.cat([state.alive, state.alive.new_zeros(1)])
    traj[slot, 0] = corners.pts
    # index_fill_ takes the value as a kernel argument: no host copy
    length.index_fill_(0, slot, 1)
    alive.index_fill_(0, slot, True)
    return state._replace(traj=traj[:t], length=length[:t], alive=alive[:t])


def track_step_prepared(
    state: TrackerState,
    prev_prep: PreparedFrame,
    cur_prep: PreparedFrame,
    gray: torch.Tensor,
    params: TrackerParams = TrackerParams(),
) -> TrackerState:
    """track_step over frames prepared with ops.lk.prepare_frame (the form
    track_video runs, so each frame is prepared once). gray: the current
    (H, W) float32 frame, for detection; all on one device."""
    detect = state.frame_idx % params.detect_interval == 0
    traj, length, alive = _step_graph(state.traj, state.length, state.alive, prev_prep, cur_prep, gray, params,
                                      detect)
    return TrackerState(traj, length, alive, state.frame_idx + 1)


def _step(traj, length, alive, prev_prep, cur_prep, gray, params: TrackerParams, detect: bool):
    """track_step_prepared on the state's tensors: (traj, length, alive)
    after the step; `detect` says whether this frame detects."""
    state = TrackerState(traj, length, alive, 0)
    h, w = gray.shape
    heads = _heads(state)
    p1 = pyr_lk_prepared(prev_prep, cur_prep, heads, params.lk).next_pts
    p0r = pyr_lk_prepared(cur_prep, prev_prep, p1, params.lk).next_pts
    d = (heads - p0r).abs().amax(dim=-1)
    keep = state.alive & (d < params.fb_max_dist)
    state = _append(state, p1, keep)
    if detect:
        mask = _detect_mask(_heads(state), state.alive, h, w)
        state = _spawn(state, good_features_to_track(gray, params.features, mask=mask))
    return state.traj, state.length, state.alive


def _frame_step(traj, length, alive, prev_prep, frame, params: TrackerParams, detect: bool):
    """track_frame on the state's tensors: (traj, length, alive, the
    frame's pyramid, heads)."""
    img = frame.to(traj.device).to(torch.float32)
    cur_prep = prepare_frame(img, params.lk)
    traj, length, alive = _step(traj, length, alive, prev_prep, cur_prep, img, params, detect)
    return traj, length, alive, cur_prep, _heads(TrackerState(traj, length, alive, 0))


_step_graph = graphed(_step)
_frame_graph = graphed(_frame_step)


def track_frame(
    state: TrackerState,
    prev_prep: PreparedFrame,
    frame: torch.Tensor,
    params: TrackerParams = TrackerParams(),
) -> tuple[TrackerState, PreparedFrame, torch.Tensor]:
    """One step on a new (H, W) frame (uint8 welcome), on the state's
    device: prepares it, tracks from `prev_prep` and returns (the state,
    the frame's prepared pyramid for the next step, the heads (T, 2) after
    the step). It runs as one captured graph on the GPU."""
    detect = state.frame_idx % params.detect_interval == 0
    traj, length, alive, cur_prep, heads = _frame_graph(
        state.traj, state.length, state.alive, prev_prep, frame, params, detect
    )
    return TrackerState(traj, length, alive, state.frame_idx + 1), cur_prep, heads


def track_step(
    state: TrackerState,
    prev_gray: torch.Tensor,
    gray: torch.Tensor,
    params: TrackerParams = TrackerParams(),
    device: torch.device | str = "cuda",
) -> TrackerState:
    """One frame of tracking: forward-backward LK, gated append, periodic
    re-detection. Frames (H, W) in [0, 255] (uint8 welcome) and the state
    move to `device` (the GPU unless device="cpu")."""
    device = resolve_device(device)
    prev_gray = prev_gray.to(device).to(torch.float32)
    gray = gray.to(device).to(torch.float32)
    prev_prep = prepare_frame(prev_gray, params.lk)
    cur_prep = prepare_frame(gray, params.lk)
    return track_step_prepared(_to(state, device), prev_prep, cur_prep, gray, params)


def track_video(
    frames: torch.Tensor,
    params: TrackerParams = TrackerParams(),
    state: TrackerState | None = None,
    device: torch.device | str = "cuda",
) -> tuple[TrackerState, tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """track_step over a clip (F, H, W) (uint8 welcome), frames[0] ->
    frames[1] first; each frame's prepared pyramid is built once and
    carried to the next step. Seed detections by stepping (f0, f0) first,
    as the JAX package's callers do. Returns the final state and per-step
    history (heads (F-1, T, 2), alive (F-1, T), length (F-1, T)).
    Everything moves to `device` (the GPU unless device="cpu").

    Under a torch.profiler it records the spans `tracker.upload` (the
    frames' copy to the device), `tracker.first_frame` (frames[0]'s eager
    pyramid) and, a step each, `tracker.step.detect` or
    `tracker.step.track` keyed by the state's frame index before the
    step (utils/profiling.py::span)."""
    device = resolve_device(device)
    with span("tracker.upload"):
        frames = frames.to(device)
    state = init_tracker(params, device) if state is None else _to(state, device)
    with span("tracker.first_frame"):
        prev_prep = prepare_frame(frames[0].to(torch.float32), params.lk)
    heads, alive, length = [], [], []
    for t in range(1, frames.shape[0]):
        detect = state.frame_idx % params.detect_interval == 0
        with span("tracker.step.detect" if detect else "tracker.step.track", state.frame_idx):
            state, prev_prep, h = track_frame(state, prev_prep, frames[t], params)
        heads.append(h)
        alive.append(state.alive)
        length.append(state.length)
    return state, (torch.stack(heads), torch.stack(alive), torch.stack(length))
