"""Dense Farneback flow: the reference's `calculate_optical_flow`
(DenseOF.py:127-157). Port of hackathonopticalflow_tpu/flow/dense.py."""

from __future__ import annotations

import torch

from ..core import FarnebackParams
from ..ops.farneback import COEF_MODES, farneback, farneback_prepared, prepare_frame, resolve_mode
from ..utils.graphs import graphed
from ..utils.profiling import span
from .device import resolve_device


def farneback_flow_video(
    frames: torch.Tensor,
    params: FarnebackParams = FarnebackParams(),
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """(T, H, W) grayscale clip (uint8 welcome) -> (T-1, H, W, 2) float32
    flow of each consecutive pair. Frames move to `device` (the GPU unless
    device="cpu") as they are and are cast there; each frame's prepared
    polynomial pyramid is built once and carried to the next pair, so the
    result equals per-pair farneback() exactly. The coefficient warp
    modes only: "image" and "hybrid" re-expand each frame inside the
    iteration and raise ValueError, as the JAX scan refuses them. Each
    step (`_video_step`) runs as one captured graph on the GPU, the
    carried pyramid copied in as its input, as the JAX scan runs its
    body."""
    params = resolve_mode(params)
    if params.warp_mode not in COEF_MODES:
        raise ValueError(f"farneback_flow_video runs the coefficient warp modes {COEF_MODES}, "
                         f"not {params.warp_mode!r}: call farneback_flow per pair")
    device = resolve_device(device)
    with span("dense.upload"):
        frames = frames.to(device)
    with span("dense.first_frame"):
        prev = prepare_frame(frames[0], params)
    flows = []
    for t in range(1, frames.shape[0]):
        flow, prev = _video_step(prev, frames[t], params)
        flows.append(flow)
    return torch.stack(flows)


@graphed
def _video_step(prev: tuple, frame: torch.Tensor, params: FarnebackParams) -> tuple[torch.Tensor, tuple]:
    """One step of farneback_flow_video: (the pair's flow, the frame's
    pyramid for the next step)."""
    cur = prepare_frame(frame, params)
    return farneback_prepared(prev, cur, params), cur


def farneback_flow(
    prev_gray: torch.Tensor,
    gray: torch.Tensor,
    params: FarnebackParams = FarnebackParams(),
    device: torch.device | str = "cuda",
) -> torch.Tensor:
    """(..., H, W) grayscale pair -> (..., H, W, 2) dense flow in any warp
    mode, on the GPU unless device="cpu", as one captured graph a call
    (`_pair_flow`). Leading batch axes (pairs of several streams, say) run
    as one batch; each row equals the single-pair result."""
    device = resolve_device(device)
    return _pair_flow(prev_gray.to(device, non_blocking=True), gray.to(device, non_blocking=True),
                      resolve_mode(params))


@graphed
def _pair_flow(prev_gray: torch.Tensor, gray: torch.Tensor, params: FarnebackParams) -> torch.Tensor:
    """farneback_flow's device work."""
    return farneback(prev_gray, gray, params)
