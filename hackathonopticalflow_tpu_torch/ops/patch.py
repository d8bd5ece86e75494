"""Window sampling: bilinear windows at arbitrary points (port of
hackathonopticalflow_tpu/ops/patch.py's extract_patches,
extract_patches_multi and blend_bilinear, through the `patch_bilinear`
kernel), integer-origin slabs (its extract_slabs and extract_slabs_rect,
through the `gather_rects` kernel), windows at integer offsets inside
per-point slabs (its select_windows, plain torch as JAX's is XLA). The
windows at the static measurement grid are `ops/grid_templates.py`'s.

The TPU layouts (128-lane padding, points on lanes, i16 x32 storage, DMA
panels) are dropped: windows are (N, [C,] h, w) float32."""

from __future__ import annotations

import torch

from .gather_rects import gather_rects
from .patch_bilinear import blend_bilinear, patch_bilinear

__all__ = [
    "blend_bilinear",
    "extract_patches",
    "extract_patches_multi",
    "extract_slabs",
    "extract_slabs_rect",
    "select_windows",
]


def extract_patches(img: torch.Tensor, top_left: torch.Tensor, size_h: int, size_w: int) -> torch.Tensor:
    """(N, size_h, size_w) windows of img (H, W) float32 at fractional
    top-lefts (N, 2) [x, y]; img (B, H, W) takes stream-major points (N / B
    per stream). img is padded by the caller so that every window lies
    inside; out-of-range origins clamp as XLA's dynamic_slice clamps them.
    CPU tensors take the plain version, CUDA tensors the `patch_bilinear`
    kernel."""
    return patch_bilinear(img.unsqueeze(-3).contiguous(), top_left.contiguous(), size_h, size_w, False)[:, 0]


def extract_patches_multi(
    imgs: torch.Tensor, top_left: torch.Tensor, size_h: int, size_w: int, quantize: bool = False
) -> torch.Tensor:
    """(N, C, size_h, size_w) windows of a (C, H, W) stack at shared
    fractional top-lefts, or of a (B, C, H, W) stack per stream at
    stream-major points; with `quantize`, on the 1/32 W_BITS grid (the JAX
    package's _fix of the LK templates, fused into the kernel)."""
    return patch_bilinear(imgs.contiguous(), top_left.contiguous(), size_h, size_w, quantize)


def extract_slabs_rect(img: torch.Tensor, top_left_int: torch.Tensor, size_h: int, size_w: int) -> torch.Tensor:
    """(N, size_h, size_w) integer-aligned slabs of img (H, W) float32 at
    origins (N, 2) int32 [x, y], placed as XLA's dynamic_slice places them.
    CPU tensors take the plain version, CUDA tensors the `gather_rects`
    kernel."""
    return gather_rects(img.contiguous(), top_left_int.contiguous(), size_h, size_w)


def extract_slabs(img: torch.Tensor, top_left_int: torch.Tensor, size: int) -> torch.Tensor:
    """(N, size, size) slabs: extract_slabs_rect with a square."""
    return extract_slabs_rect(img, top_left_int, size, size)


def select_windows(
    slabs: torch.Tensor, offsets: torch.Tensor, win_h: int, win_w: int, margin2: int
) -> torch.Tensor:
    """(N, win_h+1, win_w+1) windows of per-point slabs (N, S, S) at
    integer offsets (N, 2) [ox, oy], each clipped to [0, margin2]: what
    the JAX package's masked static slices compute, by indexing. The
    result adds 0.0 as that sum of masked slices does (-0.0 becomes
    +0.0)."""
    n = slabs.shape[0]
    dev = slabs.device
    off = torch.clamp(offsets.to(torch.int64), 0, margin2)
    ys = off[:, 1, None] + torch.arange(win_h + 1, device=dev)
    xs = off[:, 0, None] + torch.arange(win_w + 1, device=dev)
    return slabs[torch.arange(n, device=dev)[:, None, None], ys[:, :, None], xs[:, None, :]] + 0.0
