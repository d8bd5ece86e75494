"""Window sampling: bilinear windows at arbitrary points (port of
hackathonopticalflow_tpu/ops/patch.py's extract_patches,
extract_patches_multi and blend_bilinear, through the `patch_bilinear`
kernel), integer-origin slabs (its extract_slabs and extract_slabs_rect,
through the `gather_rects` kernel), windows at integer offsets inside
per-point slabs (its select_windows, plain torch as JAX's is XLA) and
windows at the static measurement
grid (port of what
hackathonopticalflow_tpu/ops/grid_patch.py::extract_grid_templates_lanes
computes; the JAX package builds that one in XLA, not Pallas).

The TPU layouts (128-lane padding, points on lanes, i16 x32 storage, DMA
panels) are dropped: windows are (N, [C,] h, w) float32."""

from __future__ import annotations

import functools

import numpy as np
import torch

from .gather_rects import gather_rects
from .patch_bilinear import blend_bilinear, patch_bilinear

__all__ = [
    "blend_bilinear",
    "extract_grid_templates",
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


def _axis_bases(coords: np.ndarray, level: int, off: float):
    """Per-coordinate integer window origins + float32 fractional offsets
    (float64 on the host, as the JAX extractor computes them)."""
    pos = np.asarray(coords, np.float64) / (1 << level) - off
    base = np.floor(pos).astype(np.int64)
    return base, (pos - base).astype(np.float32)


def axis_key(coords) -> tuple:
    """Grid axis coordinates as a hashable tuple of ints (a cache key)."""
    return coords if isinstance(coords, tuple) else tuple(int(v) for v in coords)


@functools.lru_cache(maxsize=64)
def _template_index(xs: tuple, ys: tuple, level: int, win_w: int, win_h: int, pad: int, device: torch.device):
    """(rows (Ky, win_h+1), y fractions, columns (Kx, win_w+1), x fractions)
    of the grid templates in the padded planes, on `device`. Made once per
    grid, level, window, pad and device: built from the host at every level
    they cost a pageable copy and a stream sync each."""
    by, fy = _axis_bases(ys, level, (win_h - 1) * 0.5)
    bx, fx = _axis_bases(xs, level, (win_w - 1) * 0.5)
    ry = torch.as_tensor(by + pad, device=device)[:, None] + torch.arange(win_h + 1, device=device)
    cx = torch.as_tensor(bx + pad, device=device)[:, None] + torch.arange(win_w + 1, device=device)
    fyv = torch.as_tensor(fy, device=device).reshape(1, -1, 1, 1)
    fxv = torch.as_tensor(fx, device=device).reshape(1, 1, 1, -1, 1)
    return ry, fyv, cx, fxv


def extract_grid_templates(
    planes: torch.Tensor,
    xs: np.ndarray,
    ys: np.ndarray,
    level: int,
    win_w: int,
    win_h: int,
    pad: int,
) -> torch.Tensor:
    """planes: (3, Hp, Wp) padded level planes (image, d/dx, d/dy), or
    (B, 3, Hp, Wp), one stack per stream.
    xs, ys: the grid's full-resolution axis coordinates.

    Per point, the window at pts / 2^level - halfwin: rows are blended in
    y first, then columns in x, then quantized to floor(v*32 + 0.5)/32.
    Returns (Kx*Ky, 3, win_h, win_w), point k = ix*Ky + iy; with a stream
    axis (B*Kx*Ky, 3, win_h, win_w), stream-major."""
    ry, fyv, cx, fxv = _template_index(axis_key(xs), axis_key(ys), level, win_w, win_h, pad, planes.device)
    rows = planes[..., ry, :]  # ([B,] 3, Ky, win_h+1, Wp)
    rows = rows[..., :win_h, :] * (1 - fyv) + rows[..., 1:, :] * fyv
    cols = rows[..., cx]  # ([B,] 3, Ky, win_h, Kx, win_w+1)
    wnd = cols[..., :win_w] * (1 - fxv) + cols[..., 1:] * fxv
    wnd = torch.floor(wnd * 32.0 + 0.5) * (1.0 / 32.0)
    # ([B,] 3, Ky, win_h, Kx, win_w) -> ([B,] Kx, Ky, 3, win_h, win_w), x-major
    lead = wnd.dim() - 5
    out = wnd.permute(*range(lead), lead + 3, lead + 1, lead, lead + 2, lead + 4)
    return out.reshape(-1, 3, win_h, win_w).contiguous()
