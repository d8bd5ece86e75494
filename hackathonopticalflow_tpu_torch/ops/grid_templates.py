"""The grid LK path's templates: the CUDA kernel `grid_templates`
(csrc/grid_templates.cu) and its plain PyTorch version
`grid_templates_reference`.

Port of what the JAX package computes in XLA, not Pallas,
in hackathonopticalflow_tpu/ops/grid_patch.py::extract_grid_templates_lanes
(the TPU layout, points on lanes and i16 x32 storage, is dropped). Contract,
per point of the static measurement grid, at `level`:

- the window's top-left is pts / 2^level - halfwin; per grid row and
  column, its integer origin in the padded planes and its float32 fraction
  are made on the host in float64 (`template_index`, cached per device);
- per plane (image, d/dx, d/dy), rows are blended in y first,
  p[y] * (1 - fy) + p[y+1] * fy, then columns in x, r[x] * (1 - fx) +
  r[x+1] * fx, then quantized to floor(v * 32 + 0.5) * (1 / 32);
- the result is (B * Kx * Ky, 3, win_h, win_w), point k = ix * Ky + iy
  (x-major), stream-major with a stream axis.

This blend order is not `patch_bilinear`'s (weights formed first), and the
two differ in the last bit. The kernel rounds every product and sum on its
own (-fmad=false), as the separate PyTorch ops below do, so the two agree
bit for bit. The three planes come in as three tensors: no stack is made.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

MAX_LANES = 128  # threads per block, at most (csrc/grid_templates.cu)
EPT = 8  # outputs per thread per pass
MAX_STREAMS = 65535 // 3  # the launch grid's z: stream and plane


def launch_shape(win_w: int, win_h: int) -> int:
    """Threads per block (`lanes`) at a win_w x win_h window: the least
    power of two in [32, MAX_LANES] whose EPT outputs a thread cover the
    window in one pass, else MAX_LANES (several passes)."""
    lanes = 32
    while lanes < MAX_LANES and lanes * EPT < win_w * win_h:
        lanes *= 2
    return lanes


def _axis_bases(coords: np.ndarray, level: int, off: float):
    """Per-coordinate integer window origins + float32 fractional offsets
    (float64 on the host, as the JAX extractor computes them)."""
    pos = np.asarray(coords, np.float64) / (1 << level) - off
    base = np.floor(pos).astype(np.int64)
    return base, (pos - base).astype(np.float32)


def axis_key(coords) -> tuple:
    """Grid axis coordinates as a hashable tuple of ints (a cache key)."""
    return coords if isinstance(coords, tuple) else tuple(int(v) for v in coords)


class TemplateIndex(NamedTuple):
    """Where the grid's windows lie in the padded planes, on one device."""

    y0: torch.Tensor  # (Ky,) int32 origin rows
    fy: torch.Tensor  # (1, Ky, 1, 1) float32 y fractions
    x0: torch.Tensor  # (Kx,) int32 origin columns
    fx: torch.Tensor  # (1, 1, 1, Kx, 1) float32 x fractions
    rows: torch.Tensor  # (Ky, win_h+1) int64: the rows each window reads
    cols: torch.Tensor  # (Kx, win_w+1) int64: the columns
    reach_y: tuple  # (first, last) plane row any window reads
    reach_x: tuple  # (first, last) plane column


@functools.lru_cache(maxsize=64)
def template_index(
    xs: tuple, ys: tuple, level: int, win_w: int, win_h: int, pad: int, device: torch.device
) -> TemplateIndex:
    """The grid templates' origins and fractions on `device`. Made once per
    grid, level, window, pad and device: built from the host at every level
    they cost a pageable copy and a stream sync each."""
    by, fy = _axis_bases(ys, level, (win_h - 1) * 0.5)
    bx, fx = _axis_bases(xs, level, (win_w - 1) * 0.5)
    by, bx = by + pad, bx + pad
    y0 = torch.as_tensor(by.astype(np.int32), device=device)
    x0 = torch.as_tensor(bx.astype(np.int32), device=device)
    return TemplateIndex(
        y0=y0,
        fy=torch.as_tensor(fy, device=device).reshape(1, -1, 1, 1),
        x0=x0,
        fx=torch.as_tensor(fx, device=device).reshape(1, 1, 1, -1, 1),
        rows=y0.to(torch.int64)[:, None] + torch.arange(win_h + 1, device=device),
        cols=x0.to(torch.int64)[:, None] + torch.arange(win_w + 1, device=device),
        reach_y=(int(by.min()), int(by.max()) + win_h),
        reach_x=(int(bx.min()), int(bx.max()) + win_w),
    )


def grid_templates_reference(
    img: torch.Tensor,
    dix: torch.Tensor,
    diy: torch.Tensor,
    xs,
    ys,
    level: int,
    win_w: int,
    win_h: int,
    pad: int,
) -> torch.Tensor:
    """Plain PyTorch version of `grid_templates`; same arguments and
    result: the planes stacked, a row gather, the y blend, a column gather,
    the x blend, the rounding and a permute to the points' order."""
    idx = template_index(axis_key(xs), axis_key(ys), level, win_w, win_h, pad, img.device)
    planes = torch.stack([img, dix, diy], dim=-3)
    rows = planes[..., idx.rows, :]  # ([B,] 3, Ky, win_h+1, Wp)
    rows = rows[..., :win_h, :] * (1 - idx.fy) + rows[..., 1:, :] * idx.fy
    cols = rows[..., idx.cols]  # ([B,] 3, Ky, win_h, Kx, win_w+1)
    wnd = cols[..., :win_w] * (1 - idx.fx) + cols[..., 1:] * idx.fx
    wnd = torch.floor(wnd * 32.0 + 0.5) * (1.0 / 32.0)
    # ([B,] 3, Ky, win_h, Kx, win_w) -> ([B,] Kx, Ky, 3, win_h, win_w), x-major
    lead = wnd.dim() - 5
    out = wnd.permute(*range(lead), lead + 3, lead + 1, lead, lead + 2, lead + 4)
    return out.reshape(-1, 3, win_h, win_w).contiguous()


def _check(img: torch.Tensor, dix: torch.Tensor, diy: torch.Tensor, idx: TemplateIndex,
           win_w: int, win_h: int) -> None:
    if img.dim() not in (2, 3):
        raise ValueError(f"planes must be (Hp, Wp) or (B, Hp, Wp), got shape {tuple(img.shape)}")
    for name, t in (("img", img), ("dix", dix), ("diy", diy)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected torch.float32")
        if t.shape != img.shape:
            raise ValueError(f"{name} is {tuple(t.shape)}, img {tuple(img.shape)}")
        if t.device != img.device:
            raise ValueError(f"{name} is on {t.device}, img on {img.device}")
        if t.stride(-1) != 1 or t.stride(-2) != t.shape[-1]:
            raise ValueError(f"{name}'s rows must be contiguous, got strides {t.stride()}")
        if t.dim() == 3 and t.shape[0] > 1 and t.stride(0) != img.stride(0):
            raise ValueError(f"{name}'s streams are {t.stride(0)} floats apart, img's {img.stride(0)}")
    hp, wp = img.shape[-2:]
    if win_w < 1 or win_h < 1:
        raise ValueError(f"empty window {win_h}x{win_w}")
    if img.dim() == 3 and not 1 <= img.shape[0] <= MAX_STREAMS:
        raise ValueError(f"{img.shape[0]} streams: a launch takes 1 to {MAX_STREAMS}")
    if idx.reach_y[0] < 0 or idx.reach_y[1] >= hp or idx.reach_x[0] < 0 or idx.reach_x[1] >= wp:
        raise ValueError(f"the windows read rows {idx.reach_y} and columns {idx.reach_x}, "
                         f"outside the {hp}x{wp} planes")


def _lib():
    from ..kernels import load

    lib = load("grid_templates")
    fn = lib.grid_templates_launch
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, i, ll, i, p, p, i, p, p, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
        occ = lib.grid_templates_occupancy
        occ.argtypes = [i, p, p, p]
        occ.restype = ctypes.c_int
    return lib


def grid_templates(
    img: torch.Tensor,
    dix: torch.Tensor,
    diy: torch.Tensor,
    xs,
    ys,
    level: int,
    win_w: int,
    win_h: int,
    pad: int,
) -> torch.Tensor:
    """The grid templates of one level. img, dix, diy: the padded level
    planes (image, d/dx, d/dy), float32 (Hp, Wp), or (B, Hp, Wp) with one
    plane per stream (each plane's rows contiguous; the three alike); xs,
    ys: the grid's full-resolution axis coordinates. Returns (Kx*Ky, 3,
    win_h, win_w), point k = ix*Ky + iy; with a stream axis (B*Kx*Ky, 3,
    win_h, win_w), stream-major.

    CPU tensors run `grid_templates_reference`; CUDA tensors launch the
    kernel on the current stream (counted in `grid_templates.launches`) or
    raise."""
    dev = img.device
    idx = template_index(axis_key(xs), axis_key(ys), level, win_w, win_h, pad, dev)
    _check(img, dix, diy, idx, win_w, win_h)
    if dev.type == "cpu":
        return grid_templates_reference(img, dix, diy, xs, ys, level, win_w, win_h, pad)
    if dev.type != "cuda":
        raise ValueError(f"grid_templates runs on cpu or cuda tensors, not {dev.type}")
    nb = img.shape[0] if img.dim() == 3 else 1
    sstride = img.stride(0) if img.dim() == 3 else 0
    ky, kx = idx.y0.shape[0], idx.x0.shape[0]
    out = torch.empty((nb * kx * ky, 3, win_h, win_w), dtype=torch.float32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.grid_templates_launch(
            img.data_ptr(), dix.data_ptr(), diy.data_ptr(), nb, sstride, img.shape[-1],
            idx.y0.data_ptr(), idx.fy.data_ptr(), ky, idx.x0.data_ptr(), idx.fx.data_ptr(), kx,
            win_h, win_w, launch_shape(win_w, win_h), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"grid_templates launch failed: cudaError {rc}")
    grid_templates.launches += 1
    return out


grid_templates.launches = 0


def kernel_variants() -> list[dict]:
    """Registers per thread, threads per block and resident blocks and
    warps per SM of the kernel at the grid path's windows (45 x 45, the
    pathfinder's; 15 x 15). Needs the CUDA toolkit and a GPU."""
    lib = _lib()
    out = []
    for win in (45, 15):
        lanes = launch_shape(win, win)
        vals = [ctypes.c_int() for _ in range(3)]
        rc = lib.grid_templates_occupancy(lanes, *[ctypes.addressof(v) for v in vals])
        if rc != 0:
            raise RuntimeError(f"grid_templates_occupancy failed: cudaError {rc}")
        blocks, regs, local = (v.value for v in vals)
        out.append(dict(label=f"window {win}x{win}", threads=lanes, blocks_per_sm=blocks,
                        warps_per_sm=blocks * lanes // 32, regs=regs, local_bytes=local))
    return out
