"""Bilinear sample of C channels at absolute coordinates: the CUDA kernel
`warp_bilinear` (csrc/warp_bilinear.cu) and its plain PyTorch version
`warp_bilinear_reference`, in two geometries.

Port of the TPU kernel hackathonopticalflow_tpu/ops/warp_pallas.py::
warp_bilinear_pallas, the Farneback coefficient warp (OpenCV
FarnebackUpdateMatrices' bilinear fetch), and of the exact gather beside
it in hackathonopticalflow_tpu/ops/farneback.py. Per pixel, in both
geometries, the corners and fractions clamp:
x0 = clamp(floor(fx), 0, W-2), y0 = clamp(floor(fy), 0, H-2),
ax = clamp(fx - x0, 0, 1), ay = clamp(fy - y0, 0, 1).

- geometry="gather" (warp_mode "exact", "packed", "hybrid"): the corners at
  (y0, x0); out[c] = v00 (1-ax)(1-ay) + v10 ax(1-ay) + v01 (1-ax)ay +
  v11 ax ay, the weights formed first and the four terms summed in that
  order. Where the caller's `inside` test holds this equals JAX's exact
  gather; elsewhere the caller masks the result.
- geometry="slab" (warp_mode "pallas", "pallas_bf16"): the Pallas
  kernel's function. Its (8, 128) output tiles read one slab at the tile's
  minimum sample, and a sample lying more than 72 rows / 128 columns past
  that minimum clamps to the slab's edge (`slab_origins`); the blend is an
  x-lerp, then a y-lerp: xb0 = (1-ax) t(ys, xs) + ax t(ys, xs+1), xb1 the
  same a row down, out = xb0 (1-ay) + xb1 ay. Within the margins the
  samples are the gather's, in another order of arithmetic.

The source is float32 or bfloat16 (warp_mode "pallas_bf16" rounds it once
per level, as the TPU's bf16 slab); the result is float32. The kernel
rounds every product and sum separately (__fmul_rn/__fadd_rn, -fmad=false),
as the separate PyTorch ops below do, so the two agree bit for bit.

`launch_shape` picks the kernel's launch from the call's shape alone,
among `launch_shapes`, every launch the kernel takes; the CUDA side
refuses any other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

GEOMETRIES = ("gather", "slab")

# the TPU kernel's geometry (warp_pallas.py:58-84): output tile, row and
# column margins, last slab row offset
TH, TW = 8, 128
PADT, PADL = 72, 128
YI_MAX = 80
_SENTINEL = 1 << 30

# the kernel's launch (csrc/warp_bilinear.cu); launch_shape is a pure
# function of the call's shape, so the CPU tests check it without a card
SMS = 132  # streaming multiprocessors of an H100 SXM, the card it fills
THREADS = 256  # gather: a block's pixels; slab: a tile's threads, 4 pixels each
ALL_CHANNELS = 5  # C of the only caller: a block may blend all of them
SPLITS = (1, 2)  # slab: blocks that may share a tile, by rows


class LaunchShape(NamedTuple):
    """One launch of the kernel: a 1-D grid of `grid` blocks; `groups`
    blocks share a set of pixels (1: each blends all 5 channels; C: one
    channel each); in the slab geometry `splits` blocks share a tile, each
    blending 8 / splits of its rows (gather: 1)."""

    grid: int
    groups: int
    splits: int


def blocks_per_plane(h: int, w: int, geometry: str, splits: int = 1) -> int:
    """Blocks over one (h, w) plane's pixels: THREADS pixels a block
    (gather), or `splits` blocks an (8, 128) tile (slab)."""
    if geometry == "slab":
        return -(-h // TH) * -(-w // TW) * splits
    if geometry == "gather":
        return -(-h * w // THREADS)
    raise ValueError(f"geometry must be one of {GEOMETRIES}, got {geometry!r}")


def launch_shapes(b: int, c: int, h: int, w: int, geometry: str) -> list[LaunchShape]:
    """Every launch the kernel takes for a (b, c, h, w) call in
    `geometry`: all 5 channels a block (C = 5 only) or one, and in the
    slab geometry each of SPLITS."""
    groups = (1, c) if c == ALL_CHANNELS else (c,)
    splits = SPLITS if geometry == "slab" else (1,)
    return [LaunchShape(blocks_per_plane(h, w, geometry, s) * b * g, g, s) for g in groups for s in splits]


def launch_shape(b: int, c: int, h: int, w: int, geometry: str) -> LaunchShape:
    """The kernel's launch for a (b, c, h, w) call in `geometry`, the
    fastest of launch_shapes at each level of the 720p dense path
    (chip_smoke.py phases 6 and 18 time them all): blocks blending all 5
    channels of their pixels, unless that leaves fewer blocks than the
    card has SMs; then, and for any other C, one channel a block. A slab
    tile goes to 2 blocks where its blocks would give the SMs at least one
    but fewer than two each (360x640); 2 measured slower at the other
    three levels."""
    n = blocks_per_plane(h, w, geometry) * b
    groups = 1 if c == ALL_CHANNELS and n >= SMS else c
    splits = 2 if geometry == "slab" and SMS <= n * groups < 2 * SMS else 1
    return LaunchShape(n * splits * groups, groups, splits)


def _corners(fx: torch.Tensor, fy: torch.Tensor, h: int, w: int):
    """Clamped float corners x0, y0 and fractions ax, ay."""
    x0 = torch.clamp(torch.floor(fx), 0, w - 2)
    y0 = torch.clamp(torch.floor(fy), 0, h - 2)
    ax = torch.clamp(fx - x0, 0.0, 1.0)
    ay = torch.clamp(fy - y0, 0.0, 1.0)
    return x0, y0, ax, ay


def slab_origins(x0: torch.Tensor, y0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-left sample (ys, xs) of each pixel in the slab geometry, from its
    clamped integer corner (x0, y0), (..., H, W) int64 (warp_pallas.py:
    246-286). Per (8, 128) tile, over its pixels inside the image, the
    minima ymin of y0 + 72 - il and xmin of x0 + 128 - jl (il, jl the
    pixel's row and column in the tile) give the slab's aligned base; rows
    past 80 and columns past 128 from it clamp. Within the margins
    (ys, xs) = (y0, x0); a clamped sample lies between the slab's base and
    (y0, x0), so every corner stays inside the plane."""
    h, w = x0.shape[-2:]
    dev = x0.device
    il = (torch.arange(h, device=dev) % TH)[:, None]
    jl = torch.arange(w, device=dev) % TW
    dy = y0 + (PADT - il)
    dx = x0 + (PADL - jl)
    nty, ntx = -(-h // TH), -(-w // TW)
    pad = (0, ntx * TW - w, 0, nty * TH - h)

    def tile_min(v):
        v = torch.nn.functional.pad(v, pad, value=_SENTINEL)
        v = v.reshape(*v.shape[:-2], nty, TH, ntx, TW).amin(dim=(-3, -1)).clamp_min(0)
        return v.repeat_interleave(TH, -2)[..., :h, :].repeat_interleave(TW, -1)[..., :w]

    ymin, xmin = tile_min(dy), tile_min(dx)
    by = ymin // TH * TH
    bx = xmin // TW * TW
    yi = torch.clamp(dy - by, max=YI_MAX)
    xi = torch.minimum(dx - bx, xmin - bx + PADL)
    return by + yi + il - PADT, bx + xi + jl - PADL


def warp_bilinear_reference(
    src: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor, geometry: str = "gather"
) -> torch.Tensor:
    """Plain PyTorch version of `warp_bilinear`; same arguments and result."""
    h, w = src.shape[-2:]
    x0, y0, ax, ay = _corners(fx, fy, h, w)
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    if geometry == "slab":
        y0, x0 = slab_origins(x0, y0)
    lin = (y0 * w + x0).flatten(-2).unsqueeze(-2)
    flat = src.flatten(-2)  # (..., C, H*W)

    def corner(offset):
        idx = (lin + offset).expand(flat.shape)
        return torch.gather(flat, -1, idx).view(src.shape).to(torch.float32)

    bx, by = 1.0 - ax, 1.0 - ay
    if geometry == "slab":
        ax, ay, bx, by = (t.unsqueeze(-3) for t in (ax, ay, bx, by))
        xb0 = bx * corner(0) + ax * corner(1)
        xb1 = bx * corner(w) + ax * corner(w + 1)
        return xb0 * by + xb1 * ay

    def weight(a, b):
        return (a * b).unsqueeze(-3)

    return (
        corner(0) * weight(bx, by)
        + corner(1) * weight(ax, by)
        + corner(w) * weight(bx, ay)
        + corner(w + 1) * weight(ax, ay)
    )


def _check(src: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor, geometry: str) -> None:
    if geometry not in GEOMETRIES:
        raise ValueError(f"geometry must be one of {GEOMETRIES}, got {geometry!r}")
    if src.dim() < 3:
        raise ValueError(f"src must be (..., C, H, W), got shape {tuple(src.shape)}")
    h, w = src.shape[-2:]
    if h < 2 or w < 2:
        raise ValueError(f"warp_bilinear needs H >= 2 and W >= 2, got {h}x{w}")
    if src.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"src has dtype {src.dtype}, expected torch.float32 or torch.bfloat16")
    want = src.shape[:-3] + src.shape[-2:]
    for name, t in (("src", src), ("fx", fx), ("fy", fy)):
        if name != "src" and t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected torch.float32")
        if t.device != src.device:
            raise ValueError(f"{name} is on {t.device}, src on {src.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("fx", fx), ("fy", fy)):
        if t.shape != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(want)}")


def _lib():
    from ..kernels import load

    lib = load("warp_bilinear")
    fn = lib.warp_bilinear_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, p, p, p, i, i, i, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def warp_bilinear(
    src: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor, geometry: str = "gather"
) -> torch.Tensor:
    """Sample src (..., C, H, W), float32 or bfloat16, at the absolute
    coordinates fx, fy (..., H, W) float32 in `geometry` ("gather" or
    "slab"); returns (..., C, H, W) float32. All contiguous, H and W >= 2.

    CPU tensors run `warp_bilinear_reference`; CUDA tensors launch the
    kernel on the current stream (counted in `warp_bilinear.launches`, both
    geometries; the launch `launch_shape` gave it kept in
    `warp_bilinear.last_launch`) or raise."""
    _check(src, fx, fy, geometry)
    dev = src.device
    if dev.type == "cpu":
        return warp_bilinear_reference(src, fx, fy, geometry)
    if dev.type != "cuda":
        raise ValueError(f"warp_bilinear runs on cpu or cuda tensors, not {dev.type}")
    out = torch.empty(src.shape, dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    c, h, w = src.shape[-3:]
    shape = launch_shape(src.numel() // (c * h * w), c, h, w, geometry)
    _launch(src, fx, fy, out, geometry, shape)
    warp_bilinear.launches += 1
    warp_bilinear.last_launch = shape
    return out


def _launch(src, fx, fy, out, geometry: str, shape: LaunchShape) -> None:
    """One launch of the kernel on CUDA tensors as `warp_bilinear` checks
    them, into out, with the given launch; raises if it fails."""
    c, h, w = src.shape[-3:]
    dev = src.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().warp_bilinear_launch(
            src.data_ptr(), int(src.dtype == torch.bfloat16), int(geometry == "slab"),
            fx.data_ptr(), fy.data_ptr(), out.data_ptr(), src.numel() // (c * h * w), c, h, w, *shape, stream,
        )
    if rc != 0:
        raise RuntimeError(f"warp_bilinear launch failed: cudaError {rc}")


warp_bilinear.launches = 0
warp_bilinear.last_launch = None
