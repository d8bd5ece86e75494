"""Bilinear windows of C planes at N fractional top-lefts: the CUDA kernel
`patch_bilinear` (csrc/patch_bilinear.cu) and its plain PyTorch version
`patch_bilinear_reference`.

Port of the TPU kernel hackathonopticalflow_tpu/ops/carve_pallas.py::
gather_rects_panels_multi with the XLA work around it (ops/patch.py
extract_patches_multi and blend_bilinear, ops/lk.py's _fix): the LK
tracker's template windows and its level-0 residual windows. Contract,
per point with top-left (x, y):

- integer origin (floor x, floor y), fraction (ax, ay) = (x, y) - origin;
- the (size_h+1, size_w+1) crop at the origin, placed as XLA's
  dynamic_slice places it: a negative start is wrapped by the plane's size,
  then clamped into [0, dim - crop] (origins beyond +-2^30 saturate first);
- weights formed first, w00 = (1-ax)(1-ay), w10 = ax(1-ay),
  w01 = (1-ax)ay, w11 = ax ay, and the four products summed in that order
  (the JAX package's order, so in-range windows equal JAX's bit for bit);
- with quantize, OpenCV's W_BITS grid: floor(v * 32 + 0.5) / 32.

A call may carry several streams: planes (B, C, H, W) with the points
stream-major (stream b's n / B points at rows b*n/B ..), each point
windowed from its own stream's planes, in one launch.

The kernel rounds every product and sum on its own (-fmad=false), as the
separate PyTorch ops below do, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

_MAX_ORIGIN = float(1 << 30)


def slice_start(start: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """Where XLA's dynamic_slice starts a slice of `size` along an axis of
    `dim` for the integer `start`: a negative start is wrapped by `dim`,
    then the start is clamped into [0, dim - size]."""
    return torch.where(start < 0, start + dim, start).clamp(0, dim - size)


def blend_bilinear(raw: torch.Tensor, frac: torch.Tensor, size_h: int, size_w: int) -> torch.Tensor:
    """Blend the four integer shifts of (N, ..., size_h+1, size_w+1) crops
    with per-point weights from frac (N, 2) [ax, ay] -> (N, ..., size_h,
    size_w): weights formed first, products summed in the contract's
    order."""
    shape = (-1,) + (1,) * (raw.dim() - 1)
    ax = frac[:, 0].reshape(shape)
    ay = frac[:, 1].reshape(shape)
    w00 = (1 - ax) * (1 - ay)
    w10 = ax * (1 - ay)
    w01 = (1 - ax) * ay
    w11 = ax * ay
    return (
        raw[..., :size_h, :size_w] * w00
        + raw[..., :size_h, 1:] * w10
        + raw[..., 1:, :size_w] * w01
        + raw[..., 1:, 1:] * w11
    )


def patch_bilinear_reference(
    planes: torch.Tensor, tl: torch.Tensor, size_h: int, size_w: int, quantize: bool
) -> torch.Tensor:
    """Plain PyTorch version of `patch_bilinear`; same arguments and
    result."""
    c, hp, wp = planes.shape[-3:]
    dev = planes.device
    stack = planes.reshape(-1, c, hp, wp)  # (B, C, Hp, Wp); B = 1 for one stack
    n = tl.shape[0]
    stream = (torch.arange(n, device=dev) // max(n // stack.shape[0], 1))[:, None, None, None]
    ip = torch.floor(tl)
    frac = tl - ip
    ipi = torch.clamp(ip, -_MAX_ORIGIN, _MAX_ORIGIN).to(torch.int64)
    x0 = slice_start(ipi[:, 0], wp, size_w + 1)
    y0 = slice_start(ipi[:, 1], hp, size_h + 1)
    rows = y0[:, None] + torch.arange(size_h + 1, device=dev)
    cols = x0[:, None] + torch.arange(size_w + 1, device=dev)
    chans = torch.arange(c, device=dev)[None, :, None, None]
    raw = stack[stream, chans, rows[:, None, :, None], cols[:, None, None, :]]  # (N, C, h+1, w+1)
    out = blend_bilinear(raw, frac, size_h, size_w)
    if quantize:
        out = torch.floor(out * 32.0 + 0.5) * (1.0 / 32.0)
    return out


def _check(planes: torch.Tensor, tl: torch.Tensor, size_h: int, size_w: int) -> None:
    if planes.dim() not in (3, 4):
        raise ValueError(f"planes must be (C, H, W) or (B, C, H, W), got shape {tuple(planes.shape)}")
    if tl.dim() != 2 or tl.shape[1] != 2:
        raise ValueError(f"tl must be (N, 2), got shape {tuple(tl.shape)}")
    for name, t in (("planes", planes), ("tl", tl)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected torch.float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tl.device != planes.device:
        raise ValueError(f"tl is on {tl.device}, planes on {planes.device}")
    c, hp, wp = planes.shape[-3:]
    nb = planes.shape[0] if planes.dim() == 4 else 1
    if nb < 1 or tl.shape[0] % nb:
        raise ValueError(f"{tl.shape[0]} points do not split over {nb} plane stacks")
    if c < 1 or size_h < 1 or size_w < 1:
        raise ValueError(f"empty window or plane stack: C={c}, {size_h}x{size_w}")
    if hp < size_h + 1 or wp < size_w + 1:
        raise ValueError(f"planes {hp}x{wp} smaller than the {size_h + 1}x{size_w + 1} crop")


def _lib():
    from ..kernels import load

    lib = load("patch_bilinear")
    fn = lib.patch_bilinear_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, i, p, i, i, i, i, p, p]
        fn.restype = ctypes.c_int
        occ = lib.patch_bilinear_occupancy
        occ.argtypes = [i, i, p, p, p, p]
        occ.restype = ctypes.c_int
    return lib


def patch_bilinear(
    planes: torch.Tensor, tl: torch.Tensor, size_h: int, size_w: int, quantize: bool
) -> torch.Tensor:
    """Windows of planes (C, Hp, Wp) float32 at top-lefts tl (N, 2) float32
    [x, y] in the planes' coordinates; returns (N, C, size_h, size_w)
    float32, quantized to the 1/32 grid if `quantize`. All contiguous.
    Planes (B, C, Hp, Wp), B dividing N: point p is windowed from stack
    p // (N / B) (points stream-major), in the same one launch.

    CPU tensors run `patch_bilinear_reference`; CUDA tensors launch the
    kernel on the current stream (counted in `patch_bilinear.launches`) or
    raise."""
    _check(planes, tl, size_h, size_w)
    dev = planes.device
    if dev.type == "cpu":
        return patch_bilinear_reference(planes, tl, size_h, size_w, quantize)
    if dev.type != "cuda":
        raise ValueError(f"patch_bilinear runs on cpu or cuda tensors, not {dev.type}")
    c, hp, wp = planes.shape[-3:]
    nb = planes.shape[0] if planes.dim() == 4 else 1
    n = tl.shape[0]
    out = torch.empty((n, c, size_h, size_w), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.patch_bilinear_launch(
            planes.data_ptr(), nb, c, hp, wp, tl.data_ptr(), n, size_h, size_w,
            int(quantize), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"patch_bilinear launch failed: cudaError {rc}")
    patch_bilinear.launches += 1
    return out


patch_bilinear.launches = 0


def kernel_variants() -> list[dict]:
    """Registers per thread, threads per block and resident blocks and
    warps per SM of the kernel at the main paths' windows (45 x 45, the
    exact scan; 15 x 15, the tracker). Needs the CUDA toolkit and a GPU."""
    lib = _lib()
    out = []
    for win in (45, 15):
        vals = [ctypes.c_int() for _ in range(4)]
        rc = lib.patch_bilinear_occupancy(win, win, *[ctypes.addressof(v) for v in vals])
        if rc != 0:
            raise RuntimeError(f"patch_bilinear_occupancy failed: cudaError {rc}")
        threads, blocks, regs, local = (v.value for v in vals)
        out.append(dict(label=f"window {win}x{win}", threads=threads, blocks_per_sm=blocks,
                        warps_per_sm=blocks * threads // 32, regs=regs, local_bytes=local))
    return out
