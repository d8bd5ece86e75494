"""Bilinear sample of C channels at absolute coordinates: the CUDA kernel
`warp_bilinear` (csrc/warp_bilinear.cu) and its plain PyTorch version
`warp_bilinear_reference`.

Port of the TPU kernel hackathonopticalflow_tpu/ops/warp_pallas.py::
warp_bilinear_pallas, the Farneback coefficient warp (OpenCV
FarnebackUpdateMatrices' bilinear fetch). Contract (warp_pallas.py:216-234):
per pixel,

- corners clamp: x0 = clamp(floor(fx), 0, W-2), y0 = clamp(floor(fy), 0, H-2);
- fractions clamp: ax = clamp(fx - x0, 0, 1), ay = clamp(fy - y0, 0, 1);
- out[c] = v00 (1-ax)(1-ay) + v10 ax(1-ay) + v01 (1-ax)ay + v11 ax ay,
  the weights formed first and the four terms summed in that order.

The TPU kernel's tiles, slab DMA and 72/128 px spread clamp are not
carried over: each pixel reads its own four corners, exactly. Where the
caller's `inside` test holds (floor(f) within [0, dim-2]), this equals
JAX's warp_mode="exact" gather; elsewhere the caller masks the result.
The kernel rounds every product and sum separately (__fmul_rn/__fadd_rn,
-fmad=false), as the separate PyTorch ops below do, so the two agree bit
for bit.
"""

from __future__ import annotations

import ctypes

import torch


def warp_bilinear_reference(src: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `warp_bilinear`; same arguments and result."""
    h, w = src.shape[-2:]
    x0 = torch.clamp(torch.floor(fx), 0, w - 2)
    y0 = torch.clamp(torch.floor(fy), 0, h - 2)
    ax = torch.clamp(fx - x0, 0.0, 1.0)
    ay = torch.clamp(fy - y0, 0.0, 1.0)
    bx, by = 1.0 - ax, 1.0 - ay
    lin = (y0.to(torch.int64) * w + x0.to(torch.int64)).flatten(-2).unsqueeze(-2)
    flat = src.flatten(-2)  # (..., C, H*W)

    def corner(offset):
        idx = (lin + offset).expand(flat.shape)
        return torch.gather(flat, -1, idx).view(src.shape)

    def weight(a, b):
        return (a * b).unsqueeze(-3)

    return (
        corner(0) * weight(bx, by)
        + corner(1) * weight(ax, by)
        + corner(w) * weight(bx, ay)
        + corner(w + 1) * weight(ax, ay)
    )


def _check(src: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> None:
    if src.dim() < 3:
        raise ValueError(f"src must be (..., C, H, W), got shape {tuple(src.shape)}")
    h, w = src.shape[-2:]
    if h < 2 or w < 2:
        raise ValueError(f"warp_bilinear needs H >= 2 and W >= 2, got {h}x{w}")
    want = src.shape[:-3] + src.shape[-2:]
    for name, t in (("src", src), ("fx", fx), ("fy", fy)):
        if t.dtype != torch.float32:
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
        fn.argtypes = [p, p, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def warp_bilinear(src: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Sample src (..., C, H, W) float32 at the absolute coordinates fx, fy
    (..., H, W) float32; returns (..., C, H, W) float32. All contiguous,
    H and W >= 2.

    CPU tensors run `warp_bilinear_reference`; CUDA tensors launch the
    kernel on the current stream (counted in `warp_bilinear.launches`) or
    raise."""
    _check(src, fx, fy)
    dev = src.device
    if dev.type == "cpu":
        return warp_bilinear_reference(src, fx, fy)
    if dev.type != "cuda":
        raise ValueError(f"warp_bilinear runs on cpu or cuda tensors, not {dev.type}")
    out = torch.empty_like(src)
    if out.numel() == 0:
        return out
    c, h, w = src.shape[-3:]
    b = src.numel() // (c * h * w)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.warp_bilinear_launch(
            src.data_ptr(), fx.data_ptr(), fy.data_ptr(), out.data_ptr(), b, c, h, w, stream
        )
    if rc != 0:
        raise RuntimeError(f"warp_bilinear launch failed: cudaError {rc}")
    warp_bilinear.launches += 1
    return out


warp_bilinear.launches = 0
