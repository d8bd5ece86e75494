"""One rectangle of a plane (or plane stack) per integer origin: the CUDA
kernel `gather_rects` (csrc/gather_rects.cu) and its plain PyTorch version
`gather_rects_reference`.

Port of the TPU kernel hackathonopticalflow_tpu/ops/carve_pallas.py::
gather_rects, the generic rect gather that the JAX package's
ops/patch.py::extract_slabs_rect routes to on a TPU when DMA_CARVE is on
(it is off there, so no JAX path runs it). The port's extract_slabs_rect
and extract_slabs (ops/patch.py) run it. Contract, per origin [x, y]: the
(ry, rx) rect of each plane at (y, x), placed as the JAX package's
vmap(dynamic_slice) places it (ops/patch_bilinear.py::slice_start: a
negative start is wrapped by the plane's size, then clamped into
[0, dim - size]). A copy: the kernel equals the plain version bit for
bit."""

from __future__ import annotations

import ctypes

import torch

from .patch_bilinear import slice_start


def gather_rects_reference(img: torch.Tensor, tl: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
    """Plain PyTorch version of `gather_rects`; same arguments and result:
    one advanced-indexing gather."""
    h, w = img.shape[-2:]
    dev = img.device
    x0 = slice_start(tl[:, 0].to(torch.int64), w, rx)
    y0 = slice_start(tl[:, 1].to(torch.int64), h, ry)
    rows = (y0[:, None] + torch.arange(ry, device=dev))[:, :, None]
    cols = (x0[:, None] + torch.arange(rx, device=dev))[:, None, :]
    if img.dim() == 2:
        return img[rows, cols]
    return img[:, rows, cols].transpose(0, 1).contiguous()


def _check(img: torch.Tensor, tl: torch.Tensor, ry: int, rx: int) -> None:
    if img.dim() not in (2, 3):
        raise ValueError(f"img must be (H, W) or (C, H, W), got shape {tuple(img.shape)}")
    if img.dtype != torch.float32:
        raise TypeError(f"img has dtype {img.dtype}, expected torch.float32")
    if tl.dim() != 2 or tl.shape[1] != 2:
        raise ValueError(f"tl must be (N, 2), got shape {tuple(tl.shape)}")
    if tl.dtype != torch.int32:
        raise TypeError(f"tl has dtype {tl.dtype}, expected torch.int32")
    for name, t in (("img", img), ("tl", tl)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if tl.device != img.device:
        raise ValueError(f"tl is on {tl.device}, img on {img.device}")
    h, w = img.shape[-2:]
    if ry < 1 or rx < 1 or ry > h or rx > w:
        raise ValueError(f"rect {ry}x{rx} does not fit in the {h}x{w} plane")


def _lib():
    from ..kernels import load

    lib = load("gather_rects")
    fn = lib.gather_rects_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, p, i, i, i, p, p]
        fn.restype = ctypes.c_int
    return lib


def gather_rects(img: torch.Tensor, tl: torch.Tensor, ry: int, rx: int) -> torch.Tensor:
    """Rects (ry, rx) of img (H, W) or (C, H, W) float32 at origins tl
    (N, 2) int32 [x, y]; returns (N, ry, rx) or (N, C, ry, rx) float32.
    All contiguous.

    CPU tensors run `gather_rects_reference`; CUDA tensors launch the
    kernel on the current stream (counted in `gather_rects.launches`) or
    raise."""
    _check(img, tl, ry, rx)
    dev = img.device
    if dev.type == "cpu":
        return gather_rects_reference(img, tl, ry, rx)
    if dev.type != "cuda":
        raise ValueError(f"gather_rects runs on cpu or cuda tensors, not {dev.type}")
    c = 1 if img.dim() == 2 else img.shape[0]
    h, w = img.shape[-2:]
    n = tl.shape[0]
    out = torch.empty((n,) + img.shape[:-2] + (ry, rx), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.gather_rects_launch(img.data_ptr(), c, h, w, tl.data_ptr(), n, ry, rx, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"gather_rects launch failed: cudaError {rc}")
    gather_rects.launches += 1
    return out


gather_rects.launches = 0
