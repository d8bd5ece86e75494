"""Dense bilinear sampling and backward warping (port of
hackathonopticalflow_tpu/ops/warp.py): a general remap primitive, and the
frame warp of Farneback's "image" and "hybrid" modes. The coefficient warp
has its own kernel, ops/warp_bilinear.py."""

from __future__ import annotations

import torch


def _taps(h: int, w: int, xs: torch.Tensor, ys: torch.Tensor):
    """Border-clamped corners (x0, x1, y0, y1) and bilinear weights (w00,
    w10, w01, w11) of float coordinates xs, ys in an (H, W) image."""
    x = torch.clamp(xs, 0.0, w - 1.0)
    y = torch.clamp(ys, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, max(w - 2, 0))
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, max(h - 2, 0))
    ax = x - x0
    ay = y - y0
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    weights = ((1 - ax) * (1 - ay), ax * (1 - ay), (1 - ax) * ay, ax * ay)
    return (x0, x1, y0, y1), weights


def bilinear_sample(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Sample img (..., H, W) at float coordinates xs, ys (broadcastable
    to one shape S); returns (..., *S). Out-of-range coordinates clamp to
    the border pixel."""
    h, w = img.shape[-2:]
    (x0, x1, y0, y1), (w00, w10, w01, w11) = _taps(h, w, xs, ys)
    return (
        img[..., y0, x0] * w00
        + img[..., y0, x1] * w10
        + img[..., y1, x0] * w01
        + img[..., y1, x1] * w11
    )


def warp_image(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp img by flow: out(p) = img(p + flow(p)).
    img: (..., H, W); flow: (..., H, W, 2) with [dx, dy] channels and the
    same leading axes, each batch row warped by its own flow (JAX's
    2-D gather form, vmapped over the batch: the same taps and order)."""
    h, w = img.shape[-2:]
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)
    (x0, x1, y0, y1), (w00, w10, w01, w11) = _taps(h, w, xs + flow[..., 0], ys + flow[..., 1])
    lead = torch.broadcast_shapes(img.shape[:-2], flow.shape[:-3])
    flat = img.expand(*lead, h, w).reshape(*lead, h * w)

    def tap(yy, xx):
        idx = (yy * w + xx).expand(*lead, h, w).reshape(*lead, h * w)
        return torch.gather(flat, -1, idx).view(*lead, h, w)

    return tap(y0, x0) * w00 + tap(y0, x1) * w10 + tap(y1, x0) * w01 + tap(y1, x1) * w11
