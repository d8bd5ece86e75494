"""Dense bilinear sampling and backward warping (port of
hackathonopticalflow_tpu/ops/warp.py): a general remap primitive. The
Farneback coefficient warp has its own kernel, ops/warp_bilinear.py."""

from __future__ import annotations

import torch


def bilinear_sample(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
    """Sample img (..., H, W) at float coordinates xs, ys (broadcastable
    to one shape S); returns (..., *S). Out-of-range coordinates clamp to
    the border pixel."""
    h, w = img.shape[-2:]
    x = torch.clamp(xs, 0.0, w - 1.0)
    y = torch.clamp(ys, 0.0, h - 1.0)
    x0 = torch.clamp(torch.floor(x).to(torch.int64), 0, max(w - 2, 0))
    y0 = torch.clamp(torch.floor(y).to(torch.int64), 0, max(h - 2, 0))
    ax = x - x0
    ay = y - y0
    x1 = torch.clamp(x0 + 1, max=w - 1)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    w00 = (1 - ax) * (1 - ay)
    w10 = ax * (1 - ay)
    w01 = (1 - ax) * ay
    w11 = ax * ay
    return (
        img[..., y0, x0] * w00
        + img[..., y0, x1] * w10
        + img[..., y1, x0] * w01
        + img[..., y1, x1] * w11
    )


def warp_image(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp img by flow: out(p) = img(p + flow(p)).
    img: (H, W); flow: (H, W, 2) with [dx, dy] channels."""
    h, w = img.shape[-2:]
    ys = torch.arange(h, dtype=flow.dtype, device=flow.device)[:, None]
    xs = torch.arange(w, dtype=flow.dtype, device=flow.device)
    return bilinear_sample(img, xs + flow[..., 0], ys + flow[..., 1])
