"""Color-space conversions (port of hackathonopticalflow_tpu/ops/color.py:
cv2.cvtColor parity for the conversions the reference uses, BGR2GRAY
pathfinder_viewer.py:244,280; BGR2HSV :288; HSV2BGR :139,219; GRAY2BGR
DenseOF.py:533).

Tensors are channel-last: (..., H, W, 3) for color, (..., H, W) for gray.
uint8 in and out where the reference works on uint8 frames, with the JAX
functions' float32 arithmetic in the same order, so the uint8 results are
the JAX package's bit for bit; float inputs keep full precision.
"""

from __future__ import annotations

import torch


def bgr2gray(bgr: torch.Tensor) -> torch.Tensor:
    """cv2 BGR2GRAY with Rec.601 weights. uint8 input reproduces OpenCV 5's
    15-bit fixed point ((B*3735 + G*19235 + R*9798 + 16384) >> 15); float
    input returns the weighted sum unrounded."""
    b, g, r = bgr[..., 0], bgr[..., 1], bgr[..., 2]
    if bgr.dtype == torch.uint8:
        i32 = torch.int32
        acc = b.to(i32) * 3735 + g.to(i32) * 19235 + r.to(i32) * 9798 + 16384
        return (acc >> 15).to(torch.uint8)
    f32 = torch.float32
    return 0.114 * b.to(f32) + 0.587 * g.to(f32) + 0.299 * r.to(f32)


def gray2bgr(gray: torch.Tensor) -> torch.Tensor:
    return torch.stack([gray, gray, gray], dim=-1)


def _to_u8(out: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 255] -> uint8, rounded half up (the JAX functions'
    (out + 0.5).astype(uint8))."""
    return (out + 0.5).to(torch.uint8)


def bgr2hsv(bgr: torch.Tensor) -> torch.Tensor:
    """cv2 BGR2HSV for uint8 range: H in [0, 180), S, V in [0, 255]."""
    f = bgr.to(torch.float32)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    v = torch.maximum(torch.maximum(b, g), r)
    mn = torch.minimum(torch.minimum(b, g), r)
    diff = v - mn
    one = torch.ones_like(diff)
    safe = torch.where(diff == 0, one, diff)
    s = torch.where(v == 0, torch.zeros_like(v), diff * 255.0 / torch.where(v == 0, one, v))
    h = torch.where(
        v == r,
        30.0 * (g - b) / safe,
        torch.where(v == g, 60.0 + 30.0 * (b - r) / safe, 120.0 + 30.0 * (r - g) / safe),
    )
    h = torch.where(diff == 0, torch.zeros_like(h), h)
    h = torch.where(h < 0, h + 180.0, h)
    out = torch.stack([h, s, v], dim=-1)
    return _to_u8(out) if bgr.dtype == torch.uint8 else out


def hsv2bgr(hsv: torch.Tensor) -> torch.Tensor:
    """cv2 HSV2BGR for uint8 range (H in [0, 180))."""
    f = hsv.to(torch.float32)
    h, s, v = f[..., 0] * 2.0, f[..., 1] / 255.0, f[..., 2]
    c = v * s
    hp = h / 60.0
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    m = v - c
    z = torch.zeros_like(c)
    sector = torch.floor(hp).to(torch.int32) % 6

    def pick(*by_sector):
        out = by_sector[5]
        for k in range(4, -1, -1):
            out = torch.where(sector == k, by_sector[k], out)
        return out

    r = pick(c, x, z, z, x, c)
    g = pick(x, c, c, x, z, z)
    b = pick(z, z, x, c, c, x)
    out = torch.stack([b + m, g + m, r + m], dim=-1)
    return _to_u8(out) if hsv.dtype == torch.uint8 else out


def saturating_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cv2.add on uint8: saturating elementwise addition (layer
    compositing, pathfinder_viewer.py:294-312)."""
    s = a.to(torch.int32) + b.to(torch.int32)
    return torch.clamp(s, 0, 255).to(torch.uint8)
