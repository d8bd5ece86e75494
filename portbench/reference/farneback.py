"""The plain reference of the dense viewer's Farneback flow: the
reference's `calculate_optical_flow` (DenseOF.py:127-157), OpenCV's
calcOpticalFlowFarneback with pyr_scale 0.5, levels 3, winsize 15,
iterations 3, poly_n 5, poly_sigma 1.2, flags 0, as the port's plain path
computes it in its "exact" coefficient warp.

A frozen copy of the port's plain versions (hackathonopticalflow_tpu_torch
ops/farneback.py's "exact" mode with the doubling box, ops/image.py,
ops/warp_bilinear.py::warp_bilinear_reference in the gather geometry),
cut to that mode. It imports nothing of the port, of the JAX package or
jax, and takes nothing the port made: it expands both frames itself.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .image import box_sum, corr1d, gaussian_blur, resize_bilinear

_BORDER = 5
_BORDER_SCALE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)


@functools.lru_cache(maxsize=None)
def _poly_exp_consts(n: int, sigma: float):
    if sigma < 1e-7:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g
    xx, yy = np.meshgrid(x, x, indexing="ij")
    w = np.outer(g, g)
    basis = np.stack([np.ones_like(xx), xx, yy, xx**2, yy**2, xx * yy], axis=0).reshape(6, -1)
    gram = (basis * w.reshape(1, -1)) @ basis.T
    inv = np.linalg.inv(gram)
    return (g.astype(np.float32), xg.astype(np.float32), xxg.astype(np.float32),
            float(inv[1, 1]), float(inv[0, 3]), float(inv[3, 3]), float(inv[5, 5]))


def poly_exp(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """(H, W) -> (5, H, W) coefficients [b_y, b_x, a_yy, a_xx, a_xy]."""
    g, xg, xxg, ig11, ig03, ig33, ig55 = _poly_exp_consts(n, sigma)
    dev = img.device
    vert = torch.from_numpy(np.stack([g, xg, xxg])).to(dev)
    horiz = torch.from_numpy(np.stack([g, xg, g, g, xxg, xg])).to(dev)
    source = torch.tensor([0, 0, 1, 2, 0, 1], device=dev)
    s = corr1d(img.unsqueeze(-3), vert, -2, "edge")
    b1, b2, b3, b4, b5, b6 = corr1d(s.index_select(-3, source), horiz, -1, "edge").unbind(-3)
    return torch.stack([b3 * ig11, b2 * ig11, b1 * ig03 + b4 * ig33, b1 * ig03 + b5 * ig33, b6 * ig55], dim=-3)


def _border_factor(h: int, w: int, device) -> torch.Tensor:
    def axis_f(n):
        f = np.ones((n,), np.float32)
        b = min(_BORDER, n)
        f[:b] *= _BORDER_SCALE[:b]
        f[n - b:] *= _BORDER_SCALE[:b][::-1]
        return f

    return torch.from_numpy(np.outer(axis_f(h), axis_f(w))).to(device)


def warp_gather(src: torch.Tensor, fx: torch.Tensor, fy: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of (C, H, W) at (H, W) coordinates, corners and
    fractions clamped to the plane; the weights formed first."""
    h, w = src.shape[-2:]
    x0 = torch.clamp(torch.floor(fx), 0, w - 2)
    y0 = torch.clamp(torch.floor(fy), 0, h - 2)
    ax = torch.clamp(fx - x0, 0.0, 1.0)
    ay = torch.clamp(fy - y0, 0.0, 1.0)
    lin = (y0.to(torch.int64) * w + x0.to(torch.int64)).flatten(-2).unsqueeze(-2)
    flat = src.flatten(-2)

    def corner(offset):
        return torch.gather(flat, -1, (lin + offset).expand(flat.shape)).view(src.shape)

    bx, by = 1.0 - ax, 1.0 - ay
    return (corner(0) * (bx * by).unsqueeze(-3) + corner(1) * (ax * by).unsqueeze(-3)
            + corner(w) * (bx * ay).unsqueeze(-3) + corner(w + 1) * (ax * ay).unsqueeze(-3))


def update_matrices(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """OpenCV FarnebackUpdateMatrices: the 5-channel normal-equation field."""
    h, w = r0.shape[-2:]
    dx, dy = flow[..., 0], flow[..., 1]
    xs = torch.arange(w, dtype=torch.float32, device=flow.device)
    ys = torch.arange(h, dtype=torch.float32, device=flow.device)[:, None]
    fx, fy = xs + dx, ys + dy
    x1, y1 = torch.floor(fx), torch.floor(fy)
    inside = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)
    w2 = warp_gather(r1, fx, fy)
    c0, c1, c2, c3, c4 = r0.unbind(-3)
    v0, v1, v2, v3, v4 = w2.unbind(-3)
    r2 = torch.where(inside, v0, 0.0)
    r3 = torch.where(inside, v1, 0.0)
    r4 = torch.where(inside, (c2 + v2) * 0.5, c2)
    r5 = torch.where(inside, (c3 + v3) * 0.5, c3)
    r6 = torch.where(inside, (c4 + v4) * 0.25, c4 * 0.5)
    r2 = (c0 - r2) * 0.5
    r3 = (c1 - r3) * 0.5
    r2 = r2 + r4 * dy + r6 * dx
    r3 = r3 + r6 * dy + r5 * dx
    scale = _border_factor(h, w, r0.device)
    r2, r3, r4, r5, r6 = r2 * scale, r3 * scale, r4 * scale, r5 * scale, r6 * scale
    return torch.stack([r4 * r4 + r6 * r6, (r4 + r5) * r6, r5 * r5 + r6 * r6, r4 * r2 + r6 * r3,
                        r6 * r2 + r5 * r3], dim=-3)


def update_flow(m: torch.Tensor, win_size: int) -> torch.Tensor:
    """OpenCV FarnebackUpdateFlow_blur: box sums (doubling order,
    replicate border) over win^2, then the 1e-3-damped 2x2 solve."""
    ms = box_sum(m, win_size) * (1.0 / (win_size * win_size))
    g11, g12, g22, h1, h2 = ms.unbind(-3)
    idet = torch.reciprocal(g11 * g22 - g12 * g12 + 1e-3)
    return torch.stack([(g11 * h2 - g12 * h1) * idet, (g22 * h1 - g12 * h2) * idet], dim=-1)


class FarnebackReference:
    """Farneback flow at one configuration (its `farneback` group)."""

    def __init__(self, cfg: dict, device):
        fb = cfg["farneback"]
        if fb.get("gaussian_win") or fb.get("warp_mode", "auto") not in ("auto", "exact"):
            raise ValueError("the reference holds the box window and the exact coefficient warp only")
        self.p = fb
        self.device = torch.device(device)

    def _levels(self, h: int, w: int):
        out = []
        for k in range(self.p["levels"], -1, -1):
            scale = self.p["pyr_scale"] ** k
            sigma = (1.0 / scale - 1.0) * 0.5
            out.append((int(round(h * scale)), int(round(w * scale)), sigma, max(int(round(sigma * 5)) | 1, 3)))
        return out

    def prepare(self, gray: torch.Tensor) -> list[torch.Tensor]:
        """Per level, coarse to fine: the (5, Hk, Wk) coefficients of the
        blurred, resized frame."""
        img = gray.to(self.device, torch.float32)
        h, w = img.shape[-2:]
        out = []
        for hk, wk, sigma, size in self._levels(h, w):
            smoothed = gaussian_blur(img, size, sigma)
            if (hk, wk) != (h, w):
                smoothed = resize_bilinear(smoothed, hk, wk)
            out.append(poly_exp(smoothed, self.p["poly_n"], self.p["poly_sigma"]))
        return out

    def pair(self, prev_prep: list, cur_prep: list) -> torch.Tensor:
        """(H, W, 2) float32 flow from the previous frame to the current."""
        p = self.p
        flow = None
        for r0, r1 in zip(prev_prep, cur_prep):
            hk, wk = r0.shape[-2:]
            if flow is None:
                flow = torch.zeros((hk, wk, 2), dtype=torch.float32, device=r0.device)
            else:
                flow = resize_bilinear(flow.movedim(-1, -3), hk, wk).movedim(-3, -1) * (1.0 / p["pyr_scale"])
            m = update_matrices(r0, r1, flow)
            for i in range(p["iterations"]):
                flow = update_flow(m, p["win_size"])
                if i < p["iterations"] - 1:
                    m = update_matrices(r0, r1, flow)
        return flow
