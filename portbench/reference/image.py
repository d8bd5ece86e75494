"""Plain image operations of the reference: a frozen copy of the port's
plain paths (hackathonopticalflow_tpu_torch/ops/image.py, ops/color.py),
which themselves follow OpenCV. Plain PyTorch on whatever device the
tensors are on; nothing here imports the port, the JAX package or jax.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def bgr2gray_u8(bgr: np.ndarray) -> np.ndarray:
    """cv2 BGR2GRAY on (..., 3) uint8, OpenCV's 15-bit fixed point:
    (B*3735 + G*19235 + R*9798 + 16384) >> 15."""
    b, g, r = (bgr[..., i].astype(np.int32) for i in range(3))
    return ((b * 3735 + g * 19235 + r * 9798 + 16384) >> 15).astype(np.uint8)


def reflect101_index(n: int, before: int, after: int) -> torch.Tensor:
    i = torch.arange(-before, n + after)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def edge_index(n: int, before: int, after: int) -> torch.Tensor:
    return torch.clamp(torch.arange(-before, n + after), 0, n - 1)


@functools.lru_cache(maxsize=256)
def _pad_index(n: int, before: int, after: int, mode: str, device: torch.device) -> torch.Tensor:
    fn = {"reflect": reflect101_index, "edge": edge_index}[mode]
    return fn(n, before, after).to(device)


def pad_axis(x: torch.Tensor, dim: int, before: int, after: int, mode: str) -> torch.Tensor:
    """Pad axis `dim` by (before, after): 'reflect' = BORDER_REFLECT_101,
    'edge' = BORDER_REPLICATE."""
    return x.index_select(dim, _pad_index(x.shape[dim], before, after, mode, x.device))


def reflect101_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    return pad_axis(pad_axis(x, -2, pad, pad, "reflect"), -1, pad, pad, "reflect")


def corr1d(x: torch.Tensor, taps, dim: int, mode: str = "reflect") -> torch.Tensor:
    """Same-size correlation along `dim` with an odd number of taps,
    applied in order (acc = x_0 k_0, then acc += x_t k_t); taps are
    floats, or a (C, n) tensor of per-channel taps for (..., C or 1, H, W)."""
    per_channel = torch.is_tensor(taps)
    n = taps.shape[-1] if per_channel else len(taps)
    r = n // 2
    size = x.shape[dim]
    xp = pad_axis(x, dim, r, r, mode)

    def tap(t):
        k = taps[:, t, None, None] if per_channel else taps[t]
        return xp.narrow(dim, t, size) * k

    acc = tap(0)
    for t in range(1, n):
        acc = acc + tap(t)
    return acc


def sep_conv2d(img: torch.Tensor, ky, kx, mode: str = "reflect") -> torch.Tensor:
    """Separable correlation: the x pass, then the y pass."""
    return corr1d(corr1d(img, kx, -1, mode), ky, -2, mode)


_SMALL_GAUSSIAN_TAB = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def gaussian_kernel1d(ksize: int, sigma: float) -> list[float]:
    """cv2.getGaussianKernel, float32 taps as Python floats."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN_TAB:
        return list(_SMALL_GAUSSIAN_TAB[ksize])
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    return [float(v) for v in (k / k.sum()).astype(np.float32)]


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float) -> torch.Tensor:
    k = gaussian_kernel1d(ksize, sigma)
    return sep_conv2d(img, k, k)


def _box1d(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Window-of-k sums along `dim` of a padded tensor by doubling,
    combined in descending powers of two."""
    n = x.shape[dim]
    sums = {1: x}
    p = 1
    while 2 * p <= k:
        s = sums[p]
        m = s.shape[dim]
        sums[2 * p] = s.narrow(dim, 0, m - p) + s.narrow(dim, p, m - p)
        p *= 2
    out = None
    off, rem = 0, k
    out_len = n - k + 1
    for b in sorted(sums, reverse=True):
        if rem >= b:
            part = sums[b].narrow(dim, off, out_len)
            out = part if out is None else out + part
            off += b
            rem -= b
    return out


def box_sum(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Unnormalized ksize x ksize window sums, replicate border, x first."""
    r = ksize // 2
    x = pad_axis(pad_axis(img, -2, r, r, "edge"), -1, r, r, "edge")
    return _box1d(_box1d(x, ksize, -1), ksize, -2)


@functools.lru_cache(maxsize=64)
def _linear_taps(n_in: int, n_out: int, device: torch.device):
    s = (torch.arange(n_out, dtype=torch.float32) + 0.5) * (n_in / n_out) - 0.5
    s = torch.clamp(s, 0.0, n_in - 1.0)
    if n_in > 1:
        i0 = torch.clamp(torch.floor(s).to(torch.int64), 0, n_in - 2)
        f = s - i0
    else:
        i0 = torch.zeros(n_out, dtype=torch.int64)
        f = torch.zeros(n_out, dtype=torch.float32)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    return tuple(t.to(device) for t in (i0, i1, 1 - f, f))


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize INTER_LINEAR: half-pixel centres, clamped; rows first."""
    h, w = img.shape[-2:]
    y0, y1, gy, fy = _linear_taps(h, out_h, img.device)
    x0, x1, gx, fx = _linear_taps(w, out_w, img.device)
    rows = img.index_select(-2, y0) * gy[:, None] + img.index_select(-2, y1) * fy[:, None]
    return rows.index_select(-1, x0) * gx + rows.index_select(-1, x1) * fx
