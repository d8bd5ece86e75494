"""Dense image primitives (port of hackathonopticalflow_tpu/ops/image.py):
separable correlation with reflect-101 or replicate borders, Gaussian taps
and blur, doubling box sums, OpenCV-compatible resizes, a single-channel
VALID correlation.

The separable passes are shifted multiply-adds and index gathers, as the
JAX package's TPU branch computes them, never F.conv2d or F.interpolate:
cuDNN runs float32 convolutions in TF32 by default, which breaks the
floor(x + 0.5) u8 quantization of the pyramid and the Farneback parity
budget. conv2d_single, a general 2-D kernel that XLA computes outside any
Pallas kernel in the JAX package, is one F.conv2d with TF32 off."""

from __future__ import annotations

import functools

import numpy as np
import torch


def reflect101_index(n: int, before: int, after: int, device=None) -> torch.Tensor:
    """Indices into an axis of length n that pad it by (before, after)
    with BORDER_REFLECT_101, reflecting as often as the pad needs (as
    np.pad / jnp.pad mode="reflect" do; F.pad refuses pads >= n)."""
    i = torch.arange(-before, n + after, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def edge_index(n: int, before: int, after: int, device=None) -> torch.Tensor:
    """Indices into an axis of length n that pad it by (before, after)
    with BORDER_REPLICATE (jnp.pad mode="edge")."""
    return torch.clamp(torch.arange(-before, n + after, device=device), 0, n - 1)


_PAD_INDEX = {"reflect": reflect101_index, "edge": edge_index}


@functools.lru_cache(maxsize=256)
def _pad_index(n: int, before: int, after: int, mode: str, device: torch.device) -> torch.Tensor:
    if mode not in _PAD_INDEX:
        raise ValueError(f"border mode {mode!r} is not 'reflect' or 'edge'")
    return _PAD_INDEX[mode](n, before, after).to(device)


def pad_axis(x: torch.Tensor, dim: int, before: int, after: int, mode: str) -> torch.Tensor:
    """Pad axis `dim` of x by (before, after) with border `mode`
    ('reflect' = BORDER_REFLECT_101, 'edge' = BORDER_REPLICATE)."""
    return x.index_select(dim, _pad_index(x.shape[dim], before, after, mode, x.device))


def reflect101_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the last two axes of x by `pad` on every side, reflect-101."""
    return pad_axis(pad_axis(x, -2, pad, pad, "reflect"), -1, pad, pad, "reflect")


def corr1d(x: torch.Tensor, taps, dim: int, mode: str = "reflect") -> torch.Tensor:
    """Same-size correlation of x along `dim` (-1 or -2) with an odd
    number of taps, applied in order (acc = x_0 k_0, then acc += x_t k_t).

    taps: Python floats shared by all of x, or a float32 tensor (C, n) of
    per-channel taps for x of shape (..., C or 1, H, W), whose channel
    axis broadcasts to C."""
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


def sep_conv2d(img: torch.Tensor, ky, kx, *, mode: str = "reflect") -> torch.Tensor:
    """Separable 2-D correlation of (..., H, W) with taps ky (rows) and kx
    (columns), same-size output; mode 'reflect' (BORDER_REFLECT_101, for
    GaussianBlur and pyrDown) or 'edge' (BORDER_REPLICATE). Taps are
    Python floats; the x pass runs first, then the y pass."""
    return corr1d(corr1d(img, kx, -1, mode), ky, -2, mode)


_SMALL_GAUSSIAN_TAB = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
}


def gaussian_kernel1d(ksize: int, sigma: float) -> list[float]:
    """cv2.getGaussianKernel semantics, including the fixed small-kernel
    tables used when sigma <= 0 and ksize <= 7. The taps are float32
    values (as Python floats)."""
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN_TAB:
        return list(_SMALL_GAUSSIAN_TAB[ksize])
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(xs**2) / (2.0 * sigma * sigma))
    return [float(v) for v in (k / k.sum()).astype(np.float32)]


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float, *, mode: str = "reflect") -> torch.Tensor:
    """cv2.GaussianBlur parity (BORDER_REFLECT_101 default)."""
    k = gaussian_kernel1d(ksize, sigma)
    return sep_conv2d(img, k, k, mode=mode)


def _box1d(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Sliding window-of-k sum along `dim` of an already-padded tensor,
    by doubling: power-of-2 partial sums S_2p[i] = S_p[i] + S_p[i+p],
    then k's binary decomposition combined in descending order (the JAX
    package's summation order)."""
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


def box_sum(img: torch.Tensor, ksize: int, *, mode: str = "edge") -> torch.Tensor:
    """Unnormalized ksize x ksize window sums of (..., H, W) (replicate
    border by default), as Farneback's flow averaging (OpenCV
    FarnebackUpdateFlow_blur): x pass first, then y."""
    r = ksize // 2
    x = pad_axis(pad_axis(img, -2, r, r, mode), -1, r, r, mode)
    return _box1d(_box1d(x, ksize, -1), ksize, -2)


@functools.lru_cache(maxsize=64)
def _linear_taps(n_in: int, n_out: int, device: torch.device):
    """Source indices (i0, i1) and weights (1 - f, f) of cv2's INTER_LINEAR
    along one axis: float32 half-pixel source coordinates, clamped."""
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
    """cv2.resize INTER_LINEAR parity on (..., H, W): half-pixel centres,
    clamped, no antialiasing on downscale; rows first, then columns."""
    h, w = img.shape[-2:]
    y0, y1, gy, fy = _linear_taps(h, out_h, img.device)
    x0, x1, gx, fx = _linear_taps(w, out_w, img.device)
    rows = img.index_select(-2, y0) * gy[:, None] + img.index_select(-2, y1) * fy[:, None]
    return rows.index_select(-1, x0) * gx + rows.index_select(-1, x1) * fx


def _area_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) fractional pixel-coverage weights for cv2's generic
    INTER_AREA downscale: output cell j covers the source span
    [j*scale, (j+1)*scale); rows normalized by covered area."""
    scale = n_in / n_out
    w = np.zeros((n_out, n_in), np.float32)
    for j in range(n_out):
        a, b = j * scale, (j + 1) * scale
        lo, hi = int(np.floor(a)), int(min(np.ceil(b), n_in))
        for i in range(lo, hi):
            w[j, i] = min(b, i + 1) - max(a, i)
    return w / w.sum(axis=1, keepdims=True)


def resize_area(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """cv2.resize INTER_AREA parity on (..., H, W): the pixel-area mean for
    integer shrink factors, fractional coverage weights for a non-integer
    downscale, bilinear for an upscale (as cv2). The weighted sums run in
    float64, so no TF32 matmul can touch them."""
    h, w = img.shape[-2:]
    if h % out_h == 0 and w % out_w == 0 and h >= out_h and w >= out_w:
        fy, fx = h // out_h, w // out_w
        return img.reshape(*img.shape[:-2], out_h, fy, out_w, fx).mean(dim=(-3, -1))
    if h >= out_h and w >= out_w:
        wy = torch.from_numpy(_area_weights(h, out_h)).to(img.device, torch.float64)
        wx = torch.from_numpy(_area_weights(w, out_w)).to(img.device, torch.float64)
        x = torch.einsum("oh,...hw->...ow", wy, img.double())
        return torch.einsum("...hw,ow->...ho", x, wx).to(img.dtype)
    return resize_bilinear(img, out_h, out_w)


def conv2d_single(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """VALID 2-D correlation of (..., H, W) with a (kh, kw) kernel, in
    img's dtype; TF32 is off, so float32 stays float32."""
    h, w = img.shape[-2:]
    x = img.reshape(-1, 1, h, w)
    k = kernel.to(device=img.device, dtype=img.dtype)[None, None]
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        y = torch.nn.functional.conv2d(x, k)
    return y.reshape(*img.shape[:-2], *y.shape[-2:])


def threshold_binary(img: torch.Tensor, thresh: float, maxval: float = 255.0) -> torch.Tensor:
    """cv2.threshold(..., THRESH_BINARY) parity: img > thresh -> maxval
    else 0, in img's dtype."""
    return torch.where(img > thresh, torch.full_like(img, maxval), torch.zeros_like(img))
