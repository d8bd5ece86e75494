"""Separable correlation with BORDER_REFLECT_101 (port of
hackathonopticalflow_tpu/ops/image.py::sep_conv2d, reflect mode).

The passes are shifted multiply-adds, as the JAX package's TPU branch
computes them, never F.conv2d: cuDNN runs float32 convolutions in TF32 by
default, which breaks the floor(x + 0.5) u8 quantization of the pyramid."""

from __future__ import annotations

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


def reflect101_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the last two axes of x by `pad` on every side, reflect-101."""
    h, w = x.shape[-2:]
    iy = reflect101_index(h, pad, pad, x.device)
    ix = reflect101_index(w, pad, pad, x.device)
    return x.index_select(-2, iy).index_select(-1, ix)


def sep_conv2d(img: torch.Tensor, ky, kx) -> torch.Tensor:
    """Separable 2-D correlation of (..., H, W) with taps ky (rows) and kx
    (columns), reflect-101 border, same-size output. Taps are Python
    floats; the x pass runs first, then the y pass."""
    ry, rx = len(ky) // 2, len(kx) // 2
    h, w = img.shape[-2:]
    x = img.index_select(-1, reflect101_index(w, rx, rx, img.device))
    acc = x[..., 0:w] * kx[0]
    for t in range(1, len(kx)):
        acc = acc + x[..., t : t + w] * kx[t]
    x = acc.index_select(-2, reflect101_index(h, ry, ry, img.device))
    acc = x[..., 0:h, :] * ky[0]
    for t in range(1, len(ky)):
        acc = acc + x[..., t : t + h, :] * ky[t]
    return acc
