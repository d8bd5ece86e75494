"""Farneback dense optical flow (port of hackathonopticalflow_tpu/ops/farneback.py,
warp_mode "exact").

cv2.calcOpticalFlowFarneback as the reference calls it (DenseOF.py:127-157:
pyr_scale 0.5, levels 3, winsize 15, iterations 3, poly_n 5, poly_sigma
1.2, flags 0):

- per level: GaussianBlur of the full-resolution frame with sigma =
  (1/scale - 1)/2 (kernel round(5 sigma)|1, at least 3), then an
  INTER_LINEAR resize; not a recursive pyramid;
- polynomial expansion: separable Gaussian-weighted moments {g, x g,
  x^2 g} (replicate borders) combined into 5 coefficient channels
  [b_y, b_x, a_yy, a_xx, a_xy];
- matrix update: bilinear warp of the second frame's coefficients by the
  current flow (the `warp_bilinear` kernel), averaging, delta-b
  linearized at the flow, OpenCV's edge down-weighting, the 5-channel
  normal-equation field M;
- flow update: box sums of M over winsize (doubling order, replicate
  border) or the Gaussian window, then the 1e-3-damped 2x2 solve;
- coarse to fine: INTER_LINEAR flow upscale times 1/pyr_scale.

Every function takes leading batch axes: frames (..., H, W), coefficients
(..., 5, H, W), flow (..., H, W, 2). All arithmetic is elementwise or a
fixed-order shifted sum, so a batch row equals the single-pair call bit
for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..core import FarnebackParams
from .image import box_sum, corr1d, gaussian_blur, resize_area, resize_bilinear, sep_conv2d
from .warp_bilinear import warp_bilinear

# OpenCV edge down-weighting band (optflowgf.cpp FarnebackUpdateMatrices).
_BORDER = 5
_BORDER_SCALE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)

# warp modes of the JAX package that the port does not run (ROADMAP.md,
# queue 1, item 5), with what each would bring
_UNPORTED_MODES = {
    "packed": "bf16-pair coefficient gathers",
    "pallas": "the TPU slab warp with the cumsum box sum",
    "pallas_bf16": "bf16 slabs with the cumsum box sum",
    "image": "warp the frame and re-expand it",
    "hybrid": "image warps, an exact last update",
}


def check_warp_mode(params: FarnebackParams) -> None:
    """Raise unless params.warp_mode is one the port runs ('auto', 'exact')."""
    mode = params.warp_mode
    if mode in ("auto", "exact"):
        return
    if mode in _UNPORTED_MODES:
        raise NotImplementedError(
            f"warp_mode={mode!r} ({_UNPORTED_MODES[mode]}) is not ported yet: ROADMAP.md, queue 1, item 5"
        )
    raise ValueError(f"unknown warp_mode {mode!r}")


@functools.lru_cache(maxsize=None)
def _poly_exp_consts(n: int, sigma: float):
    """Gaussian moment taps and inverse-Gram entries (float64 host math,
    as OpenCV's FarnebackPrepareGaussian)."""
    if sigma < 1e-7:
        sigma = n * 0.3
    x = np.arange(-n, n + 1, dtype=np.float64)
    g = np.exp(-(x**2) / (2.0 * sigma * sigma))
    g /= g.sum()
    xg = x * g
    xxg = x * x * g

    # Gram matrix of basis {1, x, y, x^2, y^2, xy} under w(x,y)=g(x)g(y)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    w = np.outer(g, g)
    basis = np.stack([np.ones_like(xx), xx, yy, xx**2, yy**2, xx * yy], axis=0).reshape(6, -1)
    gram = (basis * w.reshape(1, -1)) @ basis.T
    inv = np.linalg.inv(gram)
    return (
        g.astype(np.float32),
        xg.astype(np.float32),
        xxg.astype(np.float32),
        float(inv[1, 1]),
        float(inv[0, 3]),
        float(inv[3, 3]),
        float(inv[5, 5]),
    )


@functools.lru_cache(maxsize=16)
def _poly_taps(n: int, sigma: float, device: torch.device):
    """Per-channel taps of the two moment passes: vertical (g, xg, xxg) ->
    s0, s1, s2; horizontal b1..b6 = (s0 g, s0 xg, s1 g, s2 g, s0 xxg,
    s1 xg), with the index of each b's source channel."""
    g, xg, xxg = _poly_exp_consts(n, sigma)[:3]
    vert = torch.from_numpy(np.stack([g, xg, xxg])).to(device)
    horiz = torch.from_numpy(np.stack([g, xg, g, g, xxg, xg])).to(device)
    source = torch.tensor([0, 0, 1, 2, 0, 1], device=device)
    return vert, horiz, source


def poly_exp(img: torch.Tensor, n: int, sigma: float) -> torch.Tensor:
    """Polynomial expansion of (..., H, W) -> (..., 5, H, W) coefficient
    channels [0]=b_y, [1]=b_x, [2]=a_yy, [3]=a_xx, [4]=cross.

    The three vertical and six horizontal moment correlations of the JAX
    version run as two per-channel passes; each channel's taps and
    summation order are the JAX version's."""
    ig11, ig03, ig33, ig55 = _poly_exp_consts(n, sigma)[3:]
    vert, horiz, source = _poly_taps(n, sigma, img.device)
    s = corr1d(img.unsqueeze(-3), vert, -2, "edge")  # s0, s1, s2
    b1, b2, b3, b4, b5, b6 = corr1d(s.index_select(-3, source), horiz, -1, "edge").unbind(-3)
    return torch.stack(
        [b3 * ig11, b2 * ig11, b1 * ig03 + b4 * ig33, b1 * ig03 + b5 * ig33, b6 * ig55],
        dim=-3,
    )


@functools.lru_cache(maxsize=16)
def _border_factor(h: int, w: int, device: torch.device) -> torch.Tensor:
    """Per-pixel edge down-weighting (1 in the interior), (H, W)."""

    def axis_f(n):
        f = np.ones((n,), np.float32)
        b = min(_BORDER, n)
        f[:b] *= _BORDER_SCALE[:b]
        f[n - b :] *= _BORDER_SCALE[:b][::-1]
        return f

    return torch.from_numpy(np.outer(axis_f(h), axis_f(w))).to(device)


@functools.lru_cache(maxsize=16)
def _pixel_coords(h: int, w: int, device: torch.device):
    """float32 column (W,) and row (H, 1) coordinates."""
    xs = torch.arange(w, dtype=torch.float32, device=device)
    ys = torch.arange(h, dtype=torch.float32, device=device)[:, None]
    return xs, ys


def update_matrices(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """The 5-channel normal-equation field M (..., 5, H, W) from both
    frames' coefficients (..., 5, H, W) and the current flow (..., H, W, 2)
    (OpenCV FarnebackUpdateMatrices; JAX warp_mode "exact").

    `warp_bilinear` clamps the fractions where JAX's exact gather does
    not; the two differ only where `inside` is false, and there
    `_assemble_m` discards the warped value."""
    h, w = r0.shape[-2:]
    dx = flow[..., 0]
    dy = flow[..., 1]
    xs, ys = _pixel_coords(h, w, flow.device)
    fx = xs + dx
    fy = ys + dy
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    inside = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)
    w2 = warp_bilinear(r1, fx, fy)
    return _assemble_m(r0, w2, inside, dx, dy, h, w)


def _assemble_m(r0, w2, inside, dx, dy, h, w) -> torch.Tensor:
    """Averaging, delta-b linearization, border weighting and normal-
    equation assembly."""
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
    r2 = r2 * scale
    r3 = r3 * scale
    r4 = r4 * scale
    r5 = r5 * scale
    r6 = r6 * scale

    return torch.stack(
        [
            r4 * r4 + r6 * r6,  # G_yy
            (r4 + r5) * r6,  # G_xy
            r5 * r5 + r6 * r6,  # G_xx
            r4 * r2 + r6 * r3,  # rhs_y
            r6 * r2 + r5 * r3,  # rhs_x
        ],
        dim=-3,
    )


def update_flow_blur(m: torch.Tensor, win_size: int) -> torch.Tensor:
    """Flow (..., H, W, 2) from box-averaged M (OpenCV
    FarnebackUpdateFlow_blur: window sums in the doubling order scaled by
    1/win^2, then the damped 2x2 solve)."""
    ms = box_sum(m, win_size, mode="edge")
    return _cramer_solve(ms * (1.0 / (win_size * win_size)))


@functools.lru_cache(maxsize=None)
def _gauss_win_kernel(win_size: int) -> np.ndarray:
    """OpenCV FarnebackUpdateFlow_GaussianBlur's window kernel: half-width
    m = win//2, sigma = m*0.3, normalized over the full 2m+1 taps."""
    m = win_size // 2
    sigma = m * 0.3
    half = np.exp(-np.arange(m + 1, dtype=np.float64) ** 2 / (2 * sigma * sigma))
    s = half[0] + 2.0 * half[1:].sum()
    half = (half / s).astype(np.float32)
    return np.concatenate([half[:0:-1], half])


def update_flow_gaussian(m: torch.Tensor, win_size: int) -> torch.Tensor:
    """OPTFLOW_FARNEBACK_GAUSSIAN: the window sum is a normalized separable
    Gaussian (replicate borders) instead of a box, then the same solve."""
    k = [float(v) for v in _gauss_win_kernel(win_size)]
    return _cramer_solve(sep_conv2d(m, k, k, mode="edge"))


def _cramer_solve(ms: torch.Tensor) -> torch.Tensor:
    g11, g12, g22, h1, h2 = ms.unbind(-3)
    idet = torch.reciprocal(g11 * g22 - g12 * g12 + 1e-3)
    fx = (g11 * h2 - g12 * h1) * idet
    fy = (g22 * h1 - g12 * h2) * idet
    return torch.stack([fx, fy], dim=-1)


def _level_shapes(h: int, w: int, params: FarnebackParams):
    """(hk, wk, sigma, smooth_sz) per level, coarse -> fine (OpenCV scales
    each level from the ORIGINAL size, not recursively; Python's round
    rounds half to even, as in the JAX package)."""
    out = []
    for k in range(params.levels, -1, -1):
        scale = params.pyr_scale**k
        sigma = (1.0 / scale - 1.0) * 0.5
        smooth_sz = max(int(round(sigma * 5)) | 1, 3)
        out.append((int(round(h * scale)), int(round(w * scale)), sigma, smooth_sz))
    return out


def prepare_frame(img: torch.Tensor, params: FarnebackParams = FarnebackParams()) -> tuple[torch.Tensor, ...]:
    """Per-level polynomial-expansion pyramid of one frame (..., H, W),
    coarse -> fine: a tuple of (..., 5, Hk, Wk). In a clip each frame is
    the second frame of one pair and the first of the next, so it is
    prepared once."""
    check_warp_mode(params)
    img = img.to(torch.float32)
    h, w = img.shape[-2:]
    rs = []
    for hk, wk, sigma, smooth_sz in _level_shapes(h, w, params):
        smoothed = gaussian_blur(img, smooth_sz, sigma)
        if (hk, wk) != (h, w):
            smoothed = resize_bilinear(smoothed, hk, wk)
        rs.append(poly_exp(smoothed, params.poly_n, params.poly_sigma))
    return tuple(rs)


def _init_top_flow(flow0: torch.Tensor, hk: int, wk: int, scale: float) -> torch.Tensor:
    """OPTFLOW_USE_INITIAL_FLOW seed at the top level: INTER_AREA resize
    of the caller's full-resolution flow, scaled by the level's scale."""
    f = flow0.to(torch.float32).movedim(-1, -3)
    if f.shape[-2:] != (hk, wk):
        f = resize_area(f, hk, wk)
    return f.movedim(-3, -1) * scale


def _solve_flow(m: torch.Tensor, params: FarnebackParams) -> torch.Tensor:
    if params.gaussian_win:
        return update_flow_gaussian(m, params.win_size)
    return update_flow_blur(m, params.win_size)


def farneback_prepared(
    rs_prev: tuple[torch.Tensor, ...],
    rs_next: tuple[torch.Tensor, ...],
    params: FarnebackParams = FarnebackParams(),
    flow0: torch.Tensor | None = None,
) -> torch.Tensor:
    """farneback() on prepare_frame() pyramids; flow (..., H, W, 2)."""
    check_warp_mode(params)
    flow = None
    for r0, r1 in zip(rs_prev, rs_next):
        hk, wk = r0.shape[-2:]
        if flow is None:
            if flow0 is not None:
                flow = _init_top_flow(flow0, hk, wk, params.pyr_scale**params.levels)
            else:
                flow = torch.zeros((*r0.shape[:-3], hk, wk, 2), dtype=torch.float32, device=r0.device)
        else:
            flow = resize_bilinear(flow.movedim(-1, -3), hk, wk).movedim(-3, -1) * (1.0 / params.pyr_scale)
        m = update_matrices(r0, r1, flow)
        for i in range(params.iterations):
            flow = _solve_flow(m, params)
            if i < params.iterations - 1:
                m = update_matrices(r0, r1, flow)
    return flow


def farneback(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    params: FarnebackParams = FarnebackParams(),
    flow0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dense flow (..., H, W, 2) from prev to nxt grayscale frames
    (..., H, W) in [0, 255]. cv2.calcOpticalFlowFarneback parity; flags
    map onto params.gaussian_win (OPTFLOW_FARNEBACK_GAUSSIAN) and flow0
    (OPTFLOW_USE_INITIAL_FLOW: pass the previous flow, (..., H, W, 2))."""
    return farneback_prepared(prepare_frame(prev, params), prepare_frame(nxt, params), params, flow0)
