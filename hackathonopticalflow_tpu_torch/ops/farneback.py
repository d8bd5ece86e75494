"""Farneback dense optical flow (port of hackathonopticalflow_tpu/ops/farneback.py,
every warp mode).

cv2.calcOpticalFlowFarneback as the reference calls it (DenseOF.py:127-157:
pyr_scale 0.5, levels 3, winsize 15, iterations 3, poly_n 5, poly_sigma
1.2, flags 0):

- per level: GaussianBlur of the full-resolution frame with sigma =
  (1/scale - 1)/2 (kernel round(5 sigma)|1, at least 3), then an
  INTER_LINEAR resize; not a recursive pyramid;
- polynomial expansion: separable Gaussian-weighted moments {g, x g,
  x^2 g} (replicate borders) combined into 5 coefficient channels
  [b_y, b_x, a_yy, a_xx, a_xy];
- matrix update: the second frame's coefficients warped by the current
  flow, averaging, delta-b linearized at the flow, OpenCV's edge
  down-weighting, the 5-channel normal-equation field M. The warp mode
  (FarnebackParams.warp_mode) picks how the coefficients are warped: the
  `warp_bilinear` kernel's gather geometry ("exact"; "packed" on planes
  0-3 rounded to bf16), its slab geometry ("pallas"; "pallas_bf16" on a
  bf16 source), or a warp of the smoothed frame re-expanded ("image";
  "hybrid": image warps, an exact last update per level);
- flow update: box sums of M over winsize (doubling order; an
  integral-image "cumsum" box in the pallas modes; replicate border) or
  the Gaussian window, then the 1e-3-damped 2x2 solve;
- coarse to fine: INTER_LINEAR flow upscale times 1/pyr_scale.

Every function takes leading batch axes: frames (..., H, W), coefficients
(..., 5, H, W), flow (..., H, W, 2). All arithmetic is elementwise, a
fixed-order shifted sum or a cumulative sum along one image axis, so a
batch row equals the single-pair call bit for bit.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..core import FarnebackParams
from .image import box_sum, corr1d, gaussian_blur, pad_axis, resize_area, resize_bilinear, sep_conv2d
from .warp import warp_image
from .warp_bilinear import warp_bilinear

# OpenCV edge down-weighting band (optflowgf.cpp FarnebackUpdateMatrices).
_BORDER = 5
_BORDER_SCALE = np.array([0.14, 0.14, 0.4472, 0.4472, 0.4472], np.float32)

# FarnebackParams.warp_mode values: the coefficient modes warp the second
# frame's 5 coefficient planes; "image" and "hybrid" warp its smoothed
# frame and re-expand it
COEF_MODES = ("exact", "packed", "pallas", "pallas_bf16")
WARP_MODES = COEF_MODES + ("image", "hybrid")
_SLAB_MODES = ("pallas", "pallas_bf16")


def resolve_mode(params: FarnebackParams) -> FarnebackParams:
    """params with warp_mode "auto" resolved to "exact", as the JAX
    package resolves it off a TPU (on a TPU it picks "pallas",
    ops/farneback.py:367-371); raises ValueError on an unknown mode."""
    if params.warp_mode == "auto":
        return dataclasses.replace(params, warp_mode="exact")
    if params.warp_mode not in WARP_MODES:
        raise ValueError(f"unknown warp_mode {params.warp_mode!r}")
    return params


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


def warp_source(r1: torch.Tensor, mode: str) -> torch.Tensor:
    """The second frame's coefficients (..., 5, H, W) as `mode`'s warp
    reads them: "packed" rounds channels 0-3 to bf16 and back (JAX's bf16
    pairs, _warp5_packed) and keeps channel 4 in float32; "pallas_bf16"
    rounds all 5 to bf16 (the TPU's bf16 slab); the other modes read them
    as they are. Both roundings are to nearest, ties to even, as JAX's
    astype. r1 is fixed across a level's iterations, so the level rounds
    it once."""
    if mode == "packed":
        return torch.cat([r1[..., :4, :, :].to(torch.bfloat16).to(torch.float32), r1[..., 4:, :, :]], dim=-3)
    if mode == "pallas_bf16":
        return r1.to(torch.bfloat16)
    return r1


def _update_from_source(r0: torch.Tensor, src: torch.Tensor, flow: torch.Tensor, mode: str) -> torch.Tensor:
    """update_matrices on src = warp_source(r1, mode)."""
    h, w = r0.shape[-2:]
    dx = flow[..., 0]
    dy = flow[..., 1]
    xs, ys = _pixel_coords(h, w, flow.device)
    fx = xs + dx
    fy = ys + dy
    x1 = torch.floor(fx)
    y1 = torch.floor(fy)
    inside = (x1 >= 0) & (x1 < w - 1) & (y1 >= 0) & (y1 < h - 1)
    w2 = warp_bilinear(src, fx, fy, "slab" if mode in _SLAB_MODES else "gather")
    return _assemble_m(r0, w2, inside, dx, dy, h, w)


def update_matrices(r0: torch.Tensor, r1: torch.Tensor, flow: torch.Tensor, mode: str = "exact") -> torch.Tensor:
    """The 5-channel normal-equation field M (..., 5, H, W) from both
    frames' coefficients (..., 5, H, W) and the current flow (..., H, W, 2)
    (OpenCV FarnebackUpdateMatrices; JAX update_matrices).

    mode picks the coefficient warp: "exact" and "packed" (on
    warp_source's rounded planes) sample in `warp_bilinear`'s gather
    geometry, "pallas" and "pallas_bf16" (on a bf16 source) in its slab
    geometry, the TPU kernel's function. The warp clamps the fractions
    where JAX's exact gather does not; the two differ only where `inside`
    is false, and there `_assemble_m` discards the warped value. JAX falls
    back to its exact gather where the slab does not fit the plane (H or
    W < 2, warp_pallas.py::supports); both geometries here need H, W >= 2
    and raise on such a plane, so there is nothing to fall back to."""
    return _update_from_source(r0, warp_source(r1, mode), flow, mode)


def update_matrices_prewarped(r0: torch.Tensor, r1w: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """update_matrices when r1w (..., 5, H, W) is already displaced by the
    current flow: the "image" warp mode warps the smoothed frame and
    re-expands it (JAX update_matrices_prewarped). `inside` is tested on
    the unfloored coordinates, as JAX does; the assembly is the same."""
    h, w = r0.shape[-2:]
    dx = flow[..., 0]
    dy = flow[..., 1]
    xs, ys = _pixel_coords(h, w, flow.device)
    fx = xs + dx
    fy = ys + dy
    inside = (fx >= 0) & (fx < w - 1) & (fy >= 0) & (fy < h - 1)
    return _assemble_m(r0, r1w, inside, dx, dy, h, w)


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


def update_flow_blur(m: torch.Tensor, win_size: int, method: str = "doubling") -> torch.Tensor:
    """Flow (..., H, W, 2) from box-averaged M (OpenCV
    FarnebackUpdateFlow_blur: window sums scaled by 1/win^2, then the
    damped 2x2 solve).

    method="doubling": ops/image.box_sum (the JAX package's summation
    order; the exact path). method="cumsum" (the pallas modes): an
    integral image, the edge-padded M (pad r+1 before, r after, r =
    win//2) summed by two torch.cumsum (rows, then columns) and two
    subtractions. Its running sums round differently per device (a
    sequential float64 accumulation on the CPU, a parallel float32 scan on
    CUDA, a windowed reduction in XLA), so it matches JAX within a
    tolerance, not bit for bit. Only odd windows fit the pad."""
    if method == "cumsum":
        if win_size % 2 != 1:
            raise ValueError(f"cumsum box requires odd win_size, got {win_size}")
        r = win_size // 2
        p = pad_axis(pad_axis(m, -2, r + 1, r, "edge"), -1, r + 1, r, "edge")
        c = torch.cumsum(p, dim=-2)
        rows = c[..., win_size:, :] - c[..., :-win_size, :]
        c2 = torch.cumsum(rows, dim=-1)
        ms = c2[..., win_size:] - c2[..., :-win_size]
    elif method == "doubling":
        ms = box_sum(m, win_size, mode="edge")
    else:
        raise ValueError(f"unknown box method {method!r}")
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


def _level_images(img: torch.Tensor, params: FarnebackParams) -> list[torch.Tensor]:
    """The blurred, resized frame (..., Hk, Wk) float32 of each level,
    coarse -> fine."""
    img = img.to(torch.float32)
    h, w = img.shape[-2:]
    out = []
    for hk, wk, sigma, smooth_sz in _level_shapes(h, w, params):
        smoothed = gaussian_blur(img, smooth_sz, sigma)
        if (hk, wk) != (h, w):
            smoothed = resize_bilinear(smoothed, hk, wk)
        out.append(smoothed)
    return out


def prepare_frame(img: torch.Tensor, params: FarnebackParams = FarnebackParams()) -> tuple[torch.Tensor, ...]:
    """Per-level polynomial-expansion pyramid of one frame (..., H, W),
    coarse -> fine: a tuple of (..., 5, Hk, Wk). In a clip each frame is
    the second frame of one pair and the first of the next, so it is
    prepared once."""
    resolve_mode(params)
    return tuple(poly_exp(s, params.poly_n, params.poly_sigma) for s in _level_images(img, params))


def _init_top_flow(flow0: torch.Tensor, hk: int, wk: int, scale: float) -> torch.Tensor:
    """OPTFLOW_USE_INITIAL_FLOW seed at the top level: INTER_AREA resize
    of the caller's full-resolution flow, scaled by the level's scale."""
    f = flow0.to(torch.float32).movedim(-1, -3)
    if f.shape[-2:] != (hk, wk):
        f = resize_area(f, hk, wk)
    return f.movedim(-3, -1) * scale


def _level_flow(flow, flow0, lead: tuple, hk: int, wk: int, params: FarnebackParams, device) -> torch.Tensor:
    """The flow (*lead, Hk, Wk, 2) a level starts from: the coarser
    level's, upscaled; at the top level flow0's seed, or zero."""
    if flow is not None:
        return resize_bilinear(flow.movedim(-1, -3), hk, wk).movedim(-3, -1) * (1.0 / params.pyr_scale)
    if flow0 is not None:
        return _init_top_flow(flow0, hk, wk, params.pyr_scale**params.levels)
    return torch.zeros((*lead, hk, wk, 2), dtype=torch.float32, device=device)


def _solve_flow(m: torch.Tensor, params: FarnebackParams) -> torch.Tensor:
    if params.gaussian_win:
        return update_flow_gaussian(m, params.win_size)
    # the pallas modes take the integral-image box, as on the TPU
    method = "cumsum" if params.warp_mode in _SLAB_MODES else "doubling"
    return update_flow_blur(m, params.win_size, method)


def farneback_prepared(
    rs_prev: tuple[torch.Tensor, ...],
    rs_next: tuple[torch.Tensor, ...],
    params: FarnebackParams = FarnebackParams(),
    flow0: torch.Tensor | None = None,
) -> torch.Tensor:
    """farneback() on prepare_frame() pyramids; flow (..., H, W, 2). The
    coefficient warp modes only: "image" and "hybrid" re-expand the frame
    inside the iteration and raise ValueError here (JAX asserts)."""
    params = resolve_mode(params)
    if params.warp_mode not in COEF_MODES:
        raise ValueError(
            f"farneback_prepared runs the coefficient warp modes {COEF_MODES}, not "
            f"{params.warp_mode!r}, which re-expands the frame: call farneback"
        )
    flow = None
    for r0, r1 in zip(rs_prev, rs_next):
        hk, wk = r0.shape[-2:]
        flow = _level_flow(flow, flow0, r0.shape[:-3], hk, wk, params, r0.device)
        src = warp_source(r1, params.warp_mode)
        m = _update_from_source(r0, src, flow, params.warp_mode)
        for i in range(params.iterations):
            flow = _solve_flow(m, params)
            if i < params.iterations - 1:
                m = _update_from_source(r0, src, flow, params.warp_mode)
    return flow


def farneback(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    params: FarnebackParams = FarnebackParams(),
    flow0: torch.Tensor | None = None,
) -> torch.Tensor:
    """Dense flow (..., H, W, 2) from prev to nxt grayscale frames
    (..., H, W) in [0, 255], in every warp mode. cv2.calcOpticalFlowFarneback
    parity; flags map onto params.gaussian_win (OPTFLOW_FARNEBACK_GAUSSIAN)
    and flow0 (OPTFLOW_USE_INITIAL_FLOW: pass the previous flow,
    (..., H, W, 2)).

    The coefficient modes run farneback_prepared on both frames' pyramids.
    "image" warps the level's smoothed second frame by the flow
    (ops/warp.py::warp_image) and re-expands it for every matrix update;
    "hybrid" does so for the early updates and takes the exact coefficient
    warp for each level's last one."""
    params = resolve_mode(params)
    if params.warp_mode in COEF_MODES:
        return farneback_prepared(prepare_frame(prev, params), prepare_frame(nxt, params), params, flow0)
    n, sigma = params.poly_n, params.poly_sigma
    flow = None
    for img0, img1 in zip(_level_images(prev, params), _level_images(nxt, params)):
        hk, wk = img0.shape[-2:]
        flow = _level_flow(flow, flow0, img0.shape[:-2], hk, wk, params, img0.device)
        r0 = poly_exp(img0, n, sigma)

        def update_image(fl, r0=r0, img1=img1):
            return update_matrices_prewarped(r0, poly_exp(warp_image(img1, fl), n, sigma), fl)

        if params.warp_mode == "hybrid":
            r1 = poly_exp(img1, n, sigma)

            def update_last(fl, r0=r0, r1=r1):
                return update_matrices(r0, r1, fl, "exact")
        else:
            update_last = update_image
        m = update_image(flow) if params.iterations > 1 else update_last(flow)
        for i in range(params.iterations):
            flow = _solve_flow(m, params)
            if i < params.iterations - 1:
                m = update_last(flow) if i == params.iterations - 2 else update_image(flow)
    return flow
