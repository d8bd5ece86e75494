"""One pyramid level of LK for N points: the CUDA kernel `lk_level`
(csrc/lk_level.cu) and its plain PyTorch version `lk_level_reference`.

Port of the level iteration that four TPU kernels carry in the JAX
package: ops/lk_pallas3.py::lk_iterate_grid_lanes_packed (grid top level),
ops/lk_pallas3.py::lk_iterate_grid_lanes (grid lower levels, and the
tracker's arbitrary points with points_lanes), ops/lk_pallas.py::lk_iterate
(the v1 per-point kernel) and the crop carve
ops/carve_pallas.py::gather_rects_panels. Semantics (lk_pallas3.py and
lk_pallas.py bodies): per point,

- structure tensor A from the template gradients, OpenCV's fixed-point
  scale (x 1/1024), spectral gate minEig < threshold or det < FLT_EPSILON;
  a bad template kills status at level 0 and only deactivates the point
  above it;
- a crop of the padded next-level plane at the padded origin
  `crop_org + pad`, clamped into the plane as XLA's dynamic_slice clamps
  it. Each iteration samples the bilinear window at the window's integer
  position ix, offset into the crop by clamp(ix - ref, 0, 2m) (the freeze
  envelope), with the fraction of the unclamped position, and quantizes it
  to the 1/32 W_BITS grid. Two crop geometries:
  "centred" (lanes kernels): (win+1+2m) px per axis, ref = crop_org, the
  unclamped origin (the callers' pads keep live crops unclamped);
  "v1" (lk_iterate): a square of max(win)+2m+2 px, ref = the CLAMPED
  origin minus pad (lk_pallas.py:106-107), so points whose slab was
  clamped at the plane's edge sample the pixels the v1 kernel samples;
- Gauss-Newton step, |delta|^2 <= eps^2 convergence, the oscillation
  damper (j > 0; convergence wins), oob (floor outside
  [-win, level_size)) deactivates and kills status at level 0 only;
  inactive points keep their estimate.

The A and b sums are taken in float64: every term lies on the 1/1024 grid
and is exact there, so the sums are exact and the kernel, which sums in
double too, reproduces this version bit for bit in any summation order.
(JAX's v1 kernel sums in float32, so the port meets it to a tolerance.)
"""

from __future__ import annotations

import ctypes

import torch

_CV_SCALE = 1.0 / 1024.0
_FLT_EPSILON = 1.1920929e-07


def _fix(x: torch.Tensor) -> torch.Tensor:
    """OpenCV's W_BITS window quantization (1/32-intensity grid)."""
    return torch.floor(x * 32.0 + 0.5) * (1.0 / 32.0)


def _sum64(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact per-point sum of x*y over the window axes, rounded to f32."""
    return (x.double() * y.double()).sum(dim=(1, 2)).float()


GEOMETRIES = ("centred", "v1")


def crop_size(geometry: str, m: int, win_w: int, win_h: int) -> tuple[int, int]:
    """(width, height) of a point's crop in `geometry`."""
    if geometry == "centred":
        return win_w + 1 + 2 * m, win_h + 1 + 2 * m
    if geometry == "v1":
        s = max(win_w, win_h) + 2 * m + 2
        return s, s
    raise ValueError(f"geometry must be one of {GEOMETRIES}, got {geometry!r}")


def lk_level_reference(
    tmpl: torch.Tensor,
    plane_p: torch.Tensor,
    pad: int,
    tl0: torch.Tensor,
    crop_org: torch.Tensor,
    status0: torch.Tensor,
    *,
    m: int,
    win_w: int,
    win_h: int,
    level_w: int,
    level_h: int,
    max_iters: int,
    eps2: float,
    is_level0: bool,
    min_eig_threshold: float,
    geometry: str = "centred",
    stats: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `lk_level`, batched over points; same
    arguments and results. If `stats` is a dict, it receives the work the
    kernel does on these inputs: "good" points (templates past the
    spectral gate; each loads a crop) and "iterations" (point-iterations
    that sample a window), read from the device."""
    dev = tmpl.device
    iw, ixw, iyw = tmpl[:, 0], tmpl[:, 1], tmpl[:, 2]
    a11 = _sum64(ixw, ixw) * _CV_SCALE
    a12 = _sum64(ixw, iyw) * _CV_SCALE
    a22 = _sum64(iyw, iyw) * _CV_SCALE
    det = a11 * a22 - a12 * a12
    d = a11 - a22
    min_eig = (a22 + a11 - torch.sqrt(d * d + 4.0 * a12 * a12)) / (
        2.0 * win_w * win_h
    )
    bad = (min_eig < min_eig_threshold) | (det < _FLT_EPSILON)
    inv_det = torch.where(det > 0, 1.0 / det, torch.zeros_like(det))

    status = status0 & ~bad if is_level0 else status0.clone()
    active = ~bad
    if stats is not None:
        stats["good"] = int(active.sum())
    tlx, tly = tl0[:, 0].clone(), tl0[:, 1].clone()
    pdx = torch.zeros_like(tlx)
    pdy = torch.zeros_like(tly)

    # crop origin in the padded plane, clamped as dynamic_slice clamps it;
    # window offsets count from the unclamped origin (centred) or from the
    # clamped one (v1)
    hp, wp = plane_p.shape
    cw, ch = crop_size(geometry, m, win_w, win_h)
    ox0 = torch.clamp(crop_org[:, 0] + pad, 0, wp - cw)
    oy0 = torch.clamp(crop_org[:, 1] + pad, 0, hp - ch)
    if geometry == "v1":
        cbx, cby = ox0 - pad, oy0 - pad
    else:
        cbx, cby = crop_org[:, 0], crop_org[:, 1]
    rr = torch.arange(win_h + 1, device=dev)
    cc = torch.arange(win_w + 1, device=dev)

    for j in range(max_iters):
        ixf = torch.floor(tlx)
        iyf = torch.floor(tly)
        oob = (ixf < -win_w) | (ixf >= level_w) | (iyf < -win_h) | (iyf >= level_h)
        if is_level0:
            status = status & ~(active & oob)
        active = active & ~oob
        if stats is not None:
            stats["iterations"] = stats.get("iterations", 0) + int(active.sum())

        ax = (tlx - ixf)[:, None, None]
        ay = (tly - iyf)[:, None, None]
        ox = torch.clamp(ixf.to(torch.int32) - cbx, 0, 2 * m)
        oy = torch.clamp(iyf.to(torch.int32) - cby, 0, 2 * m)
        rows = (oy0 + oy)[:, None] + rr  # (N, win_h+1)
        cols = (ox0 + ox)[:, None] + cc  # (N, win_w+1)
        raw = plane_p[rows[:, :, None], cols[:, None, :]]
        jw = _fix(
            raw[:, :win_h, :win_w] * (1 - ax) * (1 - ay)
            + raw[:, :win_h, 1:] * ax * (1 - ay)
            + raw[:, 1:, :win_w] * (1 - ax) * ay
            + raw[:, 1:, 1:] * ax * ay
        )
        diff = jw - iw
        b1 = _sum64(diff, ixw) * _CV_SCALE
        b2 = _sum64(diff, iyw) * _CV_SCALE
        dx = (a12 * b2 - a22 * b1) * inv_det
        dy = (a12 * b1 - a11 * b2) * inv_det
        tlx = torch.where(active, tlx + dx, tlx)
        tly = torch.where(active, tly + dy, tly)
        converged = dx * dx + dy * dy <= eps2
        osc = (
            (j > 0)
            & (torch.abs(dx + pdx) < 0.01)
            & (torch.abs(dy + pdy) < 0.01)
            & ~converged
        )
        tlx = torch.where(active & osc, tlx - dx * 0.5, tlx)
        tly = torch.where(active & osc, tly - dy * 0.5, tly)
        active = active & ~(converged | osc)
        pdx, pdy = dx, dy
    return torch.stack([tlx, tly], dim=-1), status


def _check(name, t, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _lib():
    from ..kernels import load

    lib = load("lk_level")
    fn = lib.lk_level_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [
            p, p, i, i, i, p, p, p, p, p,  # tmpl .. status_out
            i, i, i, i, i, i, i, f, i, f,  # n .. min_eig_threshold
            i,  # v1 geometry
            p,  # stream
        ]
        fn.restype = ctypes.c_int
        lib.lk_level_max_pixels.argtypes = []
        lib.lk_level_max_pixels.restype = ctypes.c_int
    return lib


def lk_level(
    tmpl: torch.Tensor,
    plane_p: torch.Tensor,
    pad: int,
    tl0: torch.Tensor,
    crop_org: torch.Tensor,
    status0: torch.Tensor,
    *,
    m: int,
    win_w: int,
    win_h: int,
    level_w: int,
    level_h: int,
    max_iters: int,
    eps2: float,
    is_level0: bool,
    min_eig_threshold: float,
    geometry: str = "centred",
) -> tuple[torch.Tensor, torch.Tensor]:
    """LK iterations of one pyramid level.

    tmpl: (N, 3, win_h, win_w) f32 template image/d/dx/d/dy windows.
    plane_p: (Hp, Wp) f32 next-frame level plane, padded by `pad`.
    tl0: (N, 2) f32 initial window top-lefts [x, y] (unpadded).
    crop_org: (N, 2) i32 unpadded crop origins [x, y].
    status0: (N,) bool.
    geometry: "centred" or "v1" (module docstring).
    Returns (top-lefts (N, 2) f32, status (N,) bool).

    CPU tensors run `lk_level_reference`; CUDA tensors launch the kernel
    (counted in `lk_level.launches`) or raise."""
    dev = tmpl.device
    n = tmpl.shape[0]
    _check("tmpl", tmpl, torch.float32, (n, 3, win_h, win_w), dev)
    if plane_p.dim() != 2:
        raise ValueError(f"plane_p must be 2-D, got shape {tuple(plane_p.shape)}")
    _check("plane_p", plane_p, torch.float32, plane_p.shape, dev)
    _check("tl0", tl0, torch.float32, (n, 2), dev)
    _check("crop_org", crop_org, torch.int32, (n, 2), dev)
    _check("status0", status0, torch.bool, (n,), dev)
    hp, wp = plane_p.shape
    cw, ch = crop_size(geometry, m, win_w, win_h)
    if hp < ch or wp < cw:
        raise ValueError(f"plane {hp}x{wp} smaller than the {ch}x{cw} crop")
    statics = dict(
        m=m, win_w=win_w, win_h=win_h, level_w=level_w, level_h=level_h,
        max_iters=max_iters, eps2=eps2, is_level0=is_level0,
        min_eig_threshold=min_eig_threshold, geometry=geometry,
    )
    if dev.type == "cpu":
        return lk_level_reference(tmpl, plane_p, pad, tl0, crop_org, status0, **statics)
    if dev.type != "cuda":
        raise ValueError(f"lk_level runs on cpu or cuda tensors, not {dev.type}")

    lib = _lib()
    if win_w * win_h > lib.lk_level_max_pixels():
        raise ValueError(f"window {win_w}x{win_h} exceeds the kernel's pixel budget")
    tl_out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    st_out = torch.empty((n,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lk_level_launch(
            tmpl.data_ptr(), plane_p.data_ptr(), hp, wp, pad,
            tl0.data_ptr(), crop_org.data_ptr(), status0.data_ptr(),
            tl_out.data_ptr(), st_out.data_ptr(),
            n, m, win_w, win_h, level_w, level_h, max_iters, eps2,
            int(is_level0), min_eig_threshold, int(geometry == "v1"), stream,
        )
    if rc != 0:
        raise RuntimeError(f"lk_level launch failed: cudaError {rc}")
    lk_level.launches += 1
    return tl_out, st_out


lk_level.launches = 0
