"""One pyramid level of LK for N points: the CUDA kernel `lk_level`
(csrc/lk_level.cu) and its plain PyTorch version `lk_level_reference`.

Port of the level iteration that five TPU kernels carry in the JAX
package: ops/lk_pallas3.py::lk_iterate_grid_lanes_packed (grid top level),
ops/lk_pallas3.py::lk_iterate_grid_lanes (grid lower levels, phase A's
anchored crops included, and the tracker's arbitrary points with
points_lanes), ops/lk_pallas2.py::lk_iterate_grid (the blocked grid
kernel), ops/lk_pallas.py::lk_iterate (the v1 per-point kernel) and the
crop carve ops/carve_pallas.py::gather_rects_panels; and of the exact XLA
path of ops/lk.py::_level_lk. Semantics (lk_pallas2.py, lk_pallas3.py,
lk_pallas.py and lk.py bodies): per point,

- structure tensor A from the template gradients, OpenCV's fixed-point
  scale (x 1/1024), spectral gate minEig < threshold or det < FLT_EPSILON;
  a bad template kills status at level 0 and only deactivates the point
  above it;
- a point with active0 false (a grid-anchored crop that does not fit in
  its slab: the kernels' `fits`) runs no iteration and keeps tl0; its
  status is left as it is, at level 0 too;
- each iteration samples the bilinear window at the point's estimate and
  quantizes it to the 1/32 W_BITS grid. Four geometries:
  "centred" and "anchored" (lanes and blocked kernels): a crop of
  (win+1+2m) px per axis of the padded next-level plane at the padded
  origin `crop_org + pad`, clamped into the plane as XLA's dynamic_slice
  clamps it; the window sits at its integer position ix offset into the
  crop by clamp(ix - crop_org, 0, 2m) (the freeze envelope), blended
  value-first ((v * bx) * by, the Pallas kernels' _blend) with the
  fraction of the unclamped position. "anchored" names the grid-anchored
  crops, which come with active0; the callers' pads keep live crops
  unclamped in both;
  "v1" (lk_iterate): a square crop of max(win)+2m+2 px, window offsets from
  the CLAMPED origin minus pad (lk_pallas.py:106-107), so points whose slab
  was clamped at the plane's edge sample the pixels the v1 kernel samples;
  "exact" (JAX _level_lk without a slab): no crop; the window is read
  from the plane at floor(tl + pad), placed as dynamic_slice places it
  (patch_bilinear's contract), with the fraction (tl + pad) - floor(tl +
  pad) and weights formed first (blend_bilinear); crop_org and m are
  unused;
- Gauss-Newton step, |delta|^2 <= eps^2 convergence, the oscillation
  damper (j > 0; convergence wins), oob (floor(tl) outside
  [-win, level_size)) deactivates and kills status at level 0 only;
  inactive points keep their estimate.

The A and b sums are taken in float64: every term lies on the 1/1024 grid
and is exact there, so the sums are exact and the kernel reproduces this
version bit for bit in any summation order. The kernel sums the same
terms as integers (x 1024), which holds on what every caller hands it:
templates on the 1/32 grid (`grid_templates`,
`extract_patches_multi(quantize=True)`), gradients within +-128 (Scharr's
1/32 scale on u8 frames) and image values in [0, 255]. (JAX's kernels and
exact path sum in float32, so the port meets them to a tolerance.)

A call may carry several streams: plane_p (B, Hp, Wp) with the points
stream-major (B * n rows, stream b's at rows b*n .. b*n+n-1), so every
stream's level runs in one launch; each point reads its own stream's plane,
with that plane's clamps.

The kernel runs a team of warps per point, sized to the window by
`launch_shape`; windows past MAX_PIXELS take a team that walks the window
in passes, so the kernel takes every window the plain version takes.
"""

from __future__ import annotations

import ctypes

import torch

from .patch_bilinear import patch_bilinear_reference

_CV_SCALE = 1.0 / 1024.0
_FLT_EPSILON = 1.1920929e-07


def _fix(x: torch.Tensor) -> torch.Tensor:
    """OpenCV's W_BITS window quantization (1/32-intensity grid)."""
    return torch.floor(x * 32.0 + 0.5) * (1.0 / 32.0)


def _sum64(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Exact per-point sum of x*y over the window axes, rounded to f32."""
    return (x.double() * y.double()).sum(dim=(1, 2)).float()


# the kernel's geometry codes ("anchored" is "centred" with active0)
GEOMETRIES = {"centred": 0, "anchored": 0, "v1": 1, "exact": 2}

# The kernel's team shapes, (warps per point, window pixels per lane), in
# order of their 32 * warps * k pixel slots; csrc/lk_level.cu instantiates
# exactly these. An iteration's latency grows with the pixels per lane, so
# windows of up to 512 px take 2 per lane on up to 8 warps (the tracker's
# 15 x 15: 4 warps); larger ones 4 or 8 on 8 warps, where fewer
# reductions per pixel pay (the grid's 45 x 45: 8 x 8).
LAUNCH_SHAPES = ((1, 2), (2, 2), (4, 2), (8, 2), (8, 4), (8, 8))
MAX_PIXELS = 32 * 8 * 8
# Windows past MAX_PIXELS: a team of this shape walks the window in passes
# of 32 * 8 * 8 pixels, reading the template's gradients again in every
# iteration (csrc/lk_level.cu's LK_WALK instantiation).
WALK_SHAPE = (8, 8)


def launch_shape(win_w: int, win_h: int) -> tuple[int, int, bool]:
    """(warps per point, pixels per lane, walk) of the kernel's team for a
    win_w x win_h window: the smallest shape of LAUNCH_SHAPES whose slots
    hold the window (at most max(64, 2 * pixels) slots); past MAX_PIXELS,
    WALK_SHAPE walking the window."""
    npix = win_w * win_h
    for warps, k in LAUNCH_SHAPES:
        if 32 * warps * k >= npix:
            return warps, k, False
    return (*WALK_SHAPE, True)


def crop_size(geometry: str, m: int, win_w: int, win_h: int) -> tuple[int, int]:
    """(width, height) of a point's crop in `geometry`: the plane region its
    windows may read (the kernel reads them from the plane; nothing is
    staged); (0, 0) for "exact", which has no crop."""
    if geometry in ("centred", "anchored"):
        return win_w + 1 + 2 * m, win_h + 1 + 2 * m
    if geometry == "v1":
        s = max(win_w, win_h) + 2 * m + 2
        return s, s
    if geometry == "exact":
        return 0, 0
    raise ValueError(f"geometry must be one of {tuple(GEOMETRIES)}, got {geometry!r}")


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
    active0: torch.Tensor | None = None,
    stats: dict | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of `lk_level`, batched over points; same
    arguments and results. If `stats` is a dict, it receives the work the
    kernel does on these inputs: "good" points (active, templates past the
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
    active = ~bad if active0 is None else ~bad & active0
    if stats is not None:
        stats["good"] = int(active.sum())
    tlx, tly = tl0[:, 0].clone(), tl0[:, 1].clone()
    pdx = torch.zeros_like(tlx)
    pdy = torch.zeros_like(tly)

    # crop origin in the padded plane, clamped as dynamic_slice clamps it;
    # window offsets count from the unclamped origin (centred) or from the
    # clamped one (v1)
    hp, wp = plane_p.shape[-2:]
    cw, ch = crop_size(geometry, m, win_w, win_h)
    # (unused in "exact")
    ox0 = torch.clamp(crop_org[:, 0] + pad, 0, wp - cw)
    oy0 = torch.clamp(crop_org[:, 1] + pad, 0, hp - ch)
    if geometry == "v1":
        cbx, cby = ox0 - pad, oy0 - pad
    else:
        cbx, cby = crop_org[:, 0], crop_org[:, 1]
    rr = torch.arange(win_h + 1, device=dev)
    cc = torch.arange(win_w + 1, device=dev)
    planes = plane_p.reshape(-1, hp, wp)  # (B, Hp, Wp); B = 1 for one plane
    n = tmpl.shape[0]
    stream = (torch.arange(n, device=dev) // max(n // planes.shape[0], 1))[:, None, None]

    for j in range(max_iters):
        ixf = torch.floor(tlx)
        iyf = torch.floor(tly)
        oob = (ixf < -win_w) | (ixf >= level_w) | (iyf < -win_h) | (iyf >= level_h)
        if is_level0:
            status = status & ~(active & oob)
        active = active & ~oob
        if stats is not None:
            stats["iterations"] = stats.get("iterations", 0) + int(active.sum())

        if geometry == "exact":
            tl_p = torch.stack([tlx, tly], dim=-1) + float(pad)
            jw = patch_bilinear_reference(planes[:, None], tl_p, win_h, win_w, True)[:, 0]
        else:
            ax = (tlx - ixf)[:, None, None]
            ay = (tly - iyf)[:, None, None]
            ox = torch.clamp(ixf.to(torch.int32) - cbx, 0, 2 * m)
            oy = torch.clamp(iyf.to(torch.int32) - cby, 0, 2 * m)
            rows = (oy0 + oy)[:, None] + rr  # (N, win_h+1)
            cols = (ox0 + ox)[:, None] + cc  # (N, win_w+1)
            raw = planes[stream, rows[:, :, None], cols[:, None, :]]
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
            p, p, i, i, i, i, p, p, p, p, p, p,  # tmpl .. status_out
            i, i, i, i, i, i, i, f, i, f,  # n .. min_eig_threshold
            i, i, i, i,  # geometry code, warps, k, walk
            p,  # stream
        ]
        fn.restype = ctypes.c_int
        occ = lib.lk_level_occupancy
        occ.argtypes = [i, i, i, i, p, p, p, p]
        occ.restype = ctypes.c_int
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
    active0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """LK iterations of one pyramid level.

    tmpl: (N, 3, win_h, win_w) f32 template image/d/dx/d/dy windows.
    plane_p: (Hp, Wp) f32 next-frame level plane, padded by `pad`; or
    (B, Hp, Wp), one per stream, B dividing N: point p reads plane
    p // (N / B) (points stream-major).
    tl0: (N, 2) f32 initial window top-lefts [x, y] (unpadded).
    crop_org: (N, 2) i32 unpadded crop origins [x, y].
    status0: (N,) bool.
    geometry: "centred", "anchored", "v1" or "exact" (module docstring).
    active0: (N,) bool or None (all true): points that may iterate.
    Returns (top-lefts (N, 2) f32, status (N,) bool).

    CPU tensors run `lk_level_reference`; CUDA tensors launch the kernel
    (counted in `lk_level.launches`) or raise."""
    dev = tmpl.device
    n = tmpl.shape[0]
    _check("tmpl", tmpl, torch.float32, (n, 3, win_h, win_w), dev)
    if plane_p.dim() not in (2, 3):
        raise ValueError(f"plane_p must be (Hp, Wp) or (B, Hp, Wp), got shape {tuple(plane_p.shape)}")
    _check("plane_p", plane_p, torch.float32, plane_p.shape, dev)
    nb = plane_p.shape[0] if plane_p.dim() == 3 else 1
    if nb < 1 or n % nb:
        raise ValueError(f"{n} points do not split over {nb} planes")
    _check("tl0", tl0, torch.float32, (n, 2), dev)
    _check("crop_org", crop_org, torch.int32, (n, 2), dev)
    _check("status0", status0, torch.bool, (n,), dev)
    if active0 is not None:
        _check("active0", active0, torch.bool, (n,), dev)
    hp, wp = plane_p.shape[-2:]
    cw, ch = crop_size(geometry, m, win_w, win_h)
    cw, ch = max(cw, win_w + 1), max(ch, win_h + 1)
    if hp < ch or wp < cw:
        raise ValueError(f"plane {hp}x{wp} smaller than the {ch}x{cw} crop")
    statics = dict(
        m=m, win_w=win_w, win_h=win_h, level_w=level_w, level_h=level_h,
        max_iters=max_iters, eps2=eps2, is_level0=is_level0,
        min_eig_threshold=min_eig_threshold, geometry=geometry, active0=active0,
    )
    if dev.type == "cpu":
        return lk_level_reference(tmpl, plane_p, pad, tl0, crop_org, status0, **statics)
    if dev.type != "cuda":
        raise ValueError(f"lk_level runs on cpu or cuda tensors, not {dev.type}")

    warps, k, walk = launch_shape(win_w, win_h)
    lib = _lib()
    tl_out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    st_out = torch.empty((n,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lk_level_launch(
            tmpl.data_ptr(), plane_p.data_ptr(), nb, hp, wp, pad,
            tl0.data_ptr(), crop_org.data_ptr(), status0.data_ptr(),
            None if active0 is None else active0.data_ptr(),
            tl_out.data_ptr(), st_out.data_ptr(),
            n, m, win_w, win_h, level_w, level_h, max_iters, eps2,
            int(is_level0), min_eig_threshold, GEOMETRIES[geometry], warps, k, int(walk), stream,
        )
    if rc != 0:
        raise RuntimeError(f"lk_level launch failed: cudaError {rc}")
    lk_level.launches += 1
    return tl_out, st_out


lk_level.launches = 0


def kernel_variants() -> list[dict]:
    """Registers per thread, threads per block and resident blocks and
    warps per SM of each instantiation of the kernel (each launch shape,
    crop and exact blends). Needs the CUDA toolkit and a GPU."""
    lib = _lib()
    out = []
    for warps, k, walk in [(w, k, False) for w, k in LAUNCH_SHAPES] + [(*WALK_SHAPE, True)]:
        for exact in (False, True):
            vals = [ctypes.c_int() for _ in range(4)]
            rc = lib.lk_level_occupancy(warps, k, int(walk), int(exact), *[ctypes.addressof(v) for v in vals])
            if rc != 0:
                raise RuntimeError(f"lk_level_occupancy failed: cudaError {rc}")
            threads, blocks, regs, local = (v.value for v in vals)
            out.append(dict(
                label=f"{warps} warps x {k} px{' walking' if walk else ''}, "
                f"{'exact' if exact else 'crop'} blend",
                threads=threads, blocks_per_sm=blocks, warps_per_sm=blocks * threads // 32,
                regs=regs, local_bytes=local,
            ))
    return out
