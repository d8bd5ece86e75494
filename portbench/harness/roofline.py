"""The card's peaks and the work of the port's kernels, counted the same
whatever implements them (frozen copies of chip_smoke.py's `bound`,
`lk_level_work` and the warp's byte and operation counts).

A kernel's least time is the larger of its bytes over the memory
bandwidth and its operations over the float32 and float64 peaks. Each
input byte is counted as read once and each output byte as written once;
where the work depends on the data (LK iterations, the points that pass
the spectral gate), it is counted for these inputs, from the benchmark's
own reference on the same pairs, never as the most it could be.
"""

from __future__ import annotations

# NVIDIA H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit):
# HBM bandwidth, float32 and float64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12


def bound_s(n_bytes: float, f32_ops: float = 0.0, f64_ops: float = 0.0) -> float:
    """The least seconds an H100 could take for the work."""
    return max(n_bytes / HBM_BYTES_PER_S, f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S)


def lk_crop(m: int, win_w: int, win_h: int) -> tuple[int, int]:
    """(width, height) of a point's crop in the grid path's geometries."""
    return win_w + 1 + 2 * m, win_h + 1 + 2 * m


def lk_level_work(n: int, win_w: int, win_h: int, m: int, plane_numel: int, good: int,
                  iterations: int) -> tuple[float, float, float]:
    """(bytes, float32 ops, float64 ops) of one lk_level launch over n
    points: the templates read (3 planes of win_w x win_h float32), the
    crops of the `good` points (active, past the spectral gate), at most
    the level planes, the per-point inputs and outputs; per template pixel
    6 float64 ops for A, per sampled window pixel (`iterations`
    point-iterations) 16 float32 ops (blend, W_BITS rounding, difference)
    and 4 float64 ops (b)."""
    npix = win_w * win_h
    cw, ch = lk_crop(m, win_w, win_h)
    crops = min(good * cw * ch, plane_numel) * 4
    n_bytes = n * 3 * npix * 4 + crops + n * (8 + 8 + 1) + n * (8 + 1)
    pix_iters = iterations * npix
    return n_bytes, 16.0 * pix_iters, 6.0 * n * npix + 4.0 * pix_iters


def warp_work(c: int, hk: int, wk: int, geometry: str, src_bytes: int = 4) -> tuple[float, float]:
    """(bytes, float32 ops) of one warp_bilinear launch over an (hk, wk)
    level of c channels: fx, fy and the c source planes read once, c
    float32 planes written; per pixel the gather geometry's corners,
    fractions and weights (18 ops) and 7 a channel, or the slab's corner
    clamps and fractions (14) and 9 a channel."""
    n_bytes = (8 + c * (src_bytes + 4)) * hk * wk
    ops = (18 + 7 * c) if geometry == "gather" else (14 + 9 * c)
    return n_bytes, ops * hk * wk
