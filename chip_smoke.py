#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's sparse pathfinder path (and its other LK
configurations: the blocked grid kernel, the lanes kernel without a
rescue, the exact path), its dense Farneback path, its Shi-Tomasi +
forward-backward LK tracker and its pathfinder app once on one GPU.

Run from the repository root, on a machine with one CUDA GPU and the CUDA
toolkit (nvcc under $CUDA_HOME or /usr/local/cuda):

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. device check: a CUDA device is required, there is no CPU path;
2. kernel build: csrc/lk_level.cu, csrc/warp_bilinear.cu,
   csrc/patch_bilinear.cu and csrc/gather_rects.cu -> build/torch_kernels/
   (one nvcc each, started together, sm_90a); for each instantiation of
   lk_level and patch_bilinear, its registers per thread (checked against
   the ptxas report beside the library) and resident blocks and warps per
   SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
3. lk_level kernel vs its plain PyTorch version at L2, L1 and L0 of the
   production params on one 1080p pair: status and top-lefts identical
   (both sum exactly, so any difference is a fault), the kernel launched
   at every level, and its device time per level (graph replay);
4. sparse main path: lk_grid_flow_video over a 49-frame 1080p clip (48
   pairs) and lk_grid_flow over one pair; finite fields, median endpoint
   error against the known flow < 0.1 px on status-true points, >= 95%
   status true, `good` agreeing with the plain path on >= 99% of points;
5. sparse times: steady-state fps of the 48-pair scan through the kernel
   and of a few pairs through the plain version; the kernel's time per
   level;
6. warp_bilinear kernel vs its plain version on the (5, Hk, Wk)
   coefficient pyramids of one 720p pair at all 4 level sizes, sampled at
   the flow of one Farneback iteration: identical over every pixel (both
   round every product and sum alike), and the device time of each per
   level (CUDA events around a replayed CUDA graph of many launches);
7. dense main path: farneback_flow_video over a 25-frame 720p clip (24
   pairs) and farneback_flow over one pair at the reference params;
   finite fields, >= 12 warp launches per pair, farneback_flow equal to
   the scan's first pair, the first 2 pairs equal to the plain path's,
   median endpoint error against the known flow < TOL_DENSE_EPE_PX on
   pixels at least DENSE_BORDER px from the border;
8. dense times: steady-state fps of the 24-pair scan through the kernel
   and of 2 pairs through the plain version and through the kernel (best
   of 3 each);
9. tracker kernels vs their plain versions at TrackerParams()'s shapes on
   one 1080p pair (256 points, some in the edge bands where the v1 slab is
   clipped): patch_bilinear's templates (C = 3) and err windows (C = 1) at
   L2, L1 and L0, and lk_level in both crop geometries at every level,
   identical;
10. tracker main path: track_video at TrackerParams() over the 49-frame
    1080p clip (48 steps, after a seeding step on frame 0, as the JAX
    package's tracker bench runs it): 6 lk_level and 8 patch_bilinear
    launches per step, finite heads, live tracks per step, forward-backward
    survival share, median endpoint error of surviving heads against the
    known zoom < TOL_EPE_PX; the first 4 steps identical to the plain path
    (both kernels replaced by their plain versions), with points_lanes and
    without it (the v1 geometry);
11. tracker times: fps of the 48 steps through the kernels and through the
    plain versions (best of 3), and each kernel's device time at the
    tracker's shapes (graph replay);
12. lk_level vs its plain version in the anchored geometry (blocked,
    rescue_large=False, rescue_levels=1) and the exact one, at L2, L1 and
    L0 of the 2304 grid points on the zoom clip's first pair and on a
    (+40, +3) pair: identical, with points frozen at L0 on the (+40, +3)
    pair for blocked and rescue_large=False; device times per level; and
    patch_bilinear at the exact path's shapes (2304 points, window 45),
    identical to its plain version, with its device times;
13. gather_rects through extract_slabs_rect on the 1080p level planes at
    the blocked kernel's slab shape (2304 x 118 x 128 per level, some
    origins off the plane): identical to its plain version; device time,
    bound and the one-call indexing gather's time;
14. lk_grid_flow_video with the blocked kernel and with the exact path over
    the 48-pair clip, and with rescue_large=False and rescue_levels=1 over
    a few pairs: as phase 4 (finite, lk_level at every level, EPE, status,
    `good` vs the plain path), and the two 48-pair scans' fps;
15. the pathfinder app (apps/pathfinder.py) at the production params on
    the 1080p clip, read from host memory through ClipReader (BGR = gray
    replicated): run_batched(chunk=24) over the 48 pairs, lk_level 3 times
    a pair and per-pair danger counts equal to lk_grid_flow_video's `good`
    sums; run over 8 pairs with the same counts; a checkpointed run of 24
    pairs and its resume with the full run's counts; 2 frames composited
    with their danger lamps; the app's fps (best of 3, render off) beside
    phase 5's scan fps.

Each kernel's record carries its device time per shape of the main paths
(shape_ms, graph replay; with shape_bound_ms and, for patch_bilinear,
shape_library_ms) and, for lk_level and patch_bilinear, the registers and
occupancy of each instantiation (variants), and its bound: the least time
an H100 could take for the same work, the larger of the bytes it must move
(each input read once, each output written once, at HBM_BYTES_PER_S) and
the operations it does on these inputs (at the peak rate for their type),
and, where one
PyTorch call computes the same function (F.grid_sample for both bilinear
kernels, an advanced-indexing gather for gather_rects), that call's device
time; lk_level has no such call.

The clips are synthetic: a smooth random texture (seeded torch.Generator)
zoomed about the frame centre by ZOOM per frame, as in forward flight, so
the flow of every pixel is known exactly.

Before the last line come the GPU's name and power limit (nvidia-smi) and
the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

H, W = 1080, 1920
N_FRAMES = 49  # 48 pairs, as the JAX package's sparse bench scan
PLAIN_PAIRS = 4
ZOOM = 1.005  # scale factor between consecutive frames (corner flow ~5.5 px at 1080p)
SEED = 0
TOL_EPE_PX = 0.1

DENSE_H, DENSE_W = 720, 1280
DENSE_FRAMES = 25  # 24 pairs, as the JAX package's dense_flow_fps_720p
DENSE_PLAIN_PAIRS = 2
DENSE_BORDER = 40  # px; Farneback's replicate borders bias the flow near the edge
# texture lattice spacing of the dense clip: Farneback's expansion (poly_n 5,
# sigma 1.2) reads curvature at a few pixels' scale; on the 6 px lattice of
# the sparse clip, bilinear between nodes, it sees too little of it and
# recovers about a third of the zoom
DENSE_CELL = 2
TOL_DENSE_EPE_PX = 0.1

TRACKER_PLAIN_STEPS = 4  # steps held identical to the plain path

# NVIDIA H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit):
# HBM bandwidth, float32 and float64 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12


def log(*a):
    print(*a, flush=True)


def smooth_texture(gen: torch.Generator, device, h: int = H, w: int = W, cell: int = 6) -> torch.Tensor:
    """Random lattice (spacing `cell` px, wide enough for the whole clip),
    blurred by four [1/4, 1/2, 1/4] passes, scaled to [10, 245]."""
    ly, lx = h // cell + 8, w // cell + 8
    lat = torch.rand((ly, lx), generator=gen, dtype=torch.float64).to(device)
    k = torch.tensor([0.25, 0.5, 0.25], dtype=torch.float64, device=device)
    for _ in range(4):
        p = torch.nn.functional.pad(lat[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
        lat = k[0] * p[:-2, 1:-1] + k[1] * p[1:-1, 1:-1] + k[2] * p[2:, 1:-1]
        p = torch.nn.functional.pad(lat[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
        lat = k[0] * p[1:-1, :-2] + k[1] * p[1:-1, 1:-1] + k[2] * p[1:-1, 2:]
    lat = (lat - lat.min()) / (lat.max() - lat.min())
    return 10.0 + 235.0 * lat


def sample_texture(lat: torch.Tensor, x: torch.Tensor, y: torch.Tensor, cell: int = 6):
    """The texture at float64 pixel coordinates: bilinear in the lattice,
    whose node (0, 0) sits at pixel (-4 cell, -4 cell)."""
    u = x / cell + 4.0
    v = y / cell + 4.0
    u0 = torch.floor(u).clamp(0, lat.shape[1] - 2)
    v0 = torch.floor(v).clamp(0, lat.shape[0] - 2)
    fu, fv = u - u0, v - v0
    iu, iv = u0.long(), v0.long()
    return (
        lat[iv, iu] * (1 - fu) * (1 - fv)
        + lat[iv, iu + 1] * fu * (1 - fv)
        + lat[iv + 1, iu] * (1 - fu) * fv
        + lat[iv + 1, iu + 1] * fu * fv
    )


def make_clip(device, h: int = H, w: int = W, n: int = N_FRAMES, cell: int = 6) -> torch.Tensor:
    """(n, h, w) uint8: frame t is the texture (lattice spacing `cell` px)
    zoomed by ZOOM**t about the centre (content expands outwards, as in
    forward flight)."""
    gen = torch.Generator().manual_seed(SEED)
    lat = smooth_texture(gen, device, h, w, cell)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=device),
        torch.arange(w, dtype=torch.float64, device=device),
        indexing="ij",
    )
    frames = []
    for t in range(n):
        s = ZOOM**t
        img = sample_texture(lat, cx + (xx - cx) / s, cy + (yy - cy) / s, cell)
        frames.append(torch.floor(img + 0.5).to(torch.uint8))
    return torch.stack(frames)


class ClipReader:
    """An in-memory frame source with io/video.py's VideoReader interface
    (height, width, fps, length, seek, read) over (T, H, W, 3) uint8 BGR
    frames, or a (T, H, W) gray clip replicated to BGR once. read() returns
    a view: the "decode" costs nothing and holds no lock, so what the
    pathfinder app's throughput shows is its own pipeline. The app reads
    the synthetic clips through it; the GPU machine has no cv2 to decode a
    file."""

    def __init__(self, frames: np.ndarray, fps: float = 30.0):
        frames = np.asarray(frames, dtype=np.uint8)
        self.bgr = frames if frames.ndim == 4 else np.repeat(frames[..., None], 3, axis=-1)
        self.length, self.height, self.width = self.bgr.shape[:3]
        self.fps = fps
        self.pos = 0

    def seek(self, frame_idx: int) -> None:
        self.pos = frame_idx

    def read(self) -> np.ndarray | None:
        if self.pos >= self.length:
            return None
        self.pos += 1
        return self.bgr[self.pos - 1]

    def release(self) -> None:
        pass


def true_backward(pts: torch.Tensor) -> torch.Tensor:
    """Where each point of frame t lies in frame t-1 (the 1080p clip)."""
    c = torch.tensor([(W - 1) / 2.0, (H - 1) / 2.0], dtype=torch.float64, device=pts.device)
    return c + (pts.double() - c) / ZOOM


def true_forward_flow(h: int, w: int, device) -> torch.Tensor:
    """(h, w, 2) float64 [dx, dy] flow from frame t to t+1 of make_clip:
    a pixel p moves to c + ZOOM (p - c)."""
    ys = torch.arange(h, dtype=torch.float64, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float64, device=device)[None, :].expand(h, w)
    return torch.stack([(ZOOM - 1) * (xs - (w - 1) / 2.0), (ZOOM - 1) * (ys - (h - 1) / 2.0)], dim=-1)


def dense_median_epe(flows: torch.Tensor, border: int = DENSE_BORDER) -> float:
    """Median endpoint error of (..., h, w, 2) flows against the clip's
    known flow, over pixels at least `border` px from the frame's edge."""
    h, w = flows.shape[-3:-1]
    err = torch.linalg.vector_norm(flows.double() - true_forward_flow(h, w, flows.device), dim=-1)
    return float(err[..., border : h - border, border : w - border].median())


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches, from CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches captured in one CUDA
    graph and replayed, from CUDA events: no host time between launches,
    which cuda_ms counts where a launch is shorter than its host call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(n_bytes: float, f32_ops: float = 0.0, f64_ops: float = 0.0) -> tuple[float, str]:
    """(least ms an H100 could take, what bounds it): the larger of the
    bytes over HBM_BYTES_PER_S and the operations over their peak rates."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def lk_level_work(args, statics, stats) -> tuple[float, float, float]:
    """(bytes, float32 ops, float64 ops) of one lk_level call on these
    inputs: templates read, the crops of the points past the spectral gate
    and active (in the exact geometry, the windows each iteration reads),
    at most the level plane, the per-point inputs and outputs; per
    template pixel 6 float64 ops for A, per sampled window pixel 16
    float32 ops (blend, W_BITS rounding, difference) and 4 float64 ops
    (b)."""
    from hackathonopticalflow_tpu_torch.ops.lk_level import crop_size

    tmpl, plane_p = args[0], args[1]
    n, npix = tmpl.shape[0], statics["win_w"] * statics["win_h"]
    geometry = statics.get("geometry", "centred")
    cw, ch = crop_size(geometry, statics["m"], statics["win_w"], statics["win_h"])
    if geometry == "exact":
        read = stats["iterations"] * (statics["win_w"] + 1) * (statics["win_h"] + 1)
    else:
        read = stats["good"] * cw * ch
    crops = min(read, plane_p.numel()) * 4
    n_bytes = tmpl.numel() * 4 + crops + n * (8 + 8 + 1) + n * (8 + 1)
    pix_iters = stats["iterations"] * npix
    return n_bytes, 16.0 * pix_iters, 6.0 * n * npix + 4.0 * pix_iters


def host_seconds(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def merge_records(dst: dict, src: dict) -> None:
    """dst.update(src), merging the per-shape dicts (shape_*) key by key."""
    for k, v in src.items():
        if k.startswith("shape_") and k in dst:
            dst[k].update(v)
        else:
            dst[k] = v


def kernel_variants(name: str, lib_path) -> list[dict]:
    """Each instantiation of csrc/<name>.cu with its registers per thread
    and resident blocks and warps per SM (the wrapper's kernel_variants():
    cudaFuncGetAttributes and cudaOccupancyMaxActiveBlocksPerMultiprocessor
    in the library), held against the registers of nvcc's ptxas report
    (the .log beside the library)."""
    import importlib
    import re

    mod = importlib.import_module(f"hackathonopticalflow_tpu_torch.ops.{name}")
    report = lib_path.with_suffix(".log").read_text()
    ptxas_regs = {int(r) for r in re.findall(r"Used (\d+) registers", report)}
    spills = {int(s) for pair in re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", report)
              for s in pair}
    out = mod.kernel_variants()
    for v in out:
        log(f"  {name} {v['label']}: {v['regs']} registers, {v['local_bytes']} B local, "
            f"{v['threads']} threads per block, {v['blocks_per_sm']} blocks / {v['warps_per_sm']} warps per SM")
        if v["regs"] not in ptxas_regs:
            raise SystemExit(f"{name} {v['label']}: {v['regs']} registers, not in the ptxas report {ptxas_regs}")
    log(f"  ptxas {name}: registers {sorted(ptxas_regs)}, spill bytes {sorted(spills)}")
    return out


def sparse_phases(dev, clip) -> dict:
    """Phases 3-5: the sparse pathfinder path through lk_level."""
    from hackathonopticalflow_tpu_torch.core import LKParams, measurement_grid
    from hackathonopticalflow_tpu_torch.flow import lk_grid
    from hackathonopticalflow_tpu_torch.ops import lk as lk_mod
    from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level, lk_level_reference
    from hackathonopticalflow_tpu_torch.ops.patch_bilinear import patch_bilinear
    from hackathonopticalflow_tpu_torch.ops.warp_bilinear import warp_bilinear

    params = LKParams(grid_step=30, compute_err=False)
    pts_np = measurement_grid(H, W, params.grid_step)
    pts = torch.from_numpy(pts_np).to(dev)
    grid_xy = (np.unique(pts_np[:, 0]).astype(int), np.unique(pts_np[:, 1]).astype(int))
    log(f"sparse: {pts.shape[0]} grid points")

    # ---- 3. kernel vs plain, per level (backward: template = frame 1) ----
    cur = lk_mod.prepare_frame(clip[1], params)
    prev = lk_mod.prepare_frame(clip[0], params)
    center = pts * (1.0 / (1 << params.max_level))
    status = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    max_err = 0.0
    level_ms, level_plain_ms, level_bound_ms = {}, {}, {}
    work = [0.0, 0.0, 0.0]
    for level in range(params.max_level, -1, -1):
        if level != params.max_level:
            center = center * 2.0
        args, statics = lk_mod.level_inputs(cur, prev, grid_xy, center, level, params)
        lk_level.launches = 0
        tl_k, st_k = lk_level(*args, status, **statics)
        torch.cuda.synchronize()
        launches = lk_level.launches
        stats = {}
        tl_p, st_p = lk_level_reference(*args, status, **statics, stats=stats)
        level_work = lk_level_work(args, statics, stats)
        work = [a + b for a, b in zip(work, level_work)]
        err = float(torch.linalg.vector_norm(tl_k - tl_p, dim=-1).max())
        same_status = bool(torch.equal(st_k, st_p))
        same_tl = bool(torch.equal(tl_k, tl_p))
        log(f"L{level}: launches {launches}, max |d| {err:.3g} px, top-lefts identical "
            f"{same_tl}, status identical {same_status}, "
            f"status true {float(st_k.float().mean()):.4f}")
        if launches < 1 or not same_status or not same_tl:
            raise SystemExit(f"L{level}: kernel disagrees with the plain version")
        max_err = max(max_err, err)
        level_ms[level] = graph_ms(lambda: lk_level(*args, status, **statics), 20)
        level_plain_ms[level] = graph_ms(lambda: lk_level_reference(*args, status, **statics), 3)
        level_bound_ms[level], _ = bound(*level_work)
        log(f"L{level}: lk_level {level_ms[level]:.4f} ms, plain {level_plain_ms[level]:.4f} ms "
            "(graph replay), bound %.4f ms (%s)" % bound(*level_work))
        center = tl_p + lk_mod._halfwin(params, dev)
        status = st_p

    # ---- 4. main path ----
    lk_level.launches = warp_bilinear.launches = patch_bilinear.launches = 0
    res = lk_grid.lk_grid_flow_video(clip, pts, lk=params, device=dev)
    one = lk_grid.lk_grid_flow(clip[0], clip[1], pts, lk=params, device=dev)
    torch.cuda.synchronize()
    main_launches = lk_level.launches
    log(f"sparse main path: lk_level launches {main_launches}, warp_bilinear launches "
        f"{warp_bilinear.launches}, patch_bilinear launches {patch_bilinear.launches}")
    if main_launches < 3 * (N_FRAMES - 1):
        raise SystemExit("the sparse main path did not run the lk_level kernel at every level")
    for name, v in res._asdict().items():
        if v.is_floating_point() and not bool(torch.isfinite(v).all()):
            raise SystemExit(f"non-finite values in {name}")
        if v.shape[:2] != (N_FRAMES - 1, pts.shape[0]):
            raise SystemExit(f"{name} has shape {tuple(v.shape)}")
    st = res.status
    epe = torch.linalg.vector_norm(res.raw_next_pts.double() - true_backward(pts), dim=-1)
    med_epe = float(epe[st].median())
    st_frac = float(st.double().mean())
    log(f"sparse scan: median EPE {med_epe:.4f} px on status-true points, status true "
        f"{st_frac:.4f}, good {float(res.good.double().mean()):.4f}")
    if not med_epe < TOL_EPE_PX or st_frac < 0.95:
        raise SystemExit("the sparse main path's flow is wrong")
    for name in ("raw_next_pts", "status", "good", "next_pts"):
        if not torch.equal(getattr(one, name), getattr(res, name)[0]):
            raise SystemExit(f"lk_grid_flow disagrees with the scan's first step on {name}")

    with mock.patch.object(lk_mod, "lk_level", lk_level_reference):
        plain = lk_grid.lk_grid_flow_video(clip[: PLAIN_PAIRS + 1], pts, lk=params, device=dev)
    good_agree = float((plain.good == res.good[:PLAIN_PAIRS]).double().mean())
    raw_diff = float((plain.raw_next_pts - res.raw_next_pts[:PLAIN_PAIRS]).abs().max())
    log(f"plain path ({PLAIN_PAIRS} pairs): good agreement {good_agree:.4f}, "
        f"max |raw_next_pts diff| {raw_diff:.3g} px")
    if good_agree < 0.99:
        raise SystemExit("good disagrees with the plain path")

    # ---- 5. times ----
    scan_s = min(host_seconds(lambda: lk_grid.lk_grid_flow_video(clip, pts, lk=params, device=dev))
                 for _ in range(3))
    with mock.patch.object(lk_mod, "lk_level", lk_level_reference):
        lk_grid.lk_grid_flow_video(clip[: PLAIN_PAIRS + 1], pts, lk=params, device=dev)
        plain_s = min(
            host_seconds(
                lambda: lk_grid.lk_grid_flow_video(clip[: PLAIN_PAIRS + 1], pts, lk=params, device=dev)
            )
            for _ in range(2)
        )
    fps = (N_FRAMES - 1) / scan_s
    plain_fps = PLAIN_PAIRS / plain_s
    log(f"sparse scan 48 pairs 1080p through lk_level: {fps:.2f} fps ({scan_s * 1e3:.1f} ms)")
    log(f"sparse scan {PLAIN_PAIRS} pairs 1080p through lk_level_reference: {plain_fps:.2f} fps "
        f"({plain_s * 1e3:.1f} ms)")
    bound_ms, bound_by = bound(*work)
    log("lk_level per level (device ms, kernel / plain): "
        + ", ".join(f"L{lv} {level_ms[lv]:.4f} / {level_plain_ms[lv]:.4f}" for lv in level_ms)
        + f"; bound of the 3 levels {bound_ms:.4f} ms ({bound_by}: {work[0] / 1e6:.1f} MB, "
        f"{work[1] / 1e9:.3f} GFLOP f32, {work[2] / 1e9:.3f} GFLOP f64)")
    return {
        "kernel": {
            "name": "lk_level",
            "route": "cuda",
            "source": "hackathonopticalflow_tpu_torch/csrc/lk_level.cu",
            "replaces": "hackathonopticalflow_tpu/ops/lk_pallas3.py:82, "
            "hackathonopticalflow_tpu/ops/lk_pallas3.py:353, "
            "hackathonopticalflow_tpu/ops/carve_pallas.py:159, "
            "hackathonopticalflow_tpu/ops/lk_pallas.py:45",
            "launches": main_launches,
            "launches_by_path": {"sparse": main_launches},
            "max_abs_err": max_err,
            "ms": sum(level_ms.values()),
            "plain_ms": sum(level_plain_ms.values()),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "shape_ms": {f"production L{lv}": v for lv, v in level_ms.items()},
            "shape_bound_ms": {f"production L{lv}": v for lv, v in level_bound_ms.items()},
        },
        "scan_fps": fps,
        "plain_scan_fps": plain_fps,
        "median_epe_px": med_epe,
    }


def grid_sample_ms(src: torch.Tensor, x: torch.Tensor, y: torch.Tensor, padding_mode: str, reps: int) -> float:
    """Device time of the one PyTorch call that samples src (C, Hs, Ws)
    bilinearly at absolute coordinates x, y (any equal shapes):
    F.grid_sample with align_corners=True, the coordinates normalized
    beforehand (graph replay)."""
    hs, ws = src.shape[-2:]
    grid = torch.stack([x * (2.0 / (ws - 1)) - 1.0, y * (2.0 / (hs - 1)) - 1.0], dim=-1)
    grid = grid.reshape(1, -1, x.shape[-1], 2).contiguous()
    inp = src[None].contiguous()
    return graph_ms(
        lambda: torch.nn.functional.grid_sample(
            inp, grid, mode="bilinear", padding_mode=padding_mode, align_corners=True
        ),
        reps,
    )


def dense_phases(dev) -> dict:
    """Phases 6-8: the dense Farneback path through warp_bilinear."""
    from hackathonopticalflow_tpu_torch.core import FarnebackParams
    from hackathonopticalflow_tpu_torch.flow import dense
    from hackathonopticalflow_tpu_torch.ops import farneback as fb
    from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level
    from hackathonopticalflow_tpu_torch.ops.patch_bilinear import patch_bilinear
    from hackathonopticalflow_tpu_torch.ops.warp_bilinear import warp_bilinear, warp_bilinear_reference

    params = FarnebackParams()
    clip = make_clip(dev, DENSE_H, DENSE_W, DENSE_FRAMES, DENSE_CELL)
    pairs = DENSE_FRAMES - 1
    log(f"dense clip: {tuple(clip.shape)} uint8, lattice {DENSE_CELL} px, zoom {ZOOM}/frame, {params}")

    # ---- 6. kernel vs plain at the 4 level sizes of one pair ----
    rs0 = fb.prepare_frame(clip[0], params)
    rs1 = fb.prepare_frame(clip[1], params)
    max_err = 0.0
    level_ms, level_plain_ms, level_lib_ms = {}, {}, {}
    n_bytes = f32_ops = 0.0
    for r0, r1 in zip(rs0, rs1):
        hk, wk = r0.shape[-2:]
        zero = torch.zeros((hk, wk, 2), dtype=torch.float32, device=dev)
        flow = fb._solve_flow(fb.update_matrices(r0, r1, zero), params)
        xs, ys = fb._pixel_coords(hk, wk, dev)
        fx = (xs + flow[..., 0]).contiguous()
        fy = (ys + flow[..., 1]).contiguous()
        warp_bilinear.launches = 0
        out_k = warp_bilinear(r1, fx, fy)
        torch.cuda.synchronize()
        launches = warp_bilinear.launches
        out_p = warp_bilinear_reference(r1, fx, fy)
        err = float((out_k - out_p).abs().max())
        same = bool(torch.equal(out_k, out_p))
        key = f"{hk}x{wk}"
        log(f"warp {key}: launches {launches}, max |d| {err:.3g}, identical {same}, "
            f"flow max |f| {float(flow.abs().max()):.3f} px")
        if launches != 1 or not same:
            raise SystemExit(f"warp {key}: kernel disagrees with the plain version")
        max_err = max(max_err, err)
        level_ms[key] = graph_ms(lambda: warp_bilinear(r1, fx, fy), 50)
        level_plain_ms[key] = graph_ms(lambda: warp_bilinear_reference(r1, fx, fy), 10)
        # the same sampling with border clamping (the warp clamps its corners
        # and fractions to the plane)
        level_lib_ms[key] = grid_sample_ms(r1, fx, fy, "border", 50)
        call_ms = cuda_ms(lambda: warp_bilinear(r1, fx, fy), 50)
        call_plain_ms = cuda_ms(lambda: warp_bilinear_reference(r1, fx, fy), 10)
        c = r1.shape[0]
        lv_bytes = (2 + 2 * c) * hk * wk * 4  # fx, fy, C source and C output planes
        lv_ops = (18 + 7 * c) * hk * wk  # corners, fractions, weights; 7 per channel
        n_bytes += lv_bytes
        f32_ops += lv_ops
        log(f"warp {key}: device time (graph replay) warp_bilinear {level_ms[key]:.4f} ms, "
            f"plain {level_plain_ms[key]:.4f} ms, F.grid_sample {level_lib_ms[key]:.4f} ms, "
            "bound %.4f ms (%s); " % bound(lv_bytes, lv_ops)
            + f"eager call to call {call_ms:.4f} ms, plain {call_plain_ms:.4f} ms")

    # ---- 7. main path ----
    lk_level.launches = warp_bilinear.launches = patch_bilinear.launches = 0
    flows = dense.farneback_flow_video(clip, params, device=dev)
    one = dense.farneback_flow(clip[0], clip[1], params, device=dev)
    torch.cuda.synchronize()
    main_launches = warp_bilinear.launches
    per_pair = params.iterations * (params.levels + 1)
    log(f"dense main path: warp_bilinear launches {main_launches} "
        f"({per_pair} per pair expected), lk_level launches {lk_level.launches}, "
        f"patch_bilinear launches {patch_bilinear.launches}")
    if main_launches < per_pair * (pairs + 1):
        raise SystemExit("the dense main path did not run warp_bilinear at every iteration")
    if flows.shape != (pairs, DENSE_H, DENSE_W, 2) or not bool(torch.isfinite(flows).all()):
        raise SystemExit(f"dense flows: shape {tuple(flows.shape)} or non-finite values")
    if not torch.equal(one, flows[0]):
        raise SystemExit("farneback_flow disagrees with the scan's first pair")
    med_epe = dense_median_epe(flows)
    log(f"dense scan: median EPE {med_epe:.4f} px (pixels >= {DENSE_BORDER} px from the border), "
        f"mean |flow| {float(torch.linalg.vector_norm(flows, dim=-1).mean()):.3f} px")
    if not med_epe < TOL_DENSE_EPE_PX:
        raise SystemExit("the dense main path's flow is wrong")
    plain_clip = clip[: DENSE_PLAIN_PAIRS + 1]
    with mock.patch.object(fb, "warp_bilinear", warp_bilinear_reference):
        plain = dense.farneback_flow_video(plain_clip, params, device=dev)
    same = bool(torch.equal(plain, flows[:DENSE_PLAIN_PAIRS]))
    log(f"plain path ({DENSE_PLAIN_PAIRS} pairs): identical to the kernel path {same}, "
        f"max |d| {float((plain - flows[:DENSE_PLAIN_PAIRS]).abs().max()):.3g} px")
    if not same:
        raise SystemExit("the dense kernel path disagrees with the plain path")

    # ---- 8. times ----
    scan_s = min(host_seconds(lambda: dense.farneback_flow_video(clip, params, device=dev)) for _ in range(3))
    with mock.patch.object(fb, "warp_bilinear", warp_bilinear_reference):
        plain_s = min(host_seconds(lambda: dense.farneback_flow_video(plain_clip, params, device=dev))
                      for _ in range(3))
    short_s = min(host_seconds(lambda: dense.farneback_flow_video(plain_clip, params, device=dev))
                  for _ in range(3))
    fps = pairs / scan_s
    plain_fps = DENSE_PLAIN_PAIRS / plain_s
    log(f"dense scan {pairs} pairs 720p through warp_bilinear: {fps:.2f} fps ({scan_s * 1e3:.1f} ms)")
    log(f"dense scan {DENSE_PLAIN_PAIRS} pairs 720p through warp_bilinear_reference: "
        f"{plain_fps:.2f} fps ({plain_s * 1e3:.1f} ms); through warp_bilinear: "
        f"{DENSE_PLAIN_PAIRS / short_s:.2f} fps ({short_s * 1e3:.1f} ms)")
    bound_ms, bound_by = bound(n_bytes, f32_ops)
    log("warp_bilinear per level (device ms, kernel / plain / F.grid_sample): "
        + ", ".join(f"{k} {level_ms[k]:.4f} / {level_plain_ms[k]:.4f} / {level_lib_ms[k]:.4f}"
                    for k in level_ms)
        + f"; bound of the 4 levels {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB)")
    return {
        "kernel": {
            "name": "warp_bilinear",
            "route": "cuda",
            "source": "hackathonopticalflow_tpu_torch/csrc/warp_bilinear.cu",
            "replaces": "hackathonopticalflow_tpu/ops/warp_pallas.py:207",
            "launches": main_launches,
            "launches_by_path": {"dense": main_launches},
            "max_abs_err": max_err,
            "ms": sum(level_ms.values()),
            "plain_ms": sum(level_plain_ms.values()),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": sum(level_lib_ms.values()),
        },
        "dense_fps": fps,
        "plain_dense_fps": plain_fps,
        "dense_median_epe_px": med_epe,
    }


def tracker_points(h: int, w: int, n: int) -> np.ndarray:
    """(n, 2) float32 points: most spread over the frame, 24 in the edge
    bands where TrackerParams()'s v1 slab (pad 17, margin 8) is clipped
    into the padded plane while the point is live (window top-left x in
    [-15, -9) or (w-8, w) at some level, and the same in y)."""
    rng = np.random.RandomState(SEED)
    bx = np.array([-30, -24, -18, -13, -10, -7, -5, -3.5, w + 0.5, w + 3, w + 6, w + 11, w + 17, w + 24])
    by = np.array([-28, -14, -9, -6, -3, h + 1.5, h + 5, h + 10, h + 19, h + 26])
    band = np.concatenate([
        np.stack([bx, rng.uniform(20, h - 20, bx.size)], -1),
        np.stack([rng.uniform(20, w - 20, by.size), by], -1),
    ])
    k = n - band.shape[0]
    inner = np.stack([rng.uniform(8, w - 8, k), rng.uniform(8, h - 8, k)], -1)
    return np.concatenate([inner, band]).astype(np.float32)


def tracker_phases(dev, clip) -> dict:
    """Phases 9-11: the tracker through patch_bilinear and lk_level."""
    import dataclasses

    from hackathonopticalflow_tpu_torch.core import TrackerParams
    from hackathonopticalflow_tpu_torch.flow import tracker
    from hackathonopticalflow_tpu_torch.ops import lk as lk_mod
    from hackathonopticalflow_tpu_torch.ops import patch as patch_mod
    from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level, lk_level_reference
    from hackathonopticalflow_tpu_torch.ops.patch_bilinear import patch_bilinear, patch_bilinear_reference
    from hackathonopticalflow_tpu_torch.ops.warp_bilinear import warp_bilinear

    params = TrackerParams()
    lk_v1 = dataclasses.replace(params.lk, points_lanes=False)
    win_w, win_h = params.lk.win_size
    pts = torch.from_numpy(tracker_points(H, W, params.max_tracks)).to(dev)
    n_band = 24
    log(f"tracker: {params}")

    # ---- 9a. lk_level in both crop geometries at the tracker's shapes ----
    lk_max_err = 0.0
    lk_ms, lk_plain_ms, lk_bound_ms = {}, {}, {}
    for geometry, lkp in (("centred", params.lk), ("v1", lk_v1)):
        prev = lk_mod.prepare_frame(clip[0], lkp)
        nxt = lk_mod.prepare_frame(clip[1], lkp)
        center = pts * (1.0 / (1 << lkp.max_level))
        status = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
        for level in range(lkp.max_level, -1, -1):
            if level != lkp.max_level:
                center = center * 2.0
            args, statics, _ = lk_mod.point_level_inputs(prev, nxt, pts, center, level, lkp)
            lk_level.launches = 0
            tl_k, st_k = lk_level(*args, status, **statics)
            torch.cuda.synchronize()
            launches = lk_level.launches
            stats = {}
            tl_p, st_p = lk_level_reference(*args, status, **statics, stats=stats)
            err = float(torch.linalg.vector_norm(tl_k - tl_p, dim=-1).max())
            same = bool(torch.equal(tl_k, tl_p)) and bool(torch.equal(st_k, st_p))
            moved = (tl_p - args[3]).abs().amax(dim=-1) > 1e-3
            key = f"{geometry} L{level}"
            lk_bound_ms[key], _ = bound(*lk_level_work(args, statics, stats))
            log(f"tracker lk_level {geometry} L{level}: launches {launches}, max |d| {err:.3g} px, "
                f"identical {same}, good templates {stats['good']}, iterations {stats['iterations']}, "
                f"band points moved {int(moved[-n_band:].sum())}/{n_band}, "
                "bound %.5f ms (%s)" % bound(*lk_level_work(args, statics, stats)))
            if launches != 1 or not same:
                raise SystemExit(f"tracker lk_level {geometry} L{level}: kernel disagrees with the plain version")
            lk_max_err = max(lk_max_err, err)
            lk_ms[key] = graph_ms(lambda: lk_level(*args, status, **statics), 20)
            lk_plain_ms[key] = graph_ms(lambda: lk_level_reference(*args, status, **statics), 3)
            center = tl_p + lk_mod._halfwin(lkp, dev)
            status = st_p

    # ---- 9b. patch_bilinear: templates (C = 3) per level, err windows (C = 1) ----
    prev = lk_mod.prepare_frame(clip[0], params.lk)
    nxt = lk_mod.prepare_frame(clip[1], params.lk)
    pad = lk_mod._frame_pad(params.lk)
    halfwin = lk_mod._halfwin(params.lk, dev)
    calls = {}
    for level in range(params.lk.max_level, -1, -1):
        planes = torch.stack([prev.img_p[level], prev.dix_p[level], prev.diy_p[level]])
        calls[f"tmpl L{level}"] = (planes, (pts * (1.0 / (1 << level)) - halfwin + pad).contiguous(), True)
    calls["err L0"] = (nxt.img_p[0][None].contiguous(), (pts - halfwin + pad).contiguous(), False)
    pb_max_err = 0.0
    pb_ms, pb_plain_ms, pb_lib_ms, pb_bound = {}, {}, {}, {}
    n_bytes = f32_ops = 0.0
    ii = torch.arange(win_h, dtype=torch.float32, device=dev)[None, :, None]
    jj = torch.arange(win_w, dtype=torch.float32, device=dev)[None, None, :]
    for key, (planes, tl, quantize) in calls.items():
        patch_bilinear.launches = 0
        out_k = patch_bilinear(planes, tl, win_h, win_w, quantize)
        torch.cuda.synchronize()
        launches = patch_bilinear.launches
        out_p = patch_bilinear_reference(planes, tl, win_h, win_w, quantize)
        err = float((out_k - out_p).abs().max())
        same = bool(torch.equal(out_k, out_p))
        log(f"patch_bilinear {key} {tuple(out_k.shape)}: launches {launches}, max |d| {err:.3g}, "
            f"identical {same}")
        if launches != 1 or not same:
            raise SystemExit(f"patch_bilinear {key}: kernel disagrees with the plain version")
        pb_max_err = max(pb_max_err, err)
        pb_ms[key] = graph_ms(lambda: patch_bilinear(planes, tl, win_h, win_w, quantize), 50)
        pb_plain_ms[key] = graph_ms(lambda: patch_bilinear_reference(planes, tl, win_h, win_w, quantize), 20)
        xs = (tl[:, 0, None, None] + jj).expand(-1, win_h, -1)
        ys = (tl[:, 1, None, None] + ii).expand(-1, -1, win_w)
        pb_lib_ms[key] = grid_sample_ms(planes, xs, ys, "zeros", 50)
        c, n = planes.shape[0], tl.shape[0]
        # crops (at most the planes), top-lefts, windows; 7 ops per output
        # value (+4 for the W_BITS rounding), ~12 per point
        call_bytes = min(planes.numel(), n * c * (win_h + 1) * (win_w + 1)) * 4 + n * 8 + out_k.numel() * 4
        call_ops = out_k.numel() * (11 if quantize else 7) + 12 * n
        n_bytes += call_bytes
        f32_ops += call_ops
        pb_bound[key], _ = bound(call_bytes, call_ops)
        log(f"patch_bilinear {key}: device time (graph replay) {pb_ms[key]:.4f} ms, plain "
            f"{pb_plain_ms[key]:.4f} ms, F.grid_sample {pb_lib_ms[key]:.4f} ms, "
            "bound %.5f ms (%s)" % bound(call_bytes, call_ops))
    pb_bound_ms, pb_bound_by = bound(n_bytes, f32_ops)

    # ---- 10. main path ----
    steps = clip.shape[0] - 1
    s0 = tracker.track_step(tracker.init_tracker(params), clip[0], clip[0], params, device=dev)
    lk_level.launches = warp_bilinear.launches = patch_bilinear.launches = 0
    state, (heads, alive, length) = tracker.track_video(clip, params, s0, device=dev)
    torch.cuda.synchronize()
    lk_n, pb_n = lk_level.launches, patch_bilinear.launches
    log(f"tracker main path ({steps} steps): lk_level launches {lk_n} ({6 * steps} expected), "
        f"patch_bilinear launches {pb_n} ({8 * steps} expected), warp_bilinear launches "
        f"{warp_bilinear.launches}")
    if lk_n != 6 * steps or pb_n != 8 * steps:
        raise SystemExit("the tracker's main path did not run both kernels at every level")
    if heads.shape != (steps, params.max_tracks, 2) or not bool(torch.isfinite(heads).all()):
        raise SystemExit(f"tracker heads: shape {tuple(heads.shape)} or non-finite values")
    live = alive.sum(dim=1)
    prev_heads = torch.cat([tracker._heads(s0)[None], heads[:-1]])
    prev_alive = torch.cat([s0.alive[None], alive[:-1]])
    surv = alive & (length >= 2)  # kept by the forward-backward gate this step
    c = torch.tensor([(W - 1) / 2.0, (H - 1) / 2.0], dtype=torch.float64, device=dev)
    want = c + ZOOM * (prev_heads.double() - c)
    epe = torch.linalg.vector_norm(heads.double() - want, dim=-1)[surv]
    med_epe = float(epe.median())
    survival = float(surv.sum()) / float(prev_alive.sum())
    log(f"tracker: live tracks per step {live.tolist()}")
    log(f"tracker: median EPE of surviving heads {med_epe:.4f} px over {int(surv.sum())} head-steps, "
        f"forward-backward survival share {survival:.4f}, final live {int(state.alive.sum())}")
    if not med_epe < TOL_EPE_PX or int(live.min()) < 1:
        raise SystemExit("the tracker's main path is wrong")
    short = clip[: TRACKER_PLAIN_STEPS + 1]
    for geometry, lkp in (("centred", params.lk), ("v1", lk_v1)):
        p = dataclasses.replace(params, lk=lkp)
        lk_level.launches = patch_bilinear.launches = 0
        got, got_hist = tracker.track_video(short, p, s0, device=dev)
        torch.cuda.synchronize()
        n_lk, n_pb = lk_level.launches, patch_bilinear.launches
        with mock.patch.object(lk_mod, "lk_level", lk_level_reference), \
                mock.patch.object(patch_mod, "patch_bilinear", patch_bilinear_reference):
            want_state, want_hist = tracker.track_video(short, p, s0, device=dev)
        same = all(torch.equal(getattr(got, f), getattr(want_state, f)) for f in ("traj", "length", "alive"))
        same = same and all(torch.equal(a, b) for a, b in zip(got_hist, want_hist))
        log(f"tracker {geometry}: first {TRACKER_PLAIN_STEPS} steps identical to the plain path {same} "
            f"(lk_level {n_lk}, patch_bilinear {n_pb} launches), live {int(got.alive.sum())}")
        if not same or n_lk != 6 * TRACKER_PLAIN_STEPS or n_pb != 8 * TRACKER_PLAIN_STEPS:
            raise SystemExit(f"the tracker's kernel path ({geometry}) disagrees with the plain path")

    # ---- 11. times ----
    track_s = min(host_seconds(lambda: tracker.track_video(clip, params, s0, device=dev)) for _ in range(3))
    with mock.patch.object(lk_mod, "lk_level", lk_level_reference), \
            mock.patch.object(patch_mod, "patch_bilinear", patch_bilinear_reference):
        plain_s = min(host_seconds(lambda: tracker.track_video(clip, params, s0, device=dev))
                      for _ in range(3))
    fps, plain_fps = steps / track_s, steps / plain_s
    log(f"tracker {steps} steps 1080p through the kernels: {fps:.2f} fps ({track_s * 1e3:.1f} ms); "
        f"through the plain versions: {plain_fps:.2f} fps ({plain_s * 1e3:.1f} ms)")
    log("tracker lk_level per level (device ms, kernel / plain): "
        + ", ".join(f"{k} {lk_ms[k]:.4f} / {lk_plain_ms[k]:.4f}" for k in lk_ms))
    log("patch_bilinear per call (device ms, kernel / plain / F.grid_sample): "
        + ", ".join(f"{k} {pb_ms[k]:.4f} / {pb_plain_ms[k]:.4f} / {pb_lib_ms[k]:.4f}" for k in pb_ms)
        + f"; bound of the 4 calls {pb_bound_ms:.5f} ms ({pb_bound_by}: {n_bytes / 1e6:.2f} MB)")
    return {
        "kernel": {
            "name": "patch_bilinear",
            "route": "cuda",
            "source": "hackathonopticalflow_tpu_torch/csrc/patch_bilinear.cu",
            "replaces": "hackathonopticalflow_tpu/ops/carve_pallas.py:231",
            "launches": pb_n,
            "launches_by_path": {"tracker": pb_n},
            "max_abs_err": pb_max_err,
            "ms": sum(pb_ms.values()),
            "plain_ms": sum(pb_plain_ms.values()),
            "bound_ms": pb_bound_ms,
            "bound_by": pb_bound_by,
            "library_ms": sum(pb_lib_ms.values()),
            "shape_ms": {f"tracker {k}": v for k, v in pb_ms.items()},
            "shape_library_ms": {f"tracker {k}": v for k, v in pb_lib_ms.items()},
            "shape_bound_ms": {f"tracker {k}": v for k, v in pb_bound.items()},
        },
        "lk_level": {
            "launches": lk_n,
            "max_abs_err": lk_max_err,
            "shape_ms": {f"tracker {k}": v for k, v in lk_ms.items()},
            "shape_bound_ms": {f"tracker {k}": v for k, v in lk_bound_ms.items()},
            "tracker_ms": sum(v for k, v in lk_ms.items() if k.startswith("centred")),
            "tracker_plain_ms": sum(v for k, v in lk_plain_ms.items() if k.startswith("centred")),
            "tracker_v1_ms": sum(v for k, v in lk_ms.items() if k.startswith("v1")),
            "tracker_v1_plain_ms": sum(v for k, v in lk_plain_ms.items() if k.startswith("v1")),
        },
        "tracker_fps": fps,
        "plain_tracker_fps": plain_fps,
        "tracker_median_epe_px": med_epe,
        "tracker_survival_share": survival,
    }

def shifted_pair(dev, dx: int, dy: int, h: int = H, w: int = W) -> tuple[torch.Tensor, torch.Tensor]:
    """u8 frames a, b of the clip's texture with b(x, y) = a(x + dx, y + dy):
    at (+40, +3) (the JAX package's test_rescue_recovers_large_flow shift)
    LK follows the shift down the pyramid, and at level 0 the crop at the
    coarse estimate leaves the grid-anchored slab."""
    gen = torch.Generator().manual_seed(SEED + 1)
    lat = smooth_texture(gen, dev, h + 2 * abs(dy) + 60, w + 2 * abs(dx) + 60)
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=dev),
        torch.arange(w, dtype=torch.float64, device=dev),
        indexing="ij",
    )

    def frame(ox, oy):
        return torch.floor(sample_texture(lat, xx + ox, yy + oy) + 0.5).to(torch.uint8)

    return frame(0, 0), frame(dx, dy)


def new_lk_configs():
    """The LK configurations of phases 12-14: the grid-anchored crops
    (blocked kernel; lanes without a rescue below the top, or with it at
    level 0 only) and the exact path, on the sparse grid."""
    import dataclasses

    from hackathonopticalflow_tpu_torch.core import LKParams

    prod = LKParams(grid_step=30, compute_err=False)
    return {
        "blocked": dataclasses.replace(prod, grid_kernel="blocked"),
        "no_rescue": dataclasses.replace(prod, rescue_large=False),
        "rescue_levels_1": dataclasses.replace(prod, rescue_levels=1),
        "exact": LKParams(compute_err=False),
    }


def new_lk_phases(dev, clip) -> dict:
    """Phase 12: lk_level vs its plain version in the anchored geometry
    (three configurations) and the exact one, at every level of the 2304
    grid points on the zoom clip's first pair and on a (+40, +3) pair;
    frozen points per level; device times on the zoom pair."""
    from hackathonopticalflow_tpu_torch.core import measurement_grid
    from hackathonopticalflow_tpu_torch.ops import lk as lk_mod
    from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level, lk_level_reference

    pts_np = measurement_grid(H, W, 30)
    pts = torch.from_numpy(pts_np).to(dev)
    grid_xy = (np.unique(pts_np[:, 0]).astype(int), np.unique(pts_np[:, 1]).astype(int))
    # (template frame, search frame): the zoom pair backward, as phase 3
    pairs = {"zoom": (clip[1], clip[0]), "shift_40_3": shifted_pair(dev, 40, 3)}
    max_err = 0.0
    times = {}
    shape_ms, shape_bound_ms = {}, {}
    for config, params in new_lk_configs().items():
        ms = plain_ms = 0.0
        work = [0.0, 0.0, 0.0]
        for pair, (a, b) in pairs.items():
            cur = lk_mod.prepare_frame(a, params)
            prev = lk_mod.prepare_frame(b, params)
            center = pts * (1.0 / (1 << params.max_level))
            status = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
            frozen = {}
            for level in range(params.max_level, -1, -1):
                if level != params.max_level:
                    center = center * 2.0
                if config == "exact":
                    args, kw, _ = lk_mod.point_level_inputs(cur, prev, pts, center, level, params)
                else:
                    args, kw = lk_mod.level_inputs(cur, prev, grid_xy, center, level, params)
                lk_level.launches = 0
                tl_k, st_k = lk_level(*args, status, **kw)
                torch.cuda.synchronize()
                launches = lk_level.launches
                stats = {}
                tl_p, st_p = lk_level_reference(*args, status, **kw, stats=stats)
                err = float(torch.linalg.vector_norm(tl_k - tl_p, dim=-1).max())
                same = bool(torch.equal(tl_k, tl_p)) and bool(torch.equal(st_k, st_p))
                active0 = kw.get("active0")
                frozen[level] = None if active0 is None else int((~active0).sum())
                lv_work = lk_level_work(args, kw, stats)
                log(f"{config} {pair} L{level} ({kw['geometry']}): launches {launches}, max |d| {err:.3g} px, "
                    f"identical {same}, frozen {frozen[level]}, good {stats['good']}, "
                    f"iterations {stats['iterations']}, status true {float(st_k.float().mean()):.4f}")
                if launches != 1 or not same:
                    raise SystemExit(f"{config} {pair} L{level}: lk_level disagrees with its plain version")
                max_err = max(max_err, err)
                if pair == "zoom":
                    k_ms = graph_ms(lambda: lk_level(*args, status, **kw), 20)
                    p_ms = graph_ms(lambda: lk_level_reference(*args, status, **kw), 3)
                    ms, plain_ms = ms + k_ms, plain_ms + p_ms
                    work = [x + y for x, y in zip(work, lv_work)]
                    shape_ms[f"{config} L{level}"] = k_ms
                    shape_bound_ms[f"{config} L{level}"], _ = bound(*lv_work)
                    log(f"{config} L{level}: lk_level {k_ms:.4f} ms, plain {p_ms:.4f} ms (graph replay), "
                        "bound %.4f ms (%s)" % bound(*lv_work))
                center = tl_p + lk_mod._halfwin(params, dev)
                status = st_p
            if pair == "shift_40_3" and config in ("blocked", "no_rescue") and not frozen[0]:
                raise SystemExit(f"{config}: no point froze at L0 on the (+40, +3) pair")
        bound_ms, bound_by = bound(*work)
        times[config] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"{config}: lk_level over the 3 levels {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"max_abs_err": max_err, "config_ms": times, "shape_ms": shape_ms, "shape_bound_ms": shape_bound_ms}

def exact_patch_phase(dev, clip) -> dict:
    """Phase 12b: patch_bilinear at the exact path's shapes on the zoom
    pair (2304 points, window 45): templates (C = 3) at L2, L1, L0 and the
    err windows (C = 1) at L0, identical to the plain version; device
    times (graph replay) beside F.grid_sample's and the bound."""
    from hackathonopticalflow_tpu_torch.core import measurement_grid
    from hackathonopticalflow_tpu_torch.ops import lk as lk_mod
    from hackathonopticalflow_tpu_torch.ops.patch_bilinear import patch_bilinear, patch_bilinear_reference

    params = new_lk_configs()["exact"]
    win_w, win_h = params.win_size
    pts = torch.from_numpy(measurement_grid(H, W, 30)).to(dev)
    cur = lk_mod.prepare_frame(clip[1], params)
    prev = lk_mod.prepare_frame(clip[0], params)
    pad = lk_mod._frame_pad(params)
    halfwin = lk_mod._halfwin(params, dev)
    calls = {}
    for level in range(params.max_level, -1, -1):
        planes = torch.stack([cur.img_p[level], cur.dix_p[level], cur.diy_p[level]])
        calls[f"tmpl L{level}"] = (planes, (pts * (1.0 / (1 << level)) - halfwin + pad).contiguous(), True)
    calls["err L0"] = (prev.img_p[0][None].contiguous(), (pts - halfwin + pad).contiguous(), False)
    ii = torch.arange(win_h, dtype=torch.float32, device=dev)[None, :, None]
    jj = torch.arange(win_w, dtype=torch.float32, device=dev)[None, None, :]
    out = {"exact_ms": 0.0, "exact_plain_ms": 0.0, "exact_library_ms": 0.0,
           "shape_ms": {}, "shape_library_ms": {}, "shape_bound_ms": {}}
    n_bytes = f32_ops = 0.0
    for key, (planes, tl, quantize) in calls.items():
        got = patch_bilinear(planes, tl, win_h, win_w, quantize)
        want = patch_bilinear_reference(planes, tl, win_h, win_w, quantize)
        same = bool(torch.equal(got, want))
        if not same:
            raise SystemExit(f"patch_bilinear exact {key}: kernel disagrees with the plain version")
        k_ms = graph_ms(lambda: patch_bilinear(planes, tl, win_h, win_w, quantize), 20)
        p_ms = graph_ms(lambda: patch_bilinear_reference(planes, tl, win_h, win_w, quantize), 5)
        xs = (tl[:, 0, None, None] + jj).expand(-1, win_h, -1)
        ys = (tl[:, 1, None, None] + ii).expand(-1, -1, win_w)
        l_ms = grid_sample_ms(planes, xs, ys, "zeros", 20)
        c, n = planes.shape[0], tl.shape[0]
        call_bytes = min(planes.numel(), n * c * (win_h + 1) * (win_w + 1)) * 4 + n * 8 + got.numel() * 4
        call_ops = got.numel() * (11 if quantize else 7) + 12 * n
        n_bytes, f32_ops = n_bytes + call_bytes, f32_ops + call_ops
        out["exact_ms"] += k_ms
        out["exact_plain_ms"] += p_ms
        out["exact_library_ms"] += l_ms
        out["shape_ms"][f"exact {key}"] = k_ms
        out["shape_library_ms"][f"exact {key}"] = l_ms
        out["shape_bound_ms"][f"exact {key}"], _ = bound(call_bytes, call_ops)
        log(f"patch_bilinear exact {key} {tuple(got.shape)}: identical {same}, device time (graph replay) "
            f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, F.grid_sample {l_ms:.4f} ms, "
            "bound %.4f ms (%s)" % bound(call_bytes, call_ops))
    out["exact_bound_ms"], _ = bound(n_bytes, f32_ops)
    return out


def gather_rects_phase(dev, clip) -> dict:
    """Phase 13: extract_slabs_rect (the gather_rects kernel) on the 1080p
    level planes at the blocked kernel's slab shape (2304 rects of 118 x
    128 per level, 32 of them off the plane) vs its plain version; device
    times (graph replay) beside the bound and the one-call indexing
    gather."""
    from hackathonopticalflow_tpu_torch.core import measurement_grid
    from hackathonopticalflow_tpu_torch.ops import lk as lk_mod
    from hackathonopticalflow_tpu_torch.ops import patch as patch_mod
    from hackathonopticalflow_tpu_torch.ops.gather_rects import gather_rects, gather_rects_reference
    from hackathonopticalflow_tpu_torch.ops.patch_bilinear import slice_start

    params = new_lk_configs()["blocked"]
    win_w, win_h = params.win_size
    mx, my = (128 - win_w - 1) // 2, params.slab_margin_y
    ry, rx = win_h + 1 + 2 * my, win_w + 1 + 2 * mx
    pad = lk_mod._frame_pad(params)
    prep = lk_mod.prepare_frame(clip[0], params)
    pts_np = measurement_grid(H, W, 30)
    xs, ys = np.unique(pts_np[:, 0]).astype(int), np.unique(pts_np[:, 1]).astype(int)
    rng = np.random.RandomState(SEED)
    calls = {}
    for level in range(params.max_level, -1, -1):
        bx, _ = patch_mod._axis_bases(xs, level, (win_w - 1) * 0.5 + mx)
        by, _ = patch_mod._axis_bases(ys, level, (win_h - 1) * 0.5 + my)
        org = np.stack(np.meshgrid(bx, by, indexing="ij"), -1).reshape(-1, 2) + pad
        hp, wp = prep.img_p[level].shape
        org[-32:] = np.stack([rng.randint(-300, wp + 300, 32), rng.randint(-300, hp + 300, 32)], -1)
        calls[f"L{level}"] = (prep.img_p[level], torch.from_numpy(org.astype(np.int32)).to(dev))
    gather_rects.launches = 0
    outs = {k: patch_mod.extract_slabs_rect(plane, org, ry, rx) for k, (plane, org) in calls.items()}
    torch.cuda.synchronize()
    launches = gather_rects.launches
    log(f"extract_slabs_rect over the 3 levels: gather_rects launches {launches}")
    if launches != len(calls):
        raise SystemExit("extract_slabs_rect did not run the gather_rects kernel")
    ms = plain_ms = lib_ms = n_bytes = 0.0
    max_err = 0.0
    for key, (plane, org) in calls.items():
        ref = gather_rects_reference(plane, org, ry, rx)
        err = float((outs[key] - ref).abs().max())
        same = bool(torch.equal(outs[key], ref))
        log(f"gather_rects {key} {tuple(outs[key].shape)} of {tuple(plane.shape)}: max |d| {err:.3g}, identical {same}")
        if not same:
            raise SystemExit(f"gather_rects {key}: kernel disagrees with the plain version")
        max_err = max(max_err, err)
        hp, wp = plane.shape
        x0 = slice_start(org[:, 0].long(), wp, rx)
        y0 = slice_start(org[:, 1].long(), hp, ry)
        rows = (y0[:, None] + torch.arange(ry, device=dev))[:, :, None]
        cols = (x0[:, None] + torch.arange(rx, device=dev))[:, None, :]
        k_ms = graph_ms(lambda: gather_rects(plane, org, ry, rx), 20)
        p_ms = graph_ms(lambda: gather_rects_reference(plane, org, ry, rx), 5)
        l_ms = graph_ms(lambda: plane[rows, cols], 20)
        # the plane read once (at most), the origins, the rects written once
        call_bytes = min(plane.numel(), ref.numel()) * 4 + org.numel() * 4 + ref.numel() * 4
        ms, plain_ms, lib_ms, n_bytes = ms + k_ms, plain_ms + p_ms, lib_ms + l_ms, n_bytes + call_bytes
        log(f"gather_rects {key}: device time (graph replay) {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
            f"indexing gather {l_ms:.4f} ms, bound %.4f ms (%s)" % bound(call_bytes))
    bound_ms, bound_by = bound(n_bytes)
    log(f"gather_rects over the 3 levels: {ms:.4f} ms, plain {plain_ms:.4f} ms, indexing gather "
        f"{lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB)")
    return {
        "name": "gather_rects",
        "route": "cuda",
        "source": "hackathonopticalflow_tpu_torch/csrc/gather_rects.cu",
        "replaces": "hackathonopticalflow_tpu/ops/carve_pallas.py:85",
        "launches": launches,
        "launches_by_path": {"extract_slabs_rect": launches},
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": lib_ms,
    }


def new_scan_phases(dev, clip) -> dict:
    """Phase 14: lk_grid_flow_video over the 48-pair clip with the blocked
    kernel and with the exact path, and over a few pairs with
    rescue_large=False and with rescue_levels=1: finite fields, lk_level
    at every level of every pair, median endpoint error against the known
    flow < TOL_EPE_PX on status-true points, >= 95% status true, `good`
    agreeing with the plain path on >= 99% of points; fps through the
    kernels."""
    from hackathonopticalflow_tpu_torch.core import measurement_grid
    from hackathonopticalflow_tpu_torch.flow import lk_grid
    from hackathonopticalflow_tpu_torch.ops import lk as lk_mod
    from hackathonopticalflow_tpu_torch.ops import patch as patch_mod
    from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level, lk_level_reference
    from hackathonopticalflow_tpu_torch.ops.patch_bilinear import patch_bilinear, patch_bilinear_reference

    pts = torch.from_numpy(measurement_grid(H, W, 30)).to(dev)
    out = {"lk_level_launches": {}, "patch_bilinear_launches": {}}
    runs = {"blocked": N_FRAMES, "exact": N_FRAMES, "no_rescue": PLAIN_PAIRS + 1,
            "rescue_levels_1": PLAIN_PAIRS + 1}
    for config, params in new_lk_configs().items():
        frames = clip[: runs[config]]
        pairs = frames.shape[0] - 1
        lk_level.launches = patch_bilinear.launches = 0
        res = lk_grid.lk_grid_flow_video(frames, pts, lk=params, device=dev)
        torch.cuda.synchronize()
        out["lk_level_launches"][config] = lk_level.launches
        out["patch_bilinear_launches"][config] = patch_bilinear.launches
        log(f"{config} scan ({pairs} pairs): lk_level launches {lk_level.launches}, "
            f"patch_bilinear launches {patch_bilinear.launches}")
        if lk_level.launches < 3 * pairs:
            raise SystemExit(f"the {config} scan did not run lk_level at every level")
        for name, v in res._asdict().items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise SystemExit(f"{config}: non-finite values in {name}")
        st = res.status
        epe = torch.linalg.vector_norm(res.raw_next_pts.double() - true_backward(pts), dim=-1)
        med_epe = float(epe[st].median())
        st_frac = float(st.double().mean())
        with mock.patch.object(lk_mod, "lk_level", lk_level_reference), \
                mock.patch.object(patch_mod, "patch_bilinear", patch_bilinear_reference):
            plain = lk_grid.lk_grid_flow_video(clip[: PLAIN_PAIRS + 1], pts, lk=params, device=dev)
        good_agree = float((plain.good == res.good[:PLAIN_PAIRS]).double().mean())
        raw_diff = float((plain.raw_next_pts - res.raw_next_pts[:PLAIN_PAIRS]).abs().max())
        log(f"{config} scan: median EPE {med_epe:.4f} px on status-true points, status true {st_frac:.4f}, "
            f"good {float(res.good.double().mean()):.4f}; plain path ({PLAIN_PAIRS} pairs): good agreement "
            f"{good_agree:.4f}, max |raw_next_pts diff| {raw_diff:.3g} px")
        if not med_epe < TOL_EPE_PX or st_frac < 0.95 or good_agree < 0.99:
            raise SystemExit(f"the {config} scan's flow is wrong")
        out[f"{config}_median_epe_px"] = med_epe
        if pairs == N_FRAMES - 1:
            scan_s = min(host_seconds(lambda: lk_grid.lk_grid_flow_video(frames, pts, lk=params, device=dev))
                         for _ in range(2))
            out[f"{config}_scan_fps"] = pairs / scan_s
            log(f"{config} scan 48 pairs 1080p through the kernels: {pairs / scan_s:.2f} fps "
                f"({scan_s * 1e3:.1f} ms)")
    return out


APP_CHUNK = 24  # frame pairs per device chunk of the pathfinder app
APP_RUN_PAIRS = 8  # pairs through the app's one-pair loop
APP_RENDER_FRAMES = 2  # frames composited (the numpy rasterizer is slow at 1080p)


def app_phase(dev, clip, scan_fps: float) -> dict:
    """Phase 15: the pathfinder app at the production params on the
    49-frame 1080p zoom clip, read from host memory (ClipReader, BGR
    frames built before the app runs: no cv2 here): run_batched(chunk=APP_CHUNK) over the 48 pairs with lk_level at
    every level of every pair and per-pair danger counts equal to the
    scan's `good` sums; run over APP_RUN_PAIRS pairs with the same first
    counts; a checkpointed run of half the pairs and its resume with the
    full run's counts; APP_RENDER_FRAMES frames composited with their
    danger lamps; the app's steady-state fps (best of 3, render off)
    beside the scan's."""
    import os

    from hackathonopticalflow_tpu_torch.apps.pathfinder import PathfinderApp, PathfinderConfig
    from hackathonopticalflow_tpu_torch.core import LKParams, measurement_grid
    from hackathonopticalflow_tpu_torch.flow import lk_grid
    from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level
    from hackathonopticalflow_tpu_torch.ops.patch_bilinear import patch_bilinear
    from hackathonopticalflow_tpu_torch.ops.warp_bilinear import warp_bilinear
    from hackathonopticalflow_tpu_torch.viz.layers import draw_sparse_lamps

    params = LKParams(grid_step=30, compute_err=False)
    pairs = clip.shape[0] - 1
    frames = clip.cpu().numpy()
    bgr = ClipReader(frames).bgr  # replicated once, outside the app's clock
    pts = torch.from_numpy(measurement_grid(H, W, params.grid_step)).to(dev)
    want = lk_grid.lk_grid_flow_video(clip, pts, lk=params, device=dev).good.sum(1).tolist()

    def app(**kw):
        cfg = PathfinderConfig(video="synthetic zoom clip", lk=params, device=str(dev), **kw)
        return PathfinderApp(cfg, open_reader=lambda path: ClipReader(bgr))

    batched = app(max_frames=pairs)
    batched.warmup(APP_CHUNK)
    lk_level.launches = warp_bilinear.launches = patch_bilinear.launches = 0
    stats = batched.run_batched(chunk=APP_CHUNK, render=False)
    torch.cuda.synchronize()
    launches = lk_level.launches
    # 3 a pair, the padded tail chunk's pairs included
    expected = 3 * APP_CHUNK * -(-pairs // APP_CHUNK)
    counts = stats["danger_counts"]
    log(f"app run_batched ({stats['frames']} pairs, chunk {APP_CHUNK}): lk_level launches {launches} "
        f"({expected} expected), warp_bilinear {warp_bilinear.launches}, patch_bilinear "
        f"{patch_bilinear.launches}; danger counts equal to the scan's good sums {counts == want}, "
        f"mean {stats['mean_danger_points']:.1f} of {pts.shape[0]}")
    if launches != expected or stats["frames"] != pairs or counts != want:
        raise SystemExit("the app's chunked pipeline disagrees with the scan")

    serial = app(max_frames=APP_RUN_PAIRS).run(headless=True, render=False)
    log(f"app run ({serial['frames']} pairs): counts equal to the first {APP_RUN_PAIRS} "
        f"{serial['danger_counts'] == want[:APP_RUN_PAIRS]}")
    if serial["danger_counts"] != want[:APP_RUN_PAIRS]:
        raise SystemExit("the app's one-pair loop disagrees with the scan")

    ck = os.path.join("build", "chip_smoke_pathfinder.ckpt.npz")
    os.makedirs("build", exist_ok=True)
    if os.path.exists(ck):
        os.remove(ck)
    half = pairs // 2
    part1 = app(max_frames=half, checkpoint_path=ck, checkpoint_every=APP_CHUNK).run_batched(chunk=APP_CHUNK)
    part2 = app(max_frames=pairs, checkpoint_path=ck, checkpoint_every=APP_CHUNK).run_batched(chunk=APP_CHUNK)
    os.remove(ck)
    resumed = part1["danger_counts"] + part2["danger_counts"]
    log(f"app checkpointed run: {part1['frames']} pairs, resume from frame {part2['first_pair_frame']}: "
        f"{part2['frames']} pairs; counts equal to the full run {resumed == counts}")
    if resumed != counts or part2["first_pair_frame"] != half + 1:
        raise SystemExit("the resumed app run disagrees with the full run")

    render_app = app(max_frames=APP_RENDER_FRAMES)
    for t in range(1, APP_RENDER_FRAMES + 1):
        res = render_app.compute_frame(frames[t - 1], frames[t])
        out = render_app.render_frame(bgr[t], res)  # no FPS text over the lamps
        good, pts_i, next_i = (x.cpu().numpy() for x in (res.good, res.pts, res.next_pts))
        lamps = draw_sparse_lamps((H, W), (next_i - pts_i)[good], pts_i[good])
        lamp_px = int((lamps[..., 2] > 0).sum())
        log(f"app render_frame {t}: {out.shape} {out.dtype}, {lamp_px} lamp pixels")
        if out.shape != (H, W, 3) or out.dtype != np.uint8 or lamp_px == 0 or (out[..., 2] < lamps[..., 2]).any():
            raise SystemExit("the app's rendered frame lacks its danger lamps")

    app_s = []
    for _ in range(3):
        s = batched.run_batched(chunk=APP_CHUNK, render=False)
        if s["danger_counts"] != want:
            raise SystemExit("the app's counts changed between runs")
        app_s.append(s["wall_s"])
    fps = pairs / min(app_s)
    log(f"app run_batched {pairs} pairs {H}p (render off): {fps:.2f} fps, best of 3 "
        f"({min(app_s) * 1e3:.1f} ms); production scan (phase 5) {scan_fps:.2f} fps; "
        f"app / scan {fps / scan_fps:.3f}")
    return {"app_fps": fps, "app_launches": launches}


def main() -> int:
    t_start = time.perf_counter()
    # ---- 1. device check ----
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. kernel build ----
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    from hackathonopticalflow_tpu_torch import kernels

    names = ["lk_level", "warp_bilinear", "patch_bilinear", "gather_rects"]
    t0 = time.perf_counter()
    paths = kernels.build_all(names)
    for name in names:
        kernels.load(name)
    log(f"build {', '.join(names)}: {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for name, path in zip(names, paths):
        log(f"  {name} -> {path}")
        for line in path.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas {name}:", line.strip())
    variants = {name: kernel_variants(name, path) for name, path in zip(names, paths)
                if name in ("lk_level", "patch_bilinear")}

    clip = make_clip(dev, H, W, N_FRAMES)
    log(f"1080p clip: {tuple(clip.shape)} uint8, zoom {ZOOM}/frame")
    sparse = sparse_phases(dev, clip)
    dense = dense_phases(dev)
    track = tracker_phases(dev, clip)
    new_lk = new_lk_phases(dev, clip)
    exact_pb = exact_patch_phase(dev, clip)
    gather = gather_rects_phase(dev, clip)
    scans = new_scan_phases(dev, clip)
    app = app_phase(dev, clip, sparse["scan_fps"])

    foreign = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "hackathonopticalflow_tpu"))
    if foreign:
        raise SystemExit(f"the port loaded jax or the JAX package: {foreign[:5]}")

    lk = sparse.pop("kernel")
    lk_track = track.pop("lk_level")
    lk["launches_by_path"]["tracker"] = lk_track.pop("launches")
    lk["launches_by_path"].update(scans.pop("lk_level_launches"))
    lk["launches_by_path"]["app"] = app.pop("app_launches")
    lk["launches"] = sum(lk["launches_by_path"].values())
    lk["max_abs_err"] = max(lk["max_abs_err"], lk_track.pop("max_abs_err"), new_lk.pop("max_abs_err"))
    lk["replaces"] += ", hackathonopticalflow_tpu/ops/lk_pallas2.py:64"
    merge_records(lk, lk_track)
    merge_records(lk, new_lk)
    lk["variants"] = variants["lk_level"]
    pb = track.pop("kernel")
    pb["launches_by_path"]["exact"] = scans.pop("patch_bilinear_launches")["exact"]
    pb["launches"] = sum(pb["launches_by_path"].values())
    merge_records(pb, exact_pb)
    pb["variants"] = variants["patch_bilinear"]
    record = {"kernels": [lk, dense.pop("kernel"), pb, gather], **sparse, **dense, **track, **scans, **app}
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
