#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's sparse pathfinder path and its dense
Farneback path once on one GPU.

Run from the repository root, on a machine with one CUDA GPU and the CUDA
toolkit (nvcc under $CUDA_HOME or /usr/local/cuda):

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. device check: a CUDA device is required, there is no CPU path;
2. kernel build: csrc/lk_level.cu and csrc/warp_bilinear.cu ->
   build/torch_kernels/ (one nvcc each, started together, sm_90a);
3. lk_level kernel vs its plain PyTorch version at L2, L1 and L0 of the
   production params on one 1080p pair: status and top-lefts identical
   (both sum exactly in float64, so any difference is a fault), and the
   kernel launched at every level;
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
   of 3 each).

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


def host_seconds(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def sparse_phases(dev) -> dict:
    """Phases 3-5: the sparse pathfinder path through lk_level."""
    from hackathonopticalflow_tpu_torch.core import LKParams, measurement_grid
    from hackathonopticalflow_tpu_torch.flow import lk_grid
    from hackathonopticalflow_tpu_torch.ops import lk as lk_mod
    from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level, lk_level_reference
    from hackathonopticalflow_tpu_torch.ops.warp_bilinear import warp_bilinear

    params = LKParams(grid_step=30, compute_err=False)
    clip = make_clip(dev, H, W, N_FRAMES)
    pts_np = measurement_grid(H, W, params.grid_step)
    pts = torch.from_numpy(pts_np).to(dev)
    grid_xy = (np.unique(pts_np[:, 0]).astype(int), np.unique(pts_np[:, 1]).astype(int))
    log(f"sparse clip: {tuple(clip.shape)} uint8, {pts.shape[0]} grid points, zoom {ZOOM}/frame")

    # ---- 3. kernel vs plain, per level (backward: template = frame 1) ----
    cur = lk_mod.prepare_frame(clip[1], params)
    prev = lk_mod.prepare_frame(clip[0], params)
    center = pts * (1.0 / (1 << params.max_level))
    status = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    max_err = 0.0
    level_ms, level_plain_ms = {}, {}
    for level in range(params.max_level, -1, -1):
        if level != params.max_level:
            center = center * 2.0
        args, statics = lk_mod.level_inputs(cur, prev, grid_xy, center, level, params)
        lk_level.launches = 0
        tl_k, st_k = lk_level(*args, status, **statics)
        torch.cuda.synchronize()
        launches = lk_level.launches
        tl_p, st_p = lk_level_reference(*args, status, **statics)
        err = float(torch.linalg.vector_norm(tl_k - tl_p, dim=-1).max())
        same_status = bool(torch.equal(st_k, st_p))
        same_tl = bool(torch.equal(tl_k, tl_p))
        log(f"L{level}: launches {launches}, max |d| {err:.3g} px, top-lefts identical "
            f"{same_tl}, status identical {same_status}, "
            f"status true {float(st_k.float().mean()):.4f}")
        if launches < 1 or not same_status or not same_tl:
            raise SystemExit(f"L{level}: kernel disagrees with the plain version")
        max_err = max(max_err, err)
        level_ms[level] = cuda_ms(lambda: lk_level(*args, status, **statics), 20)
        level_plain_ms[level] = cuda_ms(lambda: lk_level_reference(*args, status, **statics), 3)
        log(f"L{level}: lk_level {level_ms[level]:.4f} ms, plain {level_plain_ms[level]:.4f} ms")
        center = tl_p + lk_mod._halfwin(params, dev)
        status = st_p

    # ---- 4. main path ----
    lk_level.launches = 0
    warp_bilinear.launches = 0
    res = lk_grid.lk_grid_flow_video(clip, pts, lk=params)
    one = lk_grid.lk_grid_flow(clip[0], clip[1], pts, lk=params)
    torch.cuda.synchronize()
    main_launches = lk_level.launches
    log(f"sparse main path: lk_level launches {main_launches}, warp_bilinear launches "
        f"{warp_bilinear.launches}")
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
        plain = lk_grid.lk_grid_flow_video(clip[: PLAIN_PAIRS + 1], pts, lk=params)
    good_agree = float((plain.good == res.good[:PLAIN_PAIRS]).double().mean())
    raw_diff = float((plain.raw_next_pts - res.raw_next_pts[:PLAIN_PAIRS]).abs().max())
    log(f"plain path ({PLAIN_PAIRS} pairs): good agreement {good_agree:.4f}, "
        f"max |raw_next_pts diff| {raw_diff:.3g} px")
    if good_agree < 0.99:
        raise SystemExit("good disagrees with the plain path")

    # ---- 5. times ----
    scan_s = min(host_seconds(lambda: lk_grid.lk_grid_flow_video(clip, pts, lk=params))
                 for _ in range(3))
    with mock.patch.object(lk_mod, "lk_level", lk_level_reference):
        lk_grid.lk_grid_flow_video(clip[: PLAIN_PAIRS + 1], pts, lk=params)
        plain_s = min(
            host_seconds(lambda: lk_grid.lk_grid_flow_video(clip[: PLAIN_PAIRS + 1], pts, lk=params))
            for _ in range(2)
        )
    fps = (N_FRAMES - 1) / scan_s
    plain_fps = PLAIN_PAIRS / plain_s
    log(f"sparse scan 48 pairs 1080p through lk_level: {fps:.2f} fps ({scan_s * 1e3:.1f} ms)")
    log(f"sparse scan {PLAIN_PAIRS} pairs 1080p through lk_level_reference: {plain_fps:.2f} fps "
        f"({plain_s * 1e3:.1f} ms)")
    log("lk_level per level (ms, kernel / plain): "
        + ", ".join(f"L{lv} {level_ms[lv]:.4f} / {level_plain_ms[lv]:.4f}" for lv in level_ms))
    return {
        "kernel": {
            "name": "lk_level",
            "route": "cuda",
            "source": "hackathonopticalflow_tpu_torch/csrc/lk_level.cu",
            "replaces": "hackathonopticalflow_tpu/ops/lk_pallas3.py:82, "
            "hackathonopticalflow_tpu/ops/lk_pallas3.py:353, "
            "hackathonopticalflow_tpu/ops/carve_pallas.py:159",
            "launches": main_launches,
            "max_abs_err": max_err,
            "ms": sum(level_ms.values()),
            "plain_ms": sum(level_plain_ms.values()),
        },
        "scan_fps": fps,
        "plain_scan_fps": plain_fps,
        "median_epe_px": med_epe,
    }


def dense_phases(dev) -> dict:
    """Phases 6-8: the dense Farneback path through warp_bilinear."""
    from hackathonopticalflow_tpu_torch.core import FarnebackParams
    from hackathonopticalflow_tpu_torch.flow import dense
    from hackathonopticalflow_tpu_torch.ops import farneback as fb
    from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level
    from hackathonopticalflow_tpu_torch.ops.warp_bilinear import warp_bilinear, warp_bilinear_reference

    params = FarnebackParams()
    clip = make_clip(dev, DENSE_H, DENSE_W, DENSE_FRAMES, DENSE_CELL)
    pairs = DENSE_FRAMES - 1
    log(f"dense clip: {tuple(clip.shape)} uint8, lattice {DENSE_CELL} px, zoom {ZOOM}/frame, {params}")

    # ---- 6. kernel vs plain at the 4 level sizes of one pair ----
    rs0 = fb.prepare_frame(clip[0], params)
    rs1 = fb.prepare_frame(clip[1], params)
    max_err = 0.0
    level_ms, level_plain_ms = {}, {}
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
        call_ms = cuda_ms(lambda: warp_bilinear(r1, fx, fy), 50)
        call_plain_ms = cuda_ms(lambda: warp_bilinear_reference(r1, fx, fy), 10)
        log(f"warp {key}: device time (graph replay) warp_bilinear {level_ms[key]:.4f} ms, "
            f"plain {level_plain_ms[key]:.4f} ms; eager call to call {call_ms:.4f} ms, "
            f"plain {call_plain_ms:.4f} ms")

    # ---- 7. main path ----
    lk_level.launches = 0
    warp_bilinear.launches = 0
    flows = dense.farneback_flow_video(clip, params)
    one = dense.farneback_flow(clip[0], clip[1], params)
    torch.cuda.synchronize()
    main_launches = warp_bilinear.launches
    per_pair = params.iterations * (params.levels + 1)
    log(f"dense main path: warp_bilinear launches {main_launches} "
        f"({per_pair} per pair expected), lk_level launches {lk_level.launches}")
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
        plain = dense.farneback_flow_video(plain_clip, params)
    same = bool(torch.equal(plain, flows[:DENSE_PLAIN_PAIRS]))
    log(f"plain path ({DENSE_PLAIN_PAIRS} pairs): identical to the kernel path {same}, "
        f"max |d| {float((plain - flows[:DENSE_PLAIN_PAIRS]).abs().max()):.3g} px")
    if not same:
        raise SystemExit("the dense kernel path disagrees with the plain path")

    # ---- 8. times ----
    scan_s = min(host_seconds(lambda: dense.farneback_flow_video(clip, params)) for _ in range(3))
    with mock.patch.object(fb, "warp_bilinear", warp_bilinear_reference):
        plain_s = min(host_seconds(lambda: dense.farneback_flow_video(plain_clip, params))
                      for _ in range(3))
    short_s = min(host_seconds(lambda: dense.farneback_flow_video(plain_clip, params)) for _ in range(3))
    fps = pairs / scan_s
    plain_fps = DENSE_PLAIN_PAIRS / plain_s
    log(f"dense scan {pairs} pairs 720p through warp_bilinear: {fps:.2f} fps ({scan_s * 1e3:.1f} ms)")
    log(f"dense scan {DENSE_PLAIN_PAIRS} pairs 720p through warp_bilinear_reference: "
        f"{plain_fps:.2f} fps ({plain_s * 1e3:.1f} ms); through warp_bilinear: "
        f"{DENSE_PLAIN_PAIRS / short_s:.2f} fps ({short_s * 1e3:.1f} ms)")
    log("warp_bilinear per level (device ms, kernel / plain): "
        + ", ".join(f"{k} {level_ms[k]:.4f} / {level_plain_ms[k]:.4f}" for k in level_ms))
    return {
        "kernel": {
            "name": "warp_bilinear",
            "route": "cuda",
            "source": "hackathonopticalflow_tpu_torch/csrc/warp_bilinear.cu",
            "replaces": "hackathonopticalflow_tpu/ops/warp_pallas.py:207",
            "launches": main_launches,
            "max_abs_err": max_err,
            "ms": sum(level_ms.values()),
            "plain_ms": sum(level_plain_ms.values()),
        },
        "dense_fps": fps,
        "plain_dense_fps": plain_fps,
        "dense_median_epe_px": med_epe,
    }


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

    names = ["lk_level", "warp_bilinear"]
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

    sparse = sparse_phases(dev)
    dense = dense_phases(dev)

    foreign = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "hackathonopticalflow_tpu"))
    if foreign:
        raise SystemExit(f"the port loaded jax or the JAX package: {foreign[:5]}")

    record = {"kernels": [sparse.pop("kernel"), dense.pop("kernel")], **sparse, **dense}
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
