#!/usr/bin/env python3
"""Where the time goes in the port's 1080p sparse scan, 720p dense scan,
1080p tracker scan, 1080p pathfinder app, 1080p ego-motion geometry or
four-stream 1080p batch runner, on one CUDA GPU.

Run from the repository root:

    python3 profile_torch_scan.py [--path sparse|dense|tracker|app|ego|batch] [--pairs 8] [--out PATH]
        [--warp-mode auto|exact|packed|pallas|pallas_bf16|image|hybrid] [--gpu-geometry] [--eager]

Drives `--pairs` pairs of chip_smoke.py's synthetic zoom clip:
`lk_grid_flow_video` at the production params (--path sparse, the
default), `farneback_flow_video` at the reference FarnebackParams in
--warp-mode (--path dense; "image" and "hybrid" pair by pair),
`track_video` at TrackerParams() after a seeding step on the first frame
(--path tracker; a step per pair) or the pathfinder app's
`run_batched` at the production params, chunks of APP_CHUNK pairs, render
off, its frames read from host memory (--path app; host API calls are
also given per chunk) or ego_motion_track's geometry at OdometryConfig()
on chip_smoke.py's 3D-scene track table of `--pairs` + 1 frames and 256
slots (--path ego; a frame per pair; keyframes on the GPU and windows on
the host, as ego_motion_track's default, or with --gpu-geometry the
windows on the GPU too) or the batch runner's `run_batch`
at the production params on chip_smoke.py's four phase-21 streams cut to
`--pairs` + 1 frames, read from host memory (--path batch; a step, 4
pairs, per pair index; its counts include run_batch's warm-up step, so
they are given per step of `--pairs` + 1). The steps run as the paths run
them, each one captured CUDA graph replayed (utils/graphs.py); with
--eager, as their eager form (chip_smoke.eager: every step's
__wrapped__, one launch per op). It prints:
- the GPU's name and power limit (nvidia-smi);
- the scan's wall time without the profiler (best of 3) and the device
  time that torch.profiler records over one more scan, so the device's
  busy share is device time / wall time;
- host API calls per pair (kernel and graph launches, stream syncs,
  memcpys) and
  the device's copies per pair by kind (pageable host-to-device copies
  each cost the host a sync);
- device time by kind of kernel (lk_level, warp_bilinear,
  patch_bilinear, index/gather, elementwise, ...) and the top device ops;
- stage times from CUDA events for one pair: sparse: prepare_frame,
  the grid templates, level_inputs (templates included) and lk_level per
  level, pyr_lk_prepared, _post_lk; dense:
  prepare_frame, update_matrices and the solve per level,
  farneback_prepared; tracker: prepare_frame, one pyr_lk_prepared,
  good_features_to_track, _detect_mask, and track_step_prepared on a step
  without and with detection; app: the gray conversion of one frame (host
  clock) and one chunk's device work; ego: select_keyframes, the first
  group of windows' solve (RANSAC chain, triangulation, gate, BA) and,
  for scale, collect_tracks over the zoom clip's first `--pairs` + 1
  frames; batch: prepare_frame and one step's lk_grid_flow_prepared for
  the four streams and for one.
The full profiler tables go to --out (default
build/profile_torch_scan[_<path>].txt); the last line is the
summary as one JSON object.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import APP_CHUNK, DENSE_CELL, DENSE_H, DENSE_W, H, W, ClipReader, cuda_ms, eager, make_clip, scene_table
from hackathonopticalflow_tpu_torch.core import (
    FarnebackParams,
    FilterParams,
    LKParams,
    NormalizeParams,
    TrackerParams,
    measurement_grid,
)
from hackathonopticalflow_tpu_torch.flow import dense, lk_grid, tracker
from hackathonopticalflow_tpu_torch.ops import features
from hackathonopticalflow_tpu_torch.ops import lk as lk_mod
from hackathonopticalflow_tpu_torch.ops.grid_templates import grid_templates
from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level

# the package's ops/__init__ re-exports a function named farneback
fb = importlib.import_module("hackathonopticalflow_tpu_torch.ops.farneback")

KINDS = (
    ("lk_level", ("lk_level",)),
    ("warp_bilinear", ("warp_bilinear",)),
    ("patch_bilinear", ("patch_bilinear",)),
    ("gather_rects", ("gather_rects",)),
    ("grid_templates", ("grid_templates",)),
    ("index/gather", ("index", "gather")),
    ("sort", ("sort",)),
    ("elementwise", ("elementwise", "reduce")),
    ("memcpy/memset", ("memcpy", "memset")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def sparse_setup(dev, pairs: int):
    """The sparse scan over `pairs` 1080p pairs and its stage timer."""
    params = LKParams(grid_step=30, compute_err=False)
    clip = make_clip(dev)[: pairs + 1]
    pts = torch.from_numpy(measurement_grid(H, W, params.grid_step)).to(dev)

    def scan():
        return lk_grid.lk_grid_flow_video(clip, pts, lk=params, device=dev)

    def stages():
        """One pair (backward: template from frame 1, search in 0)."""
        grid_np = measurement_grid(H, W, params.grid_step)
        grid_xy = (np.unique(grid_np[:, 0]).astype(int), np.unique(grid_np[:, 1]).astype(int))
        cur = lk_mod.prepare_frame(clip[1], params)
        prev = lk_mod.prepare_frame(clip[0], params)
        out = {"prepare_frame": cuda_ms(lambda: lk_mod.prepare_frame(clip[1], params), 10)}
        center = pts * (1.0 / (1 << params.max_level))
        status = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
        for level in range(params.max_level, -1, -1):
            if level != params.max_level:
                center = center * 2.0
            planes = (cur.img_p[level], cur.dix_p[level], cur.diy_p[level])
            out[f"grid_templates L{level}"] = cuda_ms(
                lambda: grid_templates(*planes, *grid_xy, level, *params.win_size, lk_mod._frame_pad(params)), 10
            )
            out[f"level_inputs L{level}"] = cuda_ms(
                lambda: lk_mod.level_inputs(cur, prev, grid_xy, center, level, params), 10
            )
            lvl_args, statics = lk_mod.level_inputs(cur, prev, grid_xy, center, level, params)
            out[f"lk_level L{level}"] = cuda_ms(lambda: lk_level(*lvl_args, status, **statics), 10)
            tl, status = lk_level(*lvl_args, status, **statics)
            center = tl + lk_mod._halfwin(params, dev)
        res = lk_mod.pyr_lk_prepared(cur, prev, pts, params)
        out["pyr_lk_prepared"] = cuda_ms(lambda: lk_mod.pyr_lk_prepared(cur, prev, pts, params), 10)
        out["_post_lk"] = cuda_ms(
            lambda: lk_grid._post_lk(res, pts, H, W, NormalizeParams(), FilterParams()), 10
        )
        return out

    return scan, stages, "1080p", ()


def dense_setup(dev, pairs: int, warp_mode: str = "auto"):
    """The dense scan over `pairs` 720p pairs in `warp_mode` and its stage
    timer ("image" and "hybrid", which the clip scan refuses, run
    farneback_flow pair by pair; their stages are prepare_frame and
    farneback alone)."""
    params = FarnebackParams(warp_mode=warp_mode)
    mode = fb.resolve_mode(params).warp_mode
    coef = mode in fb.COEF_MODES
    clip = make_clip(dev, DENSE_H, DENSE_W, pairs + 1, DENSE_CELL)

    def scan():
        if coef:
            return dense.farneback_flow_video(clip, params, device=dev)
        return [dense.farneback_flow(clip[t], clip[t + 1], params, device=dev) for t in range(pairs)]

    def stages():
        """One pair; each level at the flow the scan reaches there."""
        out = {"prepare_frame": cuda_ms(lambda: fb.prepare_frame(clip[1], params), 10)}
        if not coef:
            out["farneback"] = cuda_ms(lambda: fb.farneback(clip[0], clip[1], params), 10)
            return out
        rs0 = fb.prepare_frame(clip[0], params)
        rs1 = fb.prepare_frame(clip[1], params)
        flow = None
        for r0, r1 in zip(rs0, rs1):
            hk, wk = r0.shape[-2:]
            if flow is None:
                flow = torch.zeros((hk, wk, 2), dtype=torch.float32, device=dev)
            else:
                flow = fb.resize_bilinear(flow.movedim(-1, -3), hk, wk).movedim(-3, -1) * 2.0
            m = fb.update_matrices(r0, r1, flow, mode)
            out[f"update_matrices {hk}x{wk}"] = cuda_ms(lambda: fb.update_matrices(r0, r1, flow, mode), 10)
            out[f"solve {hk}x{wk}"] = cuda_ms(lambda: fb._solve_flow(m, params), 10)
            flow = fb._solve_flow(m, params)
        out["farneback_prepared"] = cuda_ms(lambda: fb.farneback_prepared(rs0, rs1, params), 10)
        return out

    return scan, stages, "720p", ()


def tracker_setup(dev, pairs: int):
    """The tracker over `pairs` 1080p steps and its stage timer."""
    params = TrackerParams()
    clip = make_clip(dev)[: pairs + 1]
    s0 = tracker.track_step(tracker.init_tracker(params, dev), clip[0], clip[0], params, device=dev)

    def scan():
        return tracker.track_video(clip, params, s0, device=dev)

    def stages():
        """One step from the seeded state (frame_idx 1: no detection) and
        the same step with detection."""
        prev = lk_mod.prepare_frame(clip[0], params.lk)
        cur = lk_mod.prepare_frame(clip[1], params.lk)
        gray = clip[1].to(torch.float32)
        heads = tracker._heads(s0)
        out = {"prepare_frame": cuda_ms(lambda: lk_mod.prepare_frame(clip[1], params.lk), 10)}
        out["pyr_lk_prepared"] = cuda_ms(lambda: lk_mod.pyr_lk_prepared(prev, cur, heads, params.lk), 10)
        out["_detect_mask"] = cuda_ms(lambda: tracker._detect_mask(heads, s0.alive, H, W), 10)
        out["good_features_to_track"] = cuda_ms(
            lambda: features.good_features_to_track(gray, params.features), 10
        )
        out["track_step_prepared"] = cuda_ms(
            lambda: tracker.track_step_prepared(s0, prev, cur, gray, params), 10
        )
        s5 = s0._replace(frame_idx=params.detect_interval)
        out["track_step_prepared with detection"] = cuda_ms(
            lambda: tracker.track_step_prepared(s5, prev, cur, gray, params), 10
        )
        return out

    return scan, stages, "1080p", ()


def app_setup(dev, pairs: int):
    """The pathfinder app's chunked pipeline over `pairs` 1080p pairs and
    its stage timer."""
    from hackathonopticalflow_tpu_torch.apps.pathfinder import PathfinderApp, PathfinderConfig
    from hackathonopticalflow_tpu_torch.io.prefetch import to_gray

    frames = make_clip(dev)[: pairs + 1].cpu().numpy()
    bgr = ClipReader(frames).bgr
    chunk = min(APP_CHUNK, pairs)
    cfg = PathfinderConfig(video="synthetic zoom clip", max_frames=pairs,
                           lk=LKParams(grid_step=30, compute_err=False), device=str(dev))
    app = PathfinderApp(cfg, open_reader=lambda path: ClipReader(bgr))

    def scan():
        return app.run_batched(chunk=chunk, render=False)

    def stages():
        to_gray(bgr[1])
        t0 = time.perf_counter()
        for _ in range(10):
            to_gray(bgr[1])
        out = {"to_gray (host)": (time.perf_counter() - t0) * 100}
        chunk_dev = torch.from_numpy(frames[: chunk + 1]).to(dev)
        out[f"chunk of {chunk} pairs"] = cuda_ms(lambda: app._chunk(chunk_dev, app._pts_dev), 3)
        return out

    return scan, stages, f"1080p, chunks of {chunk}", (app,)


def ego_setup(dev, pairs: int, gpu_geometry: bool = False):
    """The ego-motion geometry over a 3D-scene table of `pairs` + 1 1080p
    frames and its stage timer: keyframes on the GPU and the windows on
    the host (the default route), or with `gpu_geometry` the windows on
    the GPU too."""
    from hackathonopticalflow_tpu_torch.nav import odometry as odo
    from hackathonopticalflow_tpu_torch.nav.camera import Pinhole

    params = TrackerParams()
    cam = Pinhole.from_fov(W, H, 155.0)
    cfg = odo.OdometryConfig()
    table = odo.TrackTable(*scene_table(n_frames=pairs + 1)[0])
    geo = dev if gpu_geometry else torch.device("cpu")

    def scan():
        return odo.ego_motion_track(None, params, cam, cfg, table=table, device=dev, geometry_device=geo)

    def stages():
        clip = make_clip(dev)[: pairs + 1]
        kf = odo.select_keyframes(table, cam, cfg, dev)
        out = {"collect_tracks": cuda_ms(lambda: odo.collect_tracks(clip, params, device=dev), 2),
               "select_keyframes": cuda_ms(lambda: odo.select_keyframes(table, cam, cfg, dev), 3)}
        wins = [odo.build_window(table, kf[i : i + cfg.window], cfg) for i in range(len(kf) - cfg.window + 1)]
        obs = cam.normalize(np.stack([w[0] for w in wins])).to(geo)
        mask = torch.from_numpy(np.stack([w[1] for w in wins])).to(geo)
        solved = odo.resolve_config(cfg, cam)
        out[f"_window_solve of {len(wins)} windows on {geo.type}"] = cuda_ms(
            lambda: odo._window_solve(obs, mask, solved), 3)
        return out

    return scan, stages, f"1080p, 256 slots, windows on {geo.type}", ()


def batch_setup(dev, pairs: int):
    """The batch runner's run_batch over four 1080p streams of `pairs` + 1
    frames (chip_smoke.py phase 21's, cut) and its stage timer."""
    from chip_smoke import batch_streams
    from hackathonopticalflow_tpu_torch.apps.batch_runner import BatchRunnerConfig, run_batch

    params = LKParams(grid_step=30, compute_err=False)
    streams = [f[: pairs + 1] for f in batch_streams(dev)]
    bgr = {f"stream{i}": ClipReader(f).bgr for i, f in enumerate(streams)}
    cfg = BatchRunnerConfig(videos=list(bgr), max_frames=pairs + 1, lk=params, device=str(dev),
                            open_reader=lambda path: ClipReader(bgr[path]))
    pts = torch.from_numpy(measurement_grid(H, W, params.grid_step)).to(dev)

    def scan():
        return run_batch(cfg)

    def stages():
        out = {}
        for nb in (len(streams), 1):
            frames = torch.from_numpy(np.stack([f[:2] for f in streams[:nb]], 1)).to(dev)  # (2, nb, H, W)
            prev, cur = lk_mod.prepare_frame(frames[0], params), lk_mod.prepare_frame(frames[1], params)
            out[f"prepare_frame B={nb}"] = cuda_ms(lambda: lk_mod.prepare_frame(frames[1], params), 10)
            out[f"lk_grid_flow_prepared B={nb}"] = cuda_ms(
                lambda: lk_grid.lk_grid_flow_prepared(prev, cur, pts, params), 10)
        return out

    return scan, stages, f"{len(streams)} streams x 1080p", ()


SETUPS = {"sparse": sparse_setup, "dense": dense_setup, "tracker": tracker_setup, "app": app_setup,
          "ego": ego_setup, "batch": batch_setup}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=tuple(SETUPS), default="sparse")
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--warp-mode", default="auto", help="FarnebackParams.warp_mode of --path dense")
    ap.add_argument("--gpu-geometry", action="store_true",
                    help="--path ego: solve the windows on the GPU (geometry_device) instead of the host")
    ap.add_argument("--eager", action="store_true",
                    help="run every captured step as its eager form (__wrapped__) instead of replaying its graph")
    args = ap.parse_args()
    if args.out is None:
        suffix = "" if args.path == "sparse" else f"_{args.path}"
        if args.path == "dense" and args.warp_mode != "auto":
            suffix += f"_{args.warp_mode}"
        if args.path == "ego" and args.gpu_geometry:
            suffix += "_gpu"
        if args.eager:
            suffix += "_eager"
        args.out = Path(f"build/profile_torch_scan{suffix}.txt")
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_scan: needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    extra = {"warp_mode": args.warp_mode} if args.path == "dense" else {}
    if args.path == "ego":
        extra = {"gpu_geometry": args.gpu_geometry}
    scan, stages_fn, size, objs = SETUPS[args.path](dev, args.pairs, **extra)
    form = eager(*objs) if args.eager else contextlib.nullcontext()
    with form:
        summary = measure(args, smi, scan, stages_fn, size, extra)
    print(json.dumps(summary))
    return 0


def measure(args, smi: str, scan, stages_fn, size: str, extra: dict) -> dict:
    """Times, profiles and stage-times `scan`; prints the readings and
    writes the tables; returns the summary."""
    scan()  # builds the kernel, warms the caching allocator, captures the graphs
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = min(walls) * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        scan()
        torch.cuda.synchronize()
    events = prof.events()
    dev_us = collections.Counter()
    op_us = collections.Counter()
    for e in events:
        if e.device_type == DeviceType.CUDA:
            dev_us[kind_of(e.name)] += e.time_range.elapsed_us()
            op_us[e.name[:80]] += e.time_range.elapsed_us()
    api = collections.Counter(
        e.name for e in events if e.device_type == DeviceType.CPU and e.name.startswith("cuda")
    )
    copies = collections.Counter(
        e.name for e in events if e.device_type == DeviceType.CUDA and e.name.startswith("Memcpy")
    )
    device_ms = sum(dev_us.values()) / 1e3
    launches = sum(n for name, n in api.items() if name.startswith("cudaLaunch") or name == "cudaGraphLaunch")
    # per pair; the batch runner's per step, its warm-up step included
    unit, units = ("step", args.pairs + 1) if args.path == "batch" else ("pair", args.pairs)
    stages = stages_fn()

    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("w") as f:
        f.write(f"{smi}\n")
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
        f.write("\n")
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=25))
    form = "eager" if args.eager else "graphed"
    print(f"{args.path} scan {args.pairs} pairs {size}, {form}: wall {wall_ms:.2f} ms unprofiled (best of 3), "
          f"device {device_ms:.3f} ms profiled, busy share {device_ms / wall_ms:.3f}")
    print(f"host API calls per {unit}: "
          + ", ".join(f"{k} {v / units:.1f}" for k, v in api.most_common(6)))
    if args.path == "app":
        n_chunks = -(-args.pairs // min(APP_CHUNK, args.pairs))
        print(f"host API calls per chunk ({n_chunks} chunks): "
              + ", ".join(f"{k} {v / n_chunks:.1f}" for k, v in api.most_common(8)))
    print(f"device copies per {unit}: "
          + (", ".join(f"{k} {v / units:.1f}" for k, v in copies.most_common()) or "none"))
    print("device time by kind (ms, share): " + ", ".join(
        f"{k} {v / 1e3:.3f} ({v / 1e3 / device_ms:.3f})" for k, v in dev_us.most_common()))
    print("top device ops (ms, share): " + "; ".join(
        f"{k} {v / 1e3:.3f} ({v / 1e3 / device_ms:.3f})" for k, v in op_us.most_common(8)))
    print(f"stage times, one {unit} (ms, CUDA events, mean of 10): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    print(f"profiler tables: {args.out}")
    return {
        "gpu": smi, "path": args.path, **extra, "form": form, "pairs": args.pairs, "wall_ms": wall_ms,
        "device_ms": device_ms, "busy_share": device_ms / wall_ms,
        f"launches_per_{unit}": launches / units, "api_calls": dict(api),
        "device_copies": dict(copies),
        "device_ms_by_kind": {k: v / 1e3 for k, v in dev_us.items()},
        "top_device_ops_ms": {k: v / 1e3 for k, v in op_us.most_common(8)},
        "stage_ms": stages,
    }


if __name__ == "__main__":
    raise SystemExit(main())
