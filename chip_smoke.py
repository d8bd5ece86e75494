#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's sparse pathfinder path (and its other LK
configurations: the blocked grid kernel, the lanes kernel without a
rescue, the exact path), its dense Farneback path (in every warp mode),
its Shi-Tomasi + forward-backward LK tracker, its pathfinder app, its
ego-motion (tracker -> keyframe windows -> BA), its tracker app, its
dense viewer, its batch runner (four streams, one stream-batched step
per frame index) and its multi-rank layer (worlds of ranks on the one
GPU) once on one GPU.

Run from the repository root, on a machine with one CUDA GPU and the CUDA
toolkit (nvcc under $CUDA_HOME or /usr/local/cuda):

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
1. device check: a CUDA device is required, there is no CPU path;
2. kernel build: csrc/lk_level.cu, csrc/warp_bilinear.cu,
   csrc/patch_bilinear.cu, csrc/gather_rects.cu and csrc/grid_templates.cu
   -> build/torch_kernels/ (one nvcc each, started together, sm_90a); for
   each instantiation of lk_level, patch_bilinear and grid_templates, its
   registers per thread (checked against
   the ptxas report beside the library) and resident blocks and warps per
   SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor);
3. lk_level kernel vs its plain PyTorch version at L2, L1 and L0 of the
   production params on one 1080p pair: status and top-lefts identical
   (both sum exactly, so any difference is a fault), the kernel launched
   at every level, and its device time per level (graph replay);
3b. grid_templates kernel vs its plain version at L2, L1 and L0 of the
   production params (2304 points, window 45) on one 1080p frame, on two
   streams and on the planes of one stack: identical; per level its device
   time and the plain version's (graph replay) beside its bound (planes
   and templates) and the templates' bound alone;
4. sparse main path: lk_grid_flow_video over a 49-frame 1080p clip (48
   pairs) and lk_grid_flow over one pair (grid_templates 3 times a pair);
   finite fields, median endpoint
   error against the known flow < 0.1 px on status-true points, >= 95%
   status true, `good` agreeing with the plain path on >= 99% of points;
5. sparse times: steady-state fps of the 48-pair scan through the kernel
   and of a few pairs through the plain version; the kernel's time per
   level;
6. warp_bilinear kernel (gather geometry) vs its plain version on the
   (5, Hk, Wk) coefficient pyramids of one 720p pair at all 4 level sizes,
   sampled at the flow of one Farneback iteration (and at the coarsest
   and finest sizes at a spread field whose samples clamp to the plane),
   on the float32 and the bf16 source, and on a ragged (20, 200) plane and
   a stream axis of 4: identical over every pixel (both round every
   product and sum alike); per level, the device time (CUDA events
   around a replayed CUDA graph of many launches) beside its bound and
   the launch floor (launch_floor_ms, measured once before this phase),
   the share of the bound and of max(bound, floor), the launch it made,
   and every launch the kernel takes (launch_shapes) checked identical
   and timed beside launch_shape's pick;
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
    phase 5's scan fps;
16. ego-motion (nav/odometry.py): collect_tracks over the 49-frame clip at
    TrackerParams(), 6 lk_level and 8 patch_bilinear launches a step, its
    table identical to phase 10's track_video history; ego_motion_track at
    OdometryConfig() on it (keyframes, windows, BA cost; the zoom clip is a
    plane, so its direction is printed, not held); on scene_table()'s 3D
    scene (256 slots, 49 frames), by three routes (the default: keyframes
    on the GPU, windows on the host; geometry_device="cuda"; all on the
    CPU): forward flight, the BA chain's ATE within 1% of the trajectory's
    span, and each route against the CPU route (identical keyframes,
    centres within 1e-3 of the span); tracking fps, each route's geometry
    ms and syncs per clip;
17. the tracker app (apps/tracker_app.py) with the pose on, over 48 frames
    through ClipReader: both kernels at every level of every step, the
    final tracks and heads equal to track_video's, a checkpointed run and
    its resume equal to the full run (poses included), its fps (best of 3)
    beside phase 11's tracker scan, and its syncs per frame;
18. warp_bilinear's slab geometry (warp_mode "pallas", and "pallas_bf16"
    on a bf16 source) against its plain version at the 4 720p level sizes
    (the flow of one iteration), on an out-of-margin field whose samples
    clamp (90x160 and 720x1280), and on phase 6's ragged plane and stream
    axis: identical; each variant's device time per level beside its
    bound and phase 6's launch floor (shares as phase 6), F.grid_sample's
    time, the launch, and every launch the kernel takes, as phase 6;
19. the other warp modes over the 24-pair 720p clip: farneback_flow_video
    in "packed", "pallas" and "pallas_bf16", farneback_flow pair by pair
    in "image" and "hybrid": finite, median EPE < TOL_DENSE_EPE_PX,
    warp_bilinear 12 times a pair in the coefficient modes (4 in
    "hybrid", none in "image"), the first 2 pairs equal to the plain path
    where the kernel runs; each mode's fps and the exact scan's, timed in
    turns;
20. the dense viewer (apps/dense_viewer.py) at its defaults over the
    clip's first DENSE_VIEWER_PAIRS pairs through ClipReader, headless,
    with the dense, HSV and contour layers on: each pair's flow equal to farneback_flow's and
    its sparse result to lk_grid_flow's, frames and contours drawn; the
    app's fps beside the scans';
21. the batch runner (apps/batch_runner.py) at the production params on
    four 1080p zoom streams (seeds 0-3, zoom 1.003-1.006 per frame, 49,
    41, 33 and 25 frames: 144 pairs, three streams ending early) read
    through ClipReader: run_batch's per-stream danger counts equal to each
    stream's own lk_grid_flow_video `good` sums, the ended streams masked,
    lk_level 3 times a step whatever the number of streams; a checkpointed
    run and its resume equal to the full run; run_batch_staged's counts
    equal; at LKParams() (the exact path) over 8 steps, patch_bilinear 4
    and lk_level 3 times a step and the counts each stream's exact scan's;
    lk_level at each production level and patch_bilinear at the exact
    path's template shapes with a stream axis of 4, identical to their
    plain versions, and at B = 1 to the unbatched call, with their device
    times at B = 1 and 4 beside the bound; aggregate pairs/s of both runs
    beside phase 5's single-stream scan, kernel launches and syncs per
    step; entry() once at 720p, finite;
22. the multi-rank layer (parallel/) with four gloo ranks sharing cuda:0
    (parallel/mesh.py::run_on_mesh; every collective staged through
    pinned host memory): (a) tiled_farneback_multi of two 720p zoom
    streams on a (2, 2) mesh, 360-row tiles and derive_halo's 142 rows,
    in "exact" and "pallas", within TOL_TILE_EPE_PX of each stream's
    single-rank farneback over the core rows (bit-identity printed); (b)
    stream_batched_grid_flow of four 1080p zoom streams, one a rank, at
    the production and the exact LKParams, identical to each stream's
    lk_grid_flow; (c) distributed_bundle_adjust (256 landmarks, 64 a rank)
    and ring_bundle_adjust (4 keyframes, one a rank) on the first window
    of scene_table()'s 3D scene, within tests/test_pose_ba.py's bounds of
    bundle_adjust, the poses identical on every rank; (d)
    halo_exchange_rows of a 1080p frame in every mode equal to the padded
    frame's rows, the q99 psum-histogram quantile equal on a stream's
    ranks; (e) run_batch(n_devices=4) on phase 21's streams, counts equal
    to phase 21's; (f) dryrun_multichip(4, backend="gloo"). Each step's
    wall time beside the single-rank time of the same work in this call
    (four ranks on one GPU: overhead, not scaling), the halo bytes per
    exchange and each step's kernel launches;
23. a world of one NCCL rank (every collective a real NCCL call, the
    halo ring a self-permutation): 22's (a)-(c) on 1 x 1 and (1,) meshes,
    the grid flow and the distributed BA identical to the single-device
    functions, the tiled flow and the ring BA within 22's bounds;
24. the captured steps (utils/graphs.py: each step of a path one CUDA
    graph, captured at its first call and replayed): for the sparse scan,
    the pathfinder app's run_batched and compute_frame, the batch
    runner, the dense scan in every coefficient mode, "image" and
    "hybrid" pair by pair, the dense viewer's flows, the tracker scan,
    the tracker app and collect_tracks, the replayed run identical to the
    eager one (every step's __wrapped__) over the whole clip, and again
    with every replay under torch.cuda.set_sync_debug_mode("error"); each
    form's fps (in turns), host launches and syncs a pair or step, and the
    graph pool's bytes.

Phases 4-21 drive the paths as a user does, through their graphs: a
path's counted run starts with every graph dropped, so its kernels'
wrappers count the launches that the warm-ups and captures make
(`launches`), and the kernels' executions on the device add each graph
replay's recorded launches (`executions`); the checks hold the replays
to the launches a pair or step needs. A comparison with the plain
versions runs the eager form (chip_smoke.eager) with the plain versions
patched in.

Each kernel's record carries its device time per shape of the main paths
(shape_ms, graph replay; with shape_bound_ms and, for patch_bilinear,
shape_library_ms) and, for lk_level, patch_bilinear and grid_templates, the registers and
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
the flow of every pixel is known exactly. The ego-motion geometry also
runs on scene_table(), a track table of random 3D landmarks seen by a
camera in forward flight, whose trajectory is known.

Before the last line come the GPU's name and power limit (nvidia-smi) and
the kernels' JSON record; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import subprocess
import sys
import time
from typing import NamedTuple
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


def make_clip(device, h: int = H, w: int = W, n: int = N_FRAMES, cell: int = 6, seed: int = SEED,
              zoom: float = ZOOM) -> torch.Tensor:
    """(n, h, w) uint8: frame t is the texture (lattice spacing `cell` px,
    drawn from `seed`) zoomed by zoom**t about the centre (content expands
    outwards, as in forward flight)."""
    gen = torch.Generator().manual_seed(seed)
    lat = smooth_texture(gen, device, h, w, cell)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=device),
        torch.arange(w, dtype=torch.float64, device=device),
        indexing="ij",
    )
    frames = []
    for t in range(n):
        s = zoom**t
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


def _np_rotation(w: np.ndarray) -> np.ndarray:
    """Rodrigues in float64: so(3) vector -> rotation matrix."""
    theta = float(np.linalg.norm(w))
    if theta < 1e-12:
        return np.eye(3)
    k = w / theta
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]])
    return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def scene_table(seed: int = SEED, n_frames: int = N_FRAMES, slots: int = 256, h: int = H, w: int = W,
                fov: float = 155.0, noise_px: float = 0.2):
    """A track table of a camera flying forward through random 3D
    landmarks, as collect_tracks returns it: (pos (F, T, 2) float32,
    alive (F, T) bool, birth (F, T) int64), and the camera centres (F, 3).
    The camera moves about 0.25 units a frame along its optical axis with
    a little sideways drift and a slow rotation; each slot holds one
    landmark, seen with Gaussian pixel noise while it is in front of the
    camera and inside the frame. A slot whose landmark leaves the view is
    dead for that frame and takes a new landmark ahead of the camera at
    the next, born there."""
    rng = np.random.RandomState(seed)
    f = (w / 2.0) / np.tan(np.radians(fov) / 2.0)
    steps = rng.normal([0.0, 0.0, 0.25], [0.02, 0.02, 0.02], (n_frames - 1, 3))
    centers = np.concatenate([np.zeros((1, 3)), np.cumsum(steps, 0)])
    angs = np.cumsum(rng.normal(0.0, 0.004, (n_frames, 3)), 0)
    angs[0] = 0.0
    rots = np.stack([_np_rotation(a) for a in angs])  # world -> camera

    def spawn(k: int, n: int) -> np.ndarray:
        z = rng.uniform(3.0, 25.0, n)
        xc = np.stack([z * rng.uniform(-0.9, 0.9, n) * (w / 2.0) / f,
                       z * rng.uniform(-0.9, 0.9, n) * (h / 2.0) / f, z], -1)
        return xc @ rots[k] + centers[k]

    pts = spawn(0, slots)
    pos = np.zeros((n_frames, slots, 2), np.float32)
    alive = np.zeros((n_frames, slots), bool)
    birth = np.zeros((n_frames, slots), np.int64)
    born = np.zeros(slots, np.int64)
    dead = np.zeros(slots, bool)
    for k in range(n_frames):
        if dead.any():
            pts[dead] = spawn(k, int(dead.sum()))
            born[dead] = k
        pc = (pts - centers[k]) @ rots[k].T
        z = np.maximum(pc[:, 2], 1e-6)
        uv = np.stack([f * pc[:, 0] / z + w / 2.0, f * pc[:, 1] / z + h / 2.0], -1)
        uv += rng.normal(0.0, noise_px, uv.shape)
        seen = (pc[:, 2] > 0.5) & (uv[:, 0] >= 0) & (uv[:, 0] < w) & (uv[:, 1] >= 0) & (uv[:, 1] < h)
        pos[k] = uv
        alive[k] = seen
        birth[k] = born
        dead = ~seen
    return (pos, alive, birth), centers


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


FLOOR_REPLAYS = 5  # graph replays of launch_floor_ms, the least taken


def launch_floor_ms(dev) -> float:
    """The least time a kernel launch takes on the card: the least of
    FLOOR_REPLAYS graph_ms readings of a one-element in-place add."""
    one = torch.zeros(1, device=dev)
    return min(graph_ms(lambda: one.add_(1.0), 50) for _ in range(FLOOR_REPLAYS))


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


# the modules whose steps run as captured graphs (utils/graphs.py)
GRAPH_MODULES = (
    "hackathonopticalflow_tpu_torch.flow.lk_grid",
    "hackathonopticalflow_tpu_torch.flow.dense",
    "hackathonopticalflow_tpu_torch.flow.tracker",
    "hackathonopticalflow_tpu_torch.apps.batch_runner",
    "hackathonopticalflow_tpu_torch.apps.pathfinder",
)


@contextlib.contextmanager
def eager(*objs):
    """Inside, every captured step of GRAPH_MODULES, and every graphed
    attribute of objs (an app's chunk), runs as its __wrapped__: the
    eager form, one launch per op, which the checks hold the graphs to and
    which runs the kernels' plain versions where they are patched in."""
    from hackathonopticalflow_tpu_torch.utils.graphs import Graphed

    with contextlib.ExitStack() as stack:
        for target in [importlib.import_module(m) for m in GRAPH_MODULES] + list(objs):
            for name, value in list(vars(target).items()):
                if isinstance(value, Graphed):
                    stack.enter_context(mock.patch.object(target, name, value.__wrapped__))
        yield


@contextlib.contextmanager
def strict_replays():
    """Inside, every call of a graphed function (its input copies, replay
    and output copies) runs under torch.cuda.set_sync_debug_mode("error"):
    a host sync there raises. For runs whose graphs are captured already."""
    from hackathonopticalflow_tpu_torch.utils.graphs import Graphed

    call = Graphed.__call__

    def strict(self, *args, **kwargs):
        before = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return call(self, *args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(before)

    with mock.patch.object(Graphed, "__call__", strict):
        yield


class Runs(NamedTuple):
    """A run's kernel counts by kernel name. launched: what the kernels'
    wrappers counted (eager calls, and launches recorded into a graph by
    its capture); ran: the kernels' executions on the device (eager
    launches, and the launches that graph replays ran); replayed: the part
    of ran that replays ran."""

    launched: dict
    ran: dict
    replayed: dict


def counted(fn):
    """(fn(), Runs): fn runs with every captured graph dropped first, so
    that it captures the graphs it replays and its wrappers count the
    kernels' launches, and with every count at 0."""
    from hackathonopticalflow_tpu_torch.utils import graphs

    graphs.clear_caches()
    torch.cuda.empty_cache()
    _zero_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, Runs(_wrapper_counts(), _launch_counts(), graphs.launch_stats()["replayed"])


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
    from hackathonopticalflow_tpu_torch.ops.grid_templates import grid_templates_reference
    from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level, lk_level_reference

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
    (res, one), cnt = counted(lambda: (lk_grid.lk_grid_flow_video(clip, pts, lk=params, device=dev),
                                        lk_grid.lk_grid_flow(clip[0], clip[1], pts, lk=params, device=dev)))
    main_launches = cnt.launched["lk_level"]
    log(f"sparse main path: lk_level launches {main_launches} (warm-ups and captures), executions "
        f"{cnt.ran['lk_level']} of which graph replays {cnt.replayed.get('lk_level', 0)} ({3 * N_FRAMES} "
        f"expected: 3 a pair, the scan's 48 and the pair's one), warp_bilinear launches "
        f"{cnt.launched['warp_bilinear']}, patch_bilinear launches {cnt.launched['patch_bilinear']}, "
        f"grid_templates executions by graph replays {cnt.replayed.get('grid_templates', 0)} "
        f"({3 * N_FRAMES} expected)")
    if main_launches < 3 or cnt.replayed.get("lk_level", 0) != 3 * N_FRAMES:
        raise SystemExit("the sparse main path did not run the lk_level kernel at every level")
    if cnt.replayed.get("grid_templates", 0) != 3 * N_FRAMES:
        raise SystemExit("the sparse main path did not cut its templates with the grid_templates kernel")
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

    with eager(), mock.patch.object(lk_mod, "lk_level", lk_level_reference), \
            mock.patch.object(lk_mod, "grid_templates", grid_templates_reference):
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
    with eager(), mock.patch.object(lk_mod, "lk_level", lk_level_reference), \
            mock.patch.object(lk_mod, "grid_templates", grid_templates_reference):
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
            "executions_by_path": {"sparse": cnt.ran["lk_level"]},
            "max_abs_err": max_err,
            "ms": sum(level_ms.values()),
            "plain_ms": sum(level_plain_ms.values()),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": None,
            "shape_ms": {f"production L{lv}": v for lv, v in level_ms.items()},
            "shape_bound_ms": {f"production L{lv}": v for lv, v in level_bound_ms.items()},
        },
        "grid_templates_runs": cnt,
        "scan_fps": fps,
        "plain_scan_fps": plain_fps,
        "median_epe_px": med_epe,
    }


GRID_TEMPLATE_STREAMS = 2  # phase 3b's stream axis


def grid_templates_phase(dev, clip) -> dict:
    """Phase 3b: the grid template kernel against its plain version at the
    pathfinder's three levels (2304 points, window 45) on the zoom clip's
    frame 1, with B = 1, with a stream axis of GRID_TEMPLATE_STREAMS (frames
    1 and 2) and on the planes of one (B, 3, Hp, Wp) stack: identical; per
    level the device time (graph replay), kernel / plain, beside two bounds:
    every byte (the three planes read once, the templates written once) and
    the templates alone, as the benchmark's grid_templates.roofline counts
    them (the planes are written just before and may be in L2)."""
    from hackathonopticalflow_tpu_torch.core import LKParams, measurement_grid
    from hackathonopticalflow_tpu_torch.ops import lk as lk_mod
    from hackathonopticalflow_tpu_torch.ops.grid_templates import grid_templates, grid_templates_reference

    params = LKParams(grid_step=30, compute_err=False)
    win_w, win_h = params.win_size
    pad = lk_mod._frame_pad(params)
    pts_np = measurement_grid(H, W, params.grid_step)
    xs, ys = lk_mod._grid_axes(H, W, params.grid_step)
    one = lk_mod.prepare_frame(clip[1], params)
    many = lk_mod.prepare_frame(clip[1 : 1 + GRID_TEMPLATE_STREAMS], params)
    out = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "out_bound_ms": 0.0,
           "shape_ms": {}, "shape_plain_ms": {}, "shape_bound_ms": {}, "shape_out_bound_ms": {}}
    for level in range(params.max_level, -1, -1):
        calls = {
            f"L{level}": [p[level] for p in one],
            f"L{level} B={GRID_TEMPLATE_STREAMS}": [p[level] for p in many],
            f"L{level} B={GRID_TEMPLATE_STREAMS} stack": list(torch.stack([p[level] for p in many], 1).unbind(1)),
        }
        for key, planes in calls.items():
            grid_templates.launches = 0
            got = grid_templates(*planes, xs, ys, level, win_w, win_h, pad)
            torch.cuda.synchronize()
            launches = grid_templates.launches
            want = grid_templates_reference(*planes, xs, ys, level, win_w, win_h, pad)
            nb = planes[0].shape[0] if planes[0].dim() == 3 else 1
            if launches != 1 or got.shape != (nb * pts_np.shape[0], 3, win_h, win_w) or not torch.equal(got, want):
                raise SystemExit(f"grid_templates {key}: kernel disagrees with the plain version")
            if key.endswith("stack"):
                log(f"grid_templates {key} {tuple(got.shape)}: identical")
                continue
            k_ms = graph_ms(lambda: grid_templates(*planes, xs, ys, level, win_w, win_h, pad), 20)
            p_ms = graph_ms(lambda: grid_templates_reference(*planes, xs, ys, level, win_w, win_h, pad), 3)
            out_bytes = got.numel() * 4
            all_bound, by = bound(3 * planes[0].numel() * 4 + out_bytes, 11.0 * got.numel())
            out_bound, _ = bound(out_bytes)
            out["shape_ms"][key], out["shape_plain_ms"][key] = k_ms, p_ms
            out["shape_bound_ms"][key], out["shape_out_bound_ms"][key] = all_bound, out_bound
            if nb == 1:
                out["ms"] += k_ms
                out["plain_ms"] += p_ms
                out["bound_ms"] += all_bound
                out["out_bound_ms"] += out_bound
            log(f"grid_templates {key} {tuple(got.shape)}: identical, device time (graph replay) {k_ms:.4f} ms, "
                f"plain {p_ms:.4f} ms, bound {all_bound:.4f} ms ({by}: planes and templates), templates alone "
                f"{out_bound:.4f} ms ({100.0 * out_bound / k_ms:.1f}% of it)")
    log(f"grid_templates over the 3 levels (device ms, kernel / plain / bound / templates' bound): "
        f"{out['ms']:.4f} / {out['plain_ms']:.4f} / {out['bound_ms']:.4f} / {out['out_bound_ms']:.4f}")
    return {
        "name": "grid_templates",
        "route": "cuda",
        "source": "hackathonopticalflow_tpu_torch/csrc/grid_templates.cu",
        "replaces": "none: hackathonopticalflow_tpu/ops/grid_patch.py::extract_grid_templates_lanes (XLA)",
        "launches_by_path": {},
        "executions_by_path": {},
        "library_ms": None,
        **out,
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


def _spread_field(xs, ys, amp: float):
    """Absolute coordinates displaced by a smooth field of amplitude amp px
    (phase 18's SLAB_SPREAD_PX: samples past the TPU slab's margins, and
    past the plane's borders)."""
    h, w = ys.shape[-2], xs.shape[-1]
    return ((xs + amp * torch.sin(ys / 3.0 + xs / 17.0)).expand(h, w).contiguous(),
            (ys + amp * torch.cos(xs / 5.0)).expand(h, w).contiguous())


def warp_case(src, fx, fy, geometry: str, label: str) -> float:
    """One warp_bilinear launch against its plain version: identical, or
    the run fails; returns max |d| (0)."""
    from hackathonopticalflow_tpu_torch.ops.warp_bilinear import warp_bilinear, warp_bilinear_reference

    warp_bilinear.launches = 0
    out_k = warp_bilinear(src, fx, fy, geometry)
    torch.cuda.synchronize()
    launches = warp_bilinear.launches
    out_p = warp_bilinear_reference(src, fx, fy, geometry)
    err = float((out_k - out_p).abs().max())
    if launches != 1 or not torch.equal(out_k, out_p):
        raise SystemExit(f"warp {geometry} {label}: kernel disagrees with the plain version (max |d| {err:.3g}, "
                         f"launches {launches})")
    return err


def warp_edge_cases(dev, geometry: str) -> float:
    """warp_bilinear in `geometry` against its plain version where the
    720p path's level sizes do not reach: a ragged (20, 200) plane, whose
    tiles run past the image, and a stream axis of 4 at 90x160; on the
    float32 and bf16 source, with fields inside the slab's margins (3 px)
    and spread past them (SLAB_SPREAD_PX). Returns max |d| (0)."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    n, err = 0, 0.0
    for b, h, w in ((1, 20, 200), (4, 90, 160)):
        src = torch.randn((b, 5, h, w), generator=g, device=dev) * 100
        xs = torch.arange(w, dtype=torch.float32, device=dev)
        ys = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
        for amp in (3.0, SLAB_SPREAD_PX):
            fx, fy = (f + 4.0 * torch.rand((b, h, w), generator=g, device=dev) - 2.0 for f in _spread_field(xs, ys, amp))
            for dtype in (torch.float32, torch.bfloat16):
                label = f"{b}x5x{h}x{w} amp {amp:g} {str(dtype)[6:]}"
                err = max(err, warp_case(src.to(dtype), fx.contiguous(), fy.contiguous(), geometry, label))
                n += 1
    log(f"warp {geometry} edge cases (ragged 20x200, a stream axis of 4 at 90x160; f32 and bf16 source; "
        f"fields of 3 and {SLAB_SPREAD_PX:g} px): {n} launches identical to the plain version")
    return err


def warp_level_line(kind: str, key: str, ms: float, plain_ms: float, lib_ms: float, bound_ms: float,
                    bound_by: str, floor_ms: float) -> str:
    """A level's times beside its bound and the launch floor: the share of
    the bound, and of max(bound, floor), the least time the card could
    take for the work in one launch; and the launch warp_bilinear made
    last."""
    from hackathonopticalflow_tpu_torch.ops.warp_bilinear import warp_bilinear

    shape = warp_bilinear.last_launch
    return (f"{kind} {key}: device time (graph replay) warp_bilinear {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"F.grid_sample {lib_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), launch floor {floor_ms:.4f} ms; "
            f"share of bound {bound_ms / ms:.3f}, of max(bound, floor) {max(bound_ms, floor_ms) / ms:.3f}; "
            f"launch {shape.grid} blocks (groups {shape.groups}, splits {shape.splits})")


def warp_launch_ranking(kind: str, key: str, src, fx, fy, geometry: str) -> None:
    """Every launch the kernel takes for this call (launch_shapes) against
    the plain version (identical, or the run fails), then timed by graph
    replay, the least of two rounds taken in turns; logs them fastest
    first beside launch_shape's pick. These launches are not counted."""
    from hackathonopticalflow_tpu_torch.ops.warp_bilinear import (
        _launch,
        launch_shape,
        launch_shapes,
        warp_bilinear_reference,
    )

    c, h, w = src.shape[-3:]
    ref = warp_bilinear_reference(src, fx, fy, geometry)
    out = torch.empty_like(ref)
    shapes = launch_shapes(1, c, h, w, geometry)
    for s in shapes:
        out.fill_(float("nan"))
        _launch(src, fx, fy, out, geometry, s)
        if not torch.equal(out, ref):
            raise SystemExit(f"{kind} {key} launch {tuple(s)}: the kernel disagrees with the plain version")
    best = dict.fromkeys(shapes, float("inf"))
    for _ in range(2):
        for s in shapes:
            best[s] = min(best[s], graph_ms(lambda s=s: _launch(src, fx, fy, out, geometry, s), 50))
    order = sorted(shapes, key=best.get)
    pick = launch_shape(1, c, h, w, geometry)
    log(f"{kind} {key} launches (grid/groups/splits ms, fastest first; {len(shapes)} identical to the plain version; "
        f"launch_shape's pick {pick.grid}/{pick.groups}/{pick.splits} ranks {order.index(pick) + 1}): "
        + ", ".join(f"{s.grid}/{s.groups}/{s.splits} {best[s]:.4f}" for s in order))


def dense_phases(dev, clip, floor_ms: float) -> dict:
    """Phases 6-8: the dense Farneback path through warp_bilinear;
    floor_ms is launch_floor_ms."""
    from hackathonopticalflow_tpu_torch.core import FarnebackParams
    from hackathonopticalflow_tpu_torch.flow import dense
    fb = importlib.import_module("hackathonopticalflow_tpu_torch.ops.farneback")
    from hackathonopticalflow_tpu_torch.ops.warp_bilinear import warp_bilinear, warp_bilinear_reference

    params = FarnebackParams()
    pairs = DENSE_FRAMES - 1
    log(f"dense clip: {tuple(clip.shape)} uint8, lattice {DENSE_CELL} px, zoom {ZOOM}/frame, {params}")

    # ---- 6. kernel vs plain at the 4 level sizes of one pair ----
    rs0 = fb.prepare_frame(clip[0], params)
    rs1 = fb.prepare_frame(clip[1], params)
    max_err = warp_edge_cases(dev, "gather")
    level_ms, level_plain_ms, level_lib_ms, level_bound_ms = {}, {}, {}, {}
    n_bytes = f32_ops = 0.0
    for r0, r1 in zip(rs0, rs1):
        hk, wk = r0.shape[-2:]
        zero = torch.zeros((hk, wk, 2), dtype=torch.float32, device=dev)
        flow = fb._solve_flow(fb.update_matrices(r0, r1, zero), params)
        xs, ys = fb._pixel_coords(hk, wk, dev)
        fx = (xs + flow[..., 0]).contiguous()
        fy = (ys + flow[..., 1]).contiguous()
        key = f"{hk}x{wk}"
        # the flow of one iteration on the float32 source (the path's) and
        # the bf16 one; at the coarsest and finest sizes also a spread field
        fields = [("flow", fx, fy)] + ([("spread", *_spread_field(xs, ys, SLAB_SPREAD_PX))]
                                        if hk in (90, DENSE_H) else [])
        for field, gx, gy in fields:
            for src in (r1, r1.to(torch.bfloat16)):
                max_err = max(max_err, warp_case(src, gx, gy, "gather", f"{key} {field} {src.dtype}"))
        log(f"warp {key}: flow max |f| {float(flow.abs().max()):.3f} px; {2 * len(fields)} launches "
            f"({', '.join(f for f, _, _ in fields)}; float32 and bf16 source) identical to the plain version")
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
        level_bound_ms[key], lv_by = bound(lv_bytes, lv_ops)
        log(warp_level_line("warp", key, level_ms[key], level_plain_ms[key], level_lib_ms[key], level_bound_ms[key],
                            lv_by, floor_ms)
            + f"; eager call to call {call_ms:.4f} ms, plain {call_plain_ms:.4f} ms")
        warp_launch_ranking("warp", key, r1, fx, fy, "gather")

    # ---- 7. main path ----
    (flows, one), cnt = counted(lambda: (dense.farneback_flow_video(clip, params, device=dev),
                                          dense.farneback_flow(clip[0], clip[1], params, device=dev)))
    main_launches = cnt.launched["warp_bilinear"]
    per_pair = params.iterations * (params.levels + 1)
    log(f"dense main path: warp_bilinear launches {main_launches} (warm-ups and captures), executions "
        f"{cnt.ran['warp_bilinear']} of which graph replays {cnt.replayed.get('warp_bilinear', 0)} "
        f"({per_pair} per pair expected), lk_level launches {cnt.launched['lk_level']}, "
        f"patch_bilinear launches {cnt.launched['patch_bilinear']}")
    if main_launches < per_pair or cnt.replayed.get("warp_bilinear", 0) != per_pair * (pairs + 1):
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
    with eager(), mock.patch.object(fb, "warp_bilinear", warp_bilinear_reference):
        plain = dense.farneback_flow_video(plain_clip, params, device=dev)
    same = bool(torch.equal(plain, flows[:DENSE_PLAIN_PAIRS]))
    log(f"plain path ({DENSE_PLAIN_PAIRS} pairs): identical to the kernel path {same}, "
        f"max |d| {float((plain - flows[:DENSE_PLAIN_PAIRS]).abs().max()):.3g} px")
    if not same:
        raise SystemExit("the dense kernel path disagrees with the plain path")

    # ---- 8. times ----
    scan_s = min(host_seconds(lambda: dense.farneback_flow_video(clip, params, device=dev)) for _ in range(3))
    with eager(), mock.patch.object(fb, "warp_bilinear", warp_bilinear_reference):
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
            "executions_by_path": {"dense": cnt.ran["warp_bilinear"]},
            "max_abs_err": max_err,
            "ms": sum(level_ms.values()),
            "plain_ms": sum(level_plain_ms.values()),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": sum(level_lib_ms.values()),
            "launch_floor_ms": floor_ms,
            "shape_ms": level_ms,
            "shape_bound_ms": level_bound_ms,
            "shape_library_ms": level_lib_ms,
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
    s0 = tracker.track_step(tracker.init_tracker(params, dev), clip[0], clip[0], params, device=dev)
    (state, (heads, alive, length)), cnt = counted(lambda: tracker.track_video(clip, params, s0, device=dev))
    lk_n, pb_n = cnt.launched["lk_level"], cnt.launched["patch_bilinear"]
    lk_r, pb_r = cnt.replayed.get("lk_level", 0), cnt.replayed.get("patch_bilinear", 0)
    log(f"tracker main path ({steps} steps, a graph with detection and one without): lk_level launches {lk_n}, "
        f"patch_bilinear launches {pb_n} (warm-ups and captures); executions by graph replays: lk_level {lk_r} "
        f"({6 * steps} expected), patch_bilinear {pb_r} ({8 * steps} expected); warp_bilinear launches "
        f"{cnt.launched['warp_bilinear']}")
    if lk_r != 6 * steps or pb_r != 8 * steps or lk_n != 2 * 2 * 6 or pb_n != 2 * 2 * 8:
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
        (got, got_hist), short_runs = counted(lambda: tracker.track_video(short, p, s0, device=dev))
        n_lk, n_pb = short_runs.replayed.get("lk_level", 0), short_runs.replayed.get("patch_bilinear", 0)
        with eager(), mock.patch.object(lk_mod, "lk_level", lk_level_reference), \
                mock.patch.object(patch_mod, "patch_bilinear", patch_bilinear_reference):
            want_state, want_hist = tracker.track_video(short, p, s0, device=dev)
        same = all(torch.equal(getattr(got, f), getattr(want_state, f)) for f in ("traj", "length", "alive"))
        same = same and all(torch.equal(a, b) for a, b in zip(got_hist, want_hist))
        log(f"tracker {geometry}: first {TRACKER_PLAIN_STEPS} steps identical to the plain path {same} "
            f"(lk_level {n_lk}, patch_bilinear {n_pb} executions by graph replays), live {int(got.alive.sum())}")
        if not same or n_lk != 6 * TRACKER_PLAIN_STEPS or n_pb != 8 * TRACKER_PLAIN_STEPS:
            raise SystemExit(f"the tracker's kernel path ({geometry}) disagrees with the plain path")

    # ---- 11. times ----
    track_s = min(host_seconds(lambda: tracker.track_video(clip, params, s0, device=dev)) for _ in range(3))
    with eager(), mock.patch.object(lk_mod, "lk_level", lk_level_reference), \
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
            "executions_by_path": {"tracker": cnt.ran["patch_bilinear"]},
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
            "executions": cnt.ran["lk_level"],
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
        "history": (s0, heads, alive, length),  # phase 16 holds collect_tracks to it
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
    from hackathonopticalflow_tpu_torch.ops import grid_templates as grid_mod
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
        bx, _ = grid_mod._axis_bases(xs, level, (win_w - 1) * 0.5 + mx)
        by, _ = grid_mod._axis_bases(ys, level, (win_h - 1) * 0.5 + my)
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
    from hackathonopticalflow_tpu_torch.ops.grid_templates import grid_templates_reference
    from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level_reference
    from hackathonopticalflow_tpu_torch.ops.patch_bilinear import patch_bilinear_reference

    pts = torch.from_numpy(measurement_grid(H, W, 30)).to(dev)
    out = {"lk_level_launches": {}, "patch_bilinear_launches": {}, "lk_level_executions": {},
           "patch_bilinear_executions": {}}
    runs = {"blocked": N_FRAMES, "exact": N_FRAMES, "no_rescue": PLAIN_PAIRS + 1,
            "rescue_levels_1": PLAIN_PAIRS + 1}
    for config, params in new_lk_configs().items():
        frames = clip[: runs[config]]
        pairs = frames.shape[0] - 1
        res, cnt = counted(lambda: lk_grid.lk_grid_flow_video(frames, pts, lk=params, device=dev))
        for k in ("lk_level", "patch_bilinear"):
            out[f"{k}_launches"][config] = cnt.launched[k]
            out[f"{k}_executions"][config] = cnt.ran[k]
        log(f"{config} scan ({pairs} pairs): lk_level launches {cnt.launched['lk_level']}, patch_bilinear "
            f"launches {cnt.launched['patch_bilinear']} (warm-up and capture); executions lk_level "
            f"{cnt.ran['lk_level']}, patch_bilinear {cnt.ran['patch_bilinear']}")
        if cnt.replayed.get("lk_level", 0) != 3 * pairs or cnt.launched["lk_level"] < 3:
            raise SystemExit(f"the {config} scan did not run lk_level at every level")
        for name, v in res._asdict().items():
            if v.is_floating_point() and not bool(torch.isfinite(v).all()):
                raise SystemExit(f"{config}: non-finite values in {name}")
        st = res.status
        epe = torch.linalg.vector_norm(res.raw_next_pts.double() - true_backward(pts), dim=-1)
        med_epe = float(epe[st].median())
        st_frac = float(st.double().mean())
        with eager(), mock.patch.object(lk_mod, "lk_level", lk_level_reference), \
                mock.patch.object(lk_mod, "grid_templates", grid_templates_reference), \
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
    stats, cnt = counted(lambda: batched.run_batched(chunk=APP_CHUNK, render=False))
    launches = cnt.launched["lk_level"]
    # 3 a pair, the padded tail chunk's pairs included; the chunk's graph
    # is captured by run_batched's warm-up and replayed once a chunk
    expected = 3 * APP_CHUNK * -(-pairs // APP_CHUNK)
    counts = stats["danger_counts"]
    log(f"app run_batched ({stats['frames']} pairs, chunk {APP_CHUNK}): lk_level launches {launches} (warm-up "
        f"and capture of the chunk's graph), executions by its replays {cnt.replayed.get('lk_level', 0)} "
        f"({expected} expected and the warm-up call's {3 * APP_CHUNK}), warp_bilinear "
        f"{cnt.launched['warp_bilinear']}, patch_bilinear {cnt.launched['patch_bilinear']}; danger counts equal to "
        f"the scan's good sums {counts == want}, mean {stats['mean_danger_points']:.1f} of {pts.shape[0]}")
    # the warm-up's call replays its graph once too
    if (launches != 2 * 3 * APP_CHUNK or cnt.replayed.get("lk_level", 0) != expected + 3 * APP_CHUNK
            or stats["frames"] != pairs or counts != want):
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
    return {"app_fps": fps, "app_launches": launches, "app_executions": cnt.ran["lk_level"]}


GEOMETRY_REPS = 3  # geometry timings, best of


def api_calls(fn) -> tuple[int, dict]:
    """The host's kernel launches and waits on the device during fn(), from
    torch.profiler: (count of the CUDA API's kernel and graph launch calls, counts of its
    synchronize calls by name; a device-to-host copy into pageable memory,
    and a solver's status check, are a stream synchronize each)."""
    import collections

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    names = collections.Counter(e.name for e in prof.events() if e.name.startswith("cuda"))
    launches = sum(v for k, v in names.items() if k.startswith("cudaLaunch") or k == "cudaGraphLaunch")
    return launches, {k: v for k, v in names.items() if "Synchronize" in k}


def sync_calls(fn) -> dict:
    """The host's waits on the device during fn() (api_calls)."""
    return api_calls(fn)[1]


def ego_phase(dev, clip, history) -> dict:
    """Phase 16: ego-motion at 1080p. collect_tracks over the 49-frame clip
    at TrackerParams() (a seeding step, then chunks of 32 steps through
    both kernels), its table identical to phase 10's track_video history;
    ego_motion_track at OdometryConfig() on that table by its default
    route (keyframes on the GPU, windows on the host): >= 4 keyframe
    centres, its direction printed. The zoom clip is one textured plane,
    for which the 8-point estimate has a family of solutions: the JAX
    package's chain on the same table is no closer to forward flight (mean
    |unit-step z| 0.53). So forward flight is held on scene_table()'s 3D
    scene (256 slots, 49 frames, slots reborn as landmarks leave the view)
    by three routes, the default, geometry_device="cuda" (all on the GPU)
    and all on the CPU: for each, mean |unit-step z| > 0.9, the BA chain's
    ATE (Umeyama, with scale) within 1% of the true trajectory's span and
    no worse than the raw chain's, and against the CPU route identical
    keyframes and centres within 1e-3 of the span. Tracking fps, and each
    route's geometry ms (best of GEOMETRY_REPS) and syncs per clip on both
    tables."""
    from hackathonopticalflow_tpu_torch.core import TrackerParams
    from hackathonopticalflow_tpu_torch.flow.tracker import _heads
    from hackathonopticalflow_tpu_torch.nav import odometry as odo
    from hackathonopticalflow_tpu_torch.nav.camera import Pinhole
    from hackathonopticalflow_tpu_torch.nav.metrics import ate_umeyama

    params = TrackerParams()
    n_frames = clip.shape[0]
    s0, heads, alive, length = history
    table, cnt = counted(lambda: odo.collect_tracks(clip, params, device=dev))
    lk_n, pb_n = cnt.ran["lk_level"], cnt.ran["patch_bilinear"]
    got_len = torch.from_numpy(np.arange(n_frames)[:, None] + 1 - table.birth)
    same = (torch.equal(torch.from_numpy(table.pos), torch.cat([_heads(s0)[None], heads]).cpu())
            and torch.equal(torch.from_numpy(table.alive), torch.cat([s0.alive[None], alive]).cpu())
            and torch.equal(got_len, torch.cat([s0.length[None], length]).cpu().to(torch.int64)))
    # a step a frame (the seeding step through track_step_prepared's graph,
    # the rest through track_frame's two), and each capture's warm-up
    n_captures = cnt.launched["lk_level"] // (2 * 6)
    log(f"ego collect_tracks ({n_frames} frames): lk_level launches {cnt.launched['lk_level']}, patch_bilinear "
        f"{cnt.launched['patch_bilinear']} ({n_captures} graphs warmed up and captured); executions lk_level "
        f"{lk_n} ({6 * (n_frames + n_captures)} expected), patch_bilinear {pb_n} "
        f"({8 * (n_frames + n_captures)} expected); heads, alive and lengths identical to phase 10's "
        f"track_video {same}; births past frame 0 {int((table.birth > 0).sum())}")
    if (not same or n_captures != 3 or lk_n != 6 * (n_frames + n_captures)
            or pb_n != 8 * (n_frames + n_captures)):
        raise SystemExit("collect_tracks disagrees with track_video")
    track_s = min(host_seconds(lambda: odo.collect_tracks(clip, params, device=dev)) for _ in range(GEOMETRY_REPS))

    cam = Pinhole.from_fov(W, H, 155.0)
    cfg = odo.OdometryConfig()
    # (device, geometry_device) by route: the default tracks and picks
    # keyframes on the GPU and solves the windows on the host
    routes = {"default": (dev, "cpu"), "gpu": (dev, dev), "cpu": ("cpu", "cpu")}

    def geometry(tab, route):
        device, geometry_device = routes[route]
        return odo.ego_motion_track(None, params, cam, cfg, table=tab, device=device,
                                    geometry_device=geometry_device)

    res = geometry(table, "default")
    steps = np.diff(res.centers, axis=0)
    steps /= np.linalg.norm(steps, axis=-1, keepdims=True) + 1e-12
    forward = float(np.abs(steps[:, 2]).mean())
    cost0 = float(np.median([s["cost0"] for s in res.stats]))
    cost = float(np.median([s["cost"] for s in res.stats]))
    log(f"ego zoom clip: keyframes {res.kf_idx.tolist()}, {len(res.stats)} windows, median BA cost "
        f"{cost0:.4g} -> {cost:.4g}, mean |unit-step z| {forward:.4f} (a planar scene: not held)")
    if len(res.centers) < 4 or not np.isfinite(res.centers).all():
        raise SystemExit("ego-motion on the zoom clip gave no chain")

    scene, truth = scene_table(h=H, w=W)
    stable = odo.TrackTable(*scene)
    runs = {route: geometry(stable, route) for route in routes}
    host = runs["cpu"]
    out = {"ego_keyframes": len(host.kf_idx), "ego_windows": len(host.stats), "ego_centres_vs_cpu_over_span": {},
           "ego_scene_forward": {}, "ego_scene_ate_over_span": {}, "ego_scene_raw_ate_over_span": {}}
    for route, run in runs.items():
        ref = truth[run.kf_idx]
        span = float(np.linalg.norm(ref - ref[0], axis=-1).max())
        same_kf = run.kf_idx.tolist() == host.kf_idx.tolist()
        err = float(np.abs(run.centers - host.centers).max()) / span if same_kf else float("inf")
        steps = np.diff(run.centers, axis=0)
        steps /= np.linalg.norm(steps, axis=-1, keepdims=True) + 1e-12
        scene_forward = float(np.abs(steps[:, 2]).mean())
        ate = ate_umeyama(run.centers, ref)["rmse"] / span
        ate_raw = ate_umeyama(run.raw_centers, ref)["rmse"] / span
        log(f"ego 3D scene ({scene[0].shape[1]} slots, {scene[0].shape[0]} frames), {route} route: keyframes "
            f"{run.kf_idx.tolist()}, {len(run.stats)} windows, median BA cost "
            f"{np.median([s['cost0'] for s in run.stats]):.4g} -> {np.median([s['cost'] for s in run.stats]):.4g}; "
            f"mean |unit-step z| {scene_forward:.4f}; ATE / span: BA {ate:.3g}, raw chain {ate_raw:.3g}; against "
            f"the CPU route: keyframes identical {same_kf}, centres max |d| / span {err:.3g}")
        if len(run.centers) < 4 or not scene_forward > 0.9 or not ate <= min(0.01, ate_raw):
            raise SystemExit(f"ego-motion on the 3D scene ({route} route) is not its forward flight")
        if not err <= 1e-3:
            raise SystemExit(f"the ego-motion geometry's {route} route disagrees with the CPU route")
        out["ego_centres_vs_cpu_over_span"][route] = err
        out["ego_scene_forward"][route] = scene_forward
        out["ego_scene_ate_over_span"][route] = ate
        out["ego_scene_raw_ate_over_span"][route] = ate_raw
    times, syncs = {}, {}
    for name, tab in (("scene", stable), ("zoom", table)):
        for route in routes:
            key = f"{name} {route}"
            times[key] = min(host_seconds(lambda: geometry(tab, route)) for _ in range(GEOMETRY_REPS)) * 1e3
            syncs[key] = sum(sync_calls(lambda: geometry(tab, route)).values())
    log(f"ego tracking {n_frames - 1} steps {H}p (collect_tracks): {(n_frames - 1) / track_s:.2f} fps "
        f"({track_s * 1e3:.1f} ms, best of {GEOMETRY_REPS})")
    log("ego geometry (ms, host clock, best of %d; CPU on %d threads): " % (GEOMETRY_REPS, torch.get_num_threads())
        + ", ".join(f"{k} {v:.1f}" for k, v in times.items()) + "; syncs per clip: "
        + ", ".join(f"{k} {v}" for k, v in syncs.items()))
    return {
        "odometry_launches": cnt,
        "ego_tracking_fps": (n_frames - 1) / track_s,
        "ego_geometry_ms": times,
        "ego_geometry_syncs": syncs,
        **out,
        "ego_zoom_forward": forward,
    }


def tracker_app_phase(dev, clip, tracker_fps: float) -> dict:
    """Phase 17: the tracker app (apps/tracker_app.py) at TrackerParams()
    with the pose on, over the clip's first 48 frames read from host memory
    (ClipReader): both kernels at every level of every step; the final
    tracks and heads equal to track_video's on the same frames (seeded on
    frame 0); a checkpointed run of half the frames and its resume equal to
    the full run, poses included; its fps (best of 3, render off) beside
    phase 11's tracker scan, and its syncs per frame."""
    import os

    from hackathonopticalflow_tpu_torch.apps.tracker_app import TrackerApp, TrackerAppConfig
    from hackathonopticalflow_tpu_torch.core import TrackerParams
    from hackathonopticalflow_tpu_torch.flow import tracker

    params = TrackerParams()
    n = clip.shape[0] - 1
    bgr = ClipReader(clip[:n].cpu().numpy()).bgr  # replicated once, outside the app's clock

    def app(**kw):
        cfg = TrackerAppConfig(video="synthetic zoom clip", params=params, device=str(dev), **kw)
        return TrackerApp(cfg, open_reader=lambda path: ClipReader(bgr))

    full_app = app(max_frames=n)
    full, cnt = counted(lambda: full_app.run(headless=True))
    lk_n, pb_n = cnt.replayed.get("lk_level", 0), cnt.replayed.get("patch_bilinear", 0)
    s0 = tracker.track_step(tracker.init_tracker(params, dev), clip[0], clip[0], params, device=dev)
    state, _ = tracker.track_video(clip[:n], params, s0, device=dev)
    want_heads = tracker._heads(state)[state.alive].cpu().numpy()
    same = full["final_tracks"] == int(state.alive.sum()) and np.array_equal(full["final_heads"], want_heads)
    poses = full["poses"]
    log(f"tracker app ({full['frames']} frames): lk_level launches {cnt.launched['lk_level']}, patch_bilinear "
        f"{cnt.launched['patch_bilinear']} (warm-ups and captures of track_frame's two graphs); executions by "
        f"graph replays lk_level {lk_n} ({6 * n} expected), patch_bilinear {pb_n} ({8 * n} expected); final "
        f"tracks {full['final_tracks']}, equal to track_video's with its heads {same}; {len(poses)} poses, median "
        f"inliers {float(np.median([p['inliers'] for p in poses])) if poses else 0.0}")
    if not same or lk_n != 6 * n or pb_n != 8 * n or not poses:
        raise SystemExit("the tracker app disagrees with track_video")

    ck = os.path.join("build", "chip_smoke_tracker.ckpt.npz")
    os.makedirs("build", exist_ok=True)
    if os.path.exists(ck):
        os.remove(ck)
    part1 = app(max_frames=n // 2, checkpoint_path=ck, checkpoint_every=n // 2).run(headless=True)
    part2 = app(max_frames=n, checkpoint_path=ck, checkpoint_every=n // 2).run(headless=True)
    os.remove(ck)
    resumed = (part2["final_tracks"] == full["final_tracks"]
               and np.array_equal(part2["final_heads"], full["final_heads"])
               and [(p["frame"], p["inliers"]) for p in part2["poses"]] == [(p["frame"], p["inliers"]) for p in poses]
               and all(np.array_equal(a["R"], b["R"]) and np.array_equal(a["t"], b["t"])
                       for a, b in zip(part2["poses"], poses)))
    log(f"tracker app checkpointed run: {part1['frames']} frames, resumed for {part2['frames_this_run']}; "
        f"equal to the full run {resumed}")
    if not resumed or part2["frames_this_run"] != n - n // 2:
        raise SystemExit("the resumed tracker app disagrees with the full run")

    fps = max(full_app.run(headless=True)["fps"] for _ in range(3))
    syncs = sync_calls(lambda: full_app.run(headless=True))
    log(f"tracker app {n} frames {H}p (pose on, render off): {fps:.2f} fps, best of 3; tracker scan "
        f"(phase 11) {tracker_fps:.2f} fps; app / scan {fps / tracker_fps:.3f}; syncs per frame "
        + ", ".join(f"{k} {v / n:.1f}" for k, v in syncs.items()))
    return {"tracker_app_launches": cnt, "tracker_app_fps": fps, "tracker_app_poses": len(poses),
            "tracker_app_syncs": syncs}


SLAB_SPREAD_PX = 150.0  # amplitude of phase 18's out-of-margin field
DENSE_VIEWER_PAIRS = 8  # the viewer renders on the host (numpy rasterizer without cv2)
DENSE_MODES = ("packed", "pallas", "pallas_bf16", "image", "hybrid")


def _slab_bytes_ops(c: int, hk: int, wk: int, src_bytes: int) -> tuple[float, float]:
    """(bytes, float32 ops) of one slab warp: fx, fy and C source planes
    read once, C float32 planes written; per pixel the corner clamps and
    fractions (14 ops) and per channel the x-lerps and the y-lerp (9)."""
    return (8 + c * (src_bytes + 4)) * hk * wk, (14 + 9 * c) * hk * wk


def slab_phase(dev, clip, floor_ms: float) -> dict:
    """Phase 18: warp_bilinear's slab geometry (warp_mode "pallas", and
    "pallas_bf16" on a bf16 source) against its plain version on the
    (5, Hk, Wk) coefficient pyramids of one 720p pair at the 4 level sizes,
    sampled at the flow of one Farneback iteration, and on an
    out-of-margin field (spread SLAB_SPREAD_PX px, samples clamped) at the
    coarsest and finest sizes, and on warp_edge_cases: identical. Device
    time of each variant per level (graph replay), its bound (the bf16
    source at 2 B a value), its share of the bound and of max(bound,
    floor_ms), the launch, every launch the kernel takes timed beside it,
    and F.grid_sample's time on the float32 source (border padding: within
    the margins the same samples; no PyTorch call samples a bf16 source at
    float32 coordinates)."""
    from hackathonopticalflow_tpu_torch.core import FarnebackParams
    fb = importlib.import_module("hackathonopticalflow_tpu_torch.ops.farneback")
    from hackathonopticalflow_tpu_torch.ops.warp_bilinear import (
        _corners,
        slab_origins,
        warp_bilinear,
        warp_bilinear_reference,
    )

    edge_err = warp_edge_cases(dev, "slab")
    out = {}
    for variant, mode in (("f32", "pallas"), ("bf16", "pallas_bf16")):
        params = FarnebackParams(warp_mode=mode)
        rs0, rs1 = fb.prepare_frame(clip[0], params), fb.prepare_frame(clip[1], params)
        src_bytes = 2 if variant == "bf16" else 4
        max_err = edge_err
        level_ms, level_plain_ms, level_lib_ms, level_bound_ms = {}, {}, {}, {}
        n_bytes = f32_ops = 0.0
        for r0, r1 in zip(rs0, rs1):
            hk, wk = r0.shape[-2:]
            zero = torch.zeros((hk, wk, 2), dtype=torch.float32, device=dev)
            flow = fb._solve_flow(fb.update_matrices(r0, r1, zero, mode), params)
            xs, ys = fb._pixel_coords(hk, wk, dev)
            src = fb.warp_source(r1, mode)
            key = f"{hk}x{wk}"
            fields = [("flow", (xs + flow[..., 0]).contiguous(), (ys + flow[..., 1]).contiguous())]
            if hk in (90, DENSE_H):
                fields.append(("spread", *_spread_field(xs, ys, SLAB_SPREAD_PX)))
            for field, fx, fy in fields:
                warp_bilinear.launches = 0
                out_k = warp_bilinear(src, fx, fy, "slab")
                torch.cuda.synchronize()
                launches = warp_bilinear.launches
                out_p = warp_bilinear_reference(src, fx, fy, "slab")
                err = float((out_k - out_p).abs().max())
                same = bool(torch.equal(out_k, out_p))
                x0, y0, _, _ = _corners(fx, fy, hk, wk)
                y_s, x_s = slab_origins(x0.long(), y0.long())
                clamped = float(((y_s != y0.long()) | (x_s != x0.long())).double().mean())
                log(f"slab {variant} {key} {field}: launches {launches}, max |d| {err:.3g}, identical {same}, "
                    f"clamped share {clamped:.4f}")
                if launches != 1 or not same or (field == "spread") != (clamped > 0.1):
                    raise SystemExit(f"slab {variant} {key} {field}: kernel disagrees with the plain version")
                max_err = max(max_err, err)
            _, fx, fy = fields[0]
            level_ms[key] = graph_ms(lambda: warp_bilinear(src, fx, fy, "slab"), 50)
            level_plain_ms[key] = graph_ms(lambda: warp_bilinear_reference(src, fx, fy, "slab"), 10)
            level_lib_ms[key] = grid_sample_ms(r1, fx, fy, "border", 50)
            lv_bytes, lv_ops = _slab_bytes_ops(r1.shape[0], hk, wk, src_bytes)
            level_bound_ms[key], lv_by = bound(lv_bytes, lv_ops)
            n_bytes += lv_bytes
            f32_ops += lv_ops
            log(warp_level_line(f"slab {variant}", key, level_ms[key], level_plain_ms[key], level_lib_ms[key],
                                level_bound_ms[key], lv_by, floor_ms))
            warp_launch_ranking(f"slab {variant}", key, src, fx, fy, "slab")
        bound_ms, bound_by = bound(n_bytes, f32_ops)
        log(f"warp_bilinear slab {variant} per level (device ms, kernel / plain / F.grid_sample / bound): "
            + ", ".join(f"{k} {level_ms[k]:.4f} / {level_plain_ms[k]:.4f} / {level_lib_ms[k]:.4f} / "
                        f"{level_bound_ms[k]:.4f}" for k in level_ms)
            + f"; bound of the 4 levels {bound_ms:.4f} ms ({bound_by}: {n_bytes / 1e6:.1f} MB)")
        out[variant] = {
            "name": f"warp_bilinear slab {variant}",
            "route": "cuda",
            "source": "hackathonopticalflow_tpu_torch/csrc/warp_bilinear.cu",
            "replaces": "hackathonopticalflow_tpu/ops/warp_pallas.py:207",
            "launches": 0,
            "max_abs_err": max_err,
            "ms": sum(level_ms.values()),
            "plain_ms": sum(level_plain_ms.values()),
            "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": sum(level_lib_ms.values()),
            "launch_floor_ms": floor_ms,
            "shape_ms": level_ms,
            "shape_bound_ms": level_bound_ms,
            "shape_library_ms": level_lib_ms,
        }
    return out


def dense_modes_phase(dev, clip) -> dict:
    """Phase 19: the other warp modes over phase 7's 24-pair 720p clip:
    farneback_flow_video in the coefficient modes ("packed", "pallas",
    "pallas_bf16"), farneback_flow pair by pair in "image" and "hybrid"
    (the scan refuses them, as JAX's does). Finite flows of the clip's
    shape, median endpoint error < TOL_DENSE_EPE_PX; warp_bilinear launched
    12 times a pair in the coefficient modes, once a level (4) in "hybrid",
    never in "image"; where it runs, the first 2 pairs equal to the plain
    path's; every mode's fps and the exact scan's, timed in turns (best
    of 2)."""
    from hackathonopticalflow_tpu_torch.core import FarnebackParams
    from hackathonopticalflow_tpu_torch.flow import dense
    fb = importlib.import_module("hackathonopticalflow_tpu_torch.ops.farneback")
    from hackathonopticalflow_tpu_torch.ops.warp_bilinear import warp_bilinear_reference

    pairs = DENSE_FRAMES - 1
    out = {"launches": {}, "executions": {}, "fps": {}, "median_epe_px": {}}
    runs = {"exact": lambda c: dense.farneback_flow_video(c, FarnebackParams(), device=dev)}
    for mode in DENSE_MODES:
        params = FarnebackParams(warp_mode=mode)
        if mode in fb.COEF_MODES:
            def run(c, params=params):
                return dense.farneback_flow_video(c, params, device=dev)
            per_pair = params.iterations * (params.levels + 1)
        else:
            def run(c, params=params):
                return torch.stack([dense.farneback_flow(c[t], c[t + 1], params, device=dev)
                                    for t in range(c.shape[0] - 1)])
            per_pair = params.levels + 1 if mode == "hybrid" else 0
        flows, cnt = counted(lambda: run(clip))
        launches, replayed = cnt.launched["warp_bilinear"], cnt.replayed.get("warp_bilinear", 0)
        med_epe = dense_median_epe(flows)
        ok = flows.shape == (pairs, DENSE_H, DENSE_W, 2) and bool(torch.isfinite(flows).all())
        log(f"dense {mode}: warp_bilinear launches {launches} (warm-up and capture), executions by graph "
            f"replays {replayed} ({per_pair * pairs} expected), median EPE {med_epe:.4f} px, finite and shaped {ok}")
        if not ok or replayed != per_pair * pairs or launches != 2 * per_pair or not med_epe < TOL_DENSE_EPE_PX:
            raise SystemExit(f"the dense path in warp_mode {mode!r} is wrong")
        if per_pair:
            with eager(), mock.patch.object(fb, "warp_bilinear", warp_bilinear_reference):
                plain = run(clip[: DENSE_PLAIN_PAIRS + 1])
            same = bool(torch.equal(plain, flows[:DENSE_PLAIN_PAIRS]))
            log(f"dense {mode} plain path ({DENSE_PLAIN_PAIRS} pairs): identical to the kernel path {same}")
            if not same:
                raise SystemExit(f"the dense kernel path in warp_mode {mode!r} disagrees with the plain path")
        runs[mode] = run
        out["launches"][mode] = launches
        out["executions"][mode] = cnt.ran["warp_bilinear"]
        out["median_epe_px"][mode] = med_epe
    # the scans are host-bound, and the host is shared: every mode, the
    # exact scan among them, timed in turns, best of 2
    best = {m: float("inf") for m in runs}
    for _ in range(2):
        for m, run in runs.items():
            best[m] = min(best[m], host_seconds(lambda: run(clip)))
    out["fps"] = {m: pairs / t for m, t in best.items()}
    log(f"dense scans {pairs} pairs {DENSE_H}p, timed in turns (fps, best of 2; / exact): "
        + ", ".join(f"{m} {f:.2f} ({f / out['fps']['exact']:.3f})" for m, f in out["fps"].items()))
    return out


def dense_viewer_phase(dev, clip, scan_fps: dict) -> dict:
    """Phase 20: the dense viewer (apps/dense_viewer.py) at its defaults
    (FarnebackParams(), the exact LK path with PROTO_FILTER) over the first
    DENSE_VIEWER_PAIRS pairs of phase 7's 720p clip read from host memory
    (ClipReader), headless, with
    the dense, HSV and contour layers on (rendered through viz/'s numpy
    rasterizer where there is no cv2): each pair's flow equal to
    farneback_flow's and its sparse result to lk_grid_flow's, every
    rendered frame and contour layer drawn, warp_bilinear 12 and lk_level
    3 times a pair; the app's fps (render and contours included) beside
    the scans'."""
    from hackathonopticalflow_tpu_torch.apps.dense_viewer import DenseViewerApp, DenseViewerConfig
    from hackathonopticalflow_tpu_torch.flow import dense, lk_grid

    pairs = DENSE_VIEWER_PAIRS
    bgr = ClipReader(clip[: pairs + 1].cpu().numpy()).bgr  # replicated once, outside the app's clock
    cfg = DenseViewerConfig(video="synthetic zoom clip", add_flow=True, add_hsv=True, show_contours=True,
                            max_frames=pairs, device=str(dev))
    app = DenseViewerApp(cfg, open_reader=lambda path: ClipReader(bgr))
    records = []
    stats, cnt = counted(lambda: app.run(headless=True, on_pair=lambda *a: records.append(a)))
    replayed = tuple(cnt.replayed.get(k, 0) for k in ("warp_bilinear", "lk_level", "patch_bilinear"))
    per_pair = cfg.fb.iterations * (cfg.fb.levels + 1)
    log(f"dense viewer ({stats['frames']} pairs, farneback_flow's and lk_grid_flow's graphs): launches (warm-ups "
        f"and captures) warp_bilinear {cnt.launched['warp_bilinear']}, lk_level {cnt.launched['lk_level']}, "
        f"patch_bilinear {cnt.launched['patch_bilinear']}; executions by graph replays warp_bilinear "
        f"{replayed[0]} ({per_pair * pairs} expected), lk_level {replayed[1]}, patch_bilinear {replayed[2]}")
    if stats["frames"] != pairs or replayed[0] != per_pair * pairs or replayed[1] < 3 * pairs:
        raise SystemExit("the dense viewer did not run its kernels at every pair")
    for t, (flow, sres, frame, contours) in enumerate(records):
        want = dense.farneback_flow(clip[t], clip[t + 1], cfg.fb, device=dev)
        ws = lk_grid.lk_grid_flow(clip[t], clip[t + 1], app._pts_dev, cfg.lk, filt=cfg.filt, device=dev)
        same = bool(torch.equal(flow, want)) and all(
            torch.equal(getattr(sres, k), getattr(ws, k)) for k in ("raw_next_pts", "good", "next_pts", "flow"))
        drawn = frame.shape == (DENSE_H, DENSE_W, 3) and frame.dtype == np.uint8 and bool((contours > 0).any())
        if not same or not drawn:
            raise SystemExit(f"dense viewer pair {t}: flow equal {same}, frame and contours drawn {drawn}")
    good = float(np.mean([float(r[1].good.double().mean()) for r in records]))
    log(f"dense viewer: {pairs} pairs equal to farneback_flow and lk_grid_flow, frames and contours drawn, "
        f"good share {good:.4f}")
    log(f"dense viewer {pairs} pairs {DENSE_H}p (headless, dense + HSV + contours rendered): {stats['fps']:.2f} fps; "
        "dense scans (phase 19): " + ", ".join(f"{m} {v:.2f}" for m, v in scan_fps.items()) + " fps")
    return {"dense_viewer_fps": stats["fps"], "dense_viewer_launches": cnt}


BATCH_LENGTHS = (49, 41, 33, 25)  # frames of phase 21's four streams: 144 pairs, three end early
BATCH_ZOOMS = (1.003, 1.004, 1.005, 1.006)  # their zoom per frame
BATCH_EXACT_FRAMES = 9  # frames per stream of the exact-path run (8 steps)
BATCH_PROFILE_FRAMES = 13  # frames per stream of the profiled run (12 steps)
BATCH_RESUME_FRAMES = 25  # the checkpointed run stops after 24 steps


def batch_streams(dev) -> list[np.ndarray]:
    """Phase 21's four 1080p streams on the host, (T, H, W) uint8 each:
    make_clip with seeds 0-3, zooms BATCH_ZOOMS and lengths
    BATCH_LENGTHS."""
    return [make_clip(dev, H, W, n, seed=i, zoom=z).cpu().numpy()
            for i, (n, z) in enumerate(zip(BATCH_LENGTHS, BATCH_ZOOMS))]


def batched_kernel_phase(dev, streams) -> dict:
    """Phase 21 kernels: lk_level at each production level and
    patch_bilinear at the exact path's template shapes, with a stream axis
    of the four streams' first pairs: identical to their plain versions at
    B = 4; at B = 1 identical to the unbatched call. Device times (graph
    replay) at B = 1 and B = 4 beside the bound, and F.grid_sample's batched
    time for patch_bilinear."""
    from hackathonopticalflow_tpu_torch.core import LKParams, measurement_grid
    from hackathonopticalflow_tpu_torch.ops import lk as lk_mod
    from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level, lk_level_reference
    from hackathonopticalflow_tpu_torch.ops.patch_bilinear import patch_bilinear, patch_bilinear_reference

    params = LKParams(grid_step=30, compute_err=False)
    pts_np = measurement_grid(H, W, params.grid_step)
    pts = torch.from_numpy(pts_np).to(dev)
    n = pts.shape[0]
    grid_xy = (np.unique(pts_np[:, 0]).astype(int), np.unique(pts_np[:, 1]).astype(int))
    pair = torch.from_numpy(np.stack([f[:2] for f in streams], 1)).to(dev)  # (2, B, H, W)
    b = pair.shape[1]
    lk = {"ms": {}, "plain_ms": {}, "bound_ms": {}, "max_abs_err": 0.0}
    work = {1: [0.0, 0.0, 0.0], b: [0.0, 0.0, 0.0]}
    for nb in (1, b):
        cur, prev = lk_mod.prepare_frame(pair[1, :nb], params), lk_mod.prepare_frame(pair[0, :nb], params)
        one = (lk_mod.prepare_frame(pair[1, 0], params), lk_mod.prepare_frame(pair[0, 0], params))
        center = pts.repeat(nb, 1) * (1.0 / (1 << params.max_level))
        status = torch.ones(nb * n, dtype=torch.bool, device=dev)
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
            same = bool(torch.equal(tl_k, tl_p)) and bool(torch.equal(st_k, st_p))
            lk["max_abs_err"] = max(lk["max_abs_err"], float((tl_k - tl_p).abs().max()))
            if nb == 1:
                a1, s1 = lk_mod.level_inputs(*one, grid_xy, center, level, params)
                tl1, st1 = lk_level(*a1, status, **s1)
                same = same and bool(torch.equal(tl1, tl_k)) and bool(torch.equal(st1, st_k))
            key = f"B={nb} L{level}"
            level_work = lk_level_work(args, statics, stats)
            work[nb] = [x + y for x, y in zip(work[nb], level_work)]
            lk["ms"][key] = graph_ms(lambda: lk_level(*args, status, **statics), 20)
            lk["plain_ms"][key] = graph_ms(lambda: lk_level_reference(*args, status, **statics), 2)
            lk["bound_ms"][key], _ = bound(*level_work)
            log(f"lk_level stream-batched {key} ({nb * n} points, planes {tuple(args[1].shape)}): launches "
                f"{launches}, identical to the plain version{' and to the unbatched call' if nb == 1 else ''} "
                f"{same}; device time (graph replay) {lk['ms'][key]:.4f} ms, plain {lk['plain_ms'][key]:.4f} ms, "
                "bound %.4f ms (%s)" % bound(*level_work))
            if launches != 1 or not same:
                raise SystemExit(f"lk_level stream-batched {key}: kernel disagrees")
            center, status = tl_p + lk_mod._halfwin(params, dev), st_p

    exact = LKParams(compute_err=False)
    win_w, win_h = exact.win_size
    pad = lk_mod._frame_pad(exact)
    halfwin = lk_mod._halfwin(exact, dev)
    ii = torch.arange(win_h, dtype=torch.float32, device=dev)[None, :, None]
    jj = torch.arange(win_w, dtype=torch.float32, device=dev)[None, None, :]
    pb = {"ms": {}, "plain_ms": {}, "bound_ms": {}, "library_ms": {}, "max_abs_err": 0.0}
    pb_work = {1: [0.0, 0.0], b: [0.0, 0.0]}
    for nb in (1, b):
        cur = lk_mod.prepare_frame(pair[1, :nb], exact)
        one = lk_mod.prepare_frame(pair[1, 0], exact)
        for level in range(exact.max_level, -1, -1):
            planes = torch.stack([cur.img_p[level], cur.dix_p[level], cur.diy_p[level]], dim=1)
            tl = (pts * (1.0 / (1 << level)) - halfwin + pad).repeat(nb, 1).contiguous()
            patch_bilinear.launches = 0
            got = patch_bilinear(planes, tl, win_h, win_w, True)
            torch.cuda.synchronize()
            launches = patch_bilinear.launches
            ref = patch_bilinear_reference(planes, tl, win_h, win_w, True)
            same = bool(torch.equal(got, ref))
            pb["max_abs_err"] = max(pb["max_abs_err"], float((got - ref).abs().max()))
            if nb == 1:
                planes1 = torch.stack([one.img_p[level], one.dix_p[level], one.diy_p[level]])
                same = same and bool(torch.equal(patch_bilinear(planes1, tl, win_h, win_w, True), got))
            key = f"B={nb} tmpl L{level}"
            pb["ms"][key] = graph_ms(lambda: patch_bilinear(planes, tl, win_h, win_w, True), 20)
            pb["plain_ms"][key] = graph_ms(lambda: patch_bilinear_reference(planes, tl, win_h, win_w, True), 3)
            grid = torch.stack([(tl[:, 0, None, None] + jj).expand(-1, win_h, -1),
                                (tl[:, 1, None, None] + ii).expand(-1, -1, win_w)], dim=-1)
            hp, wp = planes.shape[-2:]
            grid = grid * torch.tensor([2.0 / (wp - 1), 2.0 / (hp - 1)], device=dev) - 1.0
            grid = grid.reshape(nb, -1, win_w, 2).contiguous()
            pb["library_ms"][key] = graph_ms(lambda: torch.nn.functional.grid_sample(
                planes, grid, mode="bilinear", padding_mode="zeros", align_corners=True), 20)
            call_bytes = min(planes.numel(), tl.shape[0] * 3 * (win_h + 1) * (win_w + 1)) * 4 + tl.numel() * 4 \
                + got.numel() * 4
            call_ops = got.numel() * 11 + 12 * tl.shape[0]
            pb_work[nb] = [pb_work[nb][0] + call_bytes, pb_work[nb][1] + call_ops]
            pb["bound_ms"][key], _ = bound(call_bytes, call_ops)
            log(f"patch_bilinear stream-batched {key} {tuple(got.shape)} of {tuple(planes.shape)}: launches "
                f"{launches}, identical to the plain version{' and to the unbatched call' if nb == 1 else ''} "
                f"{same}; device time (graph replay) {pb['ms'][key]:.4f} ms, plain {pb['plain_ms'][key]:.4f} ms, "
                f"F.grid_sample {pb['library_ms'][key]:.4f} ms, bound %.4f ms (%s)" % bound(call_bytes, call_ops))
            if launches != 1 or not same:
                raise SystemExit(f"patch_bilinear stream-batched {key}: kernel disagrees")

    def record(name, source, replaces, d, w, library):
        keys = [k for k in d["ms"] if k.startswith(f"B={b} ")]
        bound_ms, bound_by = bound(*w[b])
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": 0,
            "max_abs_err": d["max_abs_err"], "ms": sum(d["ms"][k] for k in keys),
            "plain_ms": sum(d["plain_ms"][k] for k in keys), "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sum(d["library_ms"][k] for k in keys) if library else None,
            "ms_b1": sum(v for k, v in d["ms"].items() if k.startswith("B=1 ")),
            "bound_ms_b1": bound(*w[1])[0],
            "shape_ms": d["ms"], "shape_bound_ms": d["bound_ms"],
            **({"shape_library_ms": d["library_ms"]} if library else {}),
        }

    return {
        "lk_level": record(f"lk_level stream-batched B={b}", "hackathonopticalflow_tpu_torch/csrc/lk_level.cu",
                           "hackathonopticalflow_tpu/ops/lk_pallas3.py:82, "
                           "hackathonopticalflow_tpu/ops/lk_pallas3.py:353, "
                           "hackathonopticalflow_tpu/ops/carve_pallas.py:159", lk, work, False),
        "patch_bilinear": record(f"patch_bilinear stream-batched B={b}",
                                 "hackathonopticalflow_tpu_torch/csrc/patch_bilinear.cu",
                                 "hackathonopticalflow_tpu/ops/carve_pallas.py:231", pb, pb_work, True),
    }


def batch_phase(dev, scan_fps: float) -> dict:
    """Phase 21: the batch runner (apps/batch_runner.py) on four 1080p
    streams of BATCH_LENGTHS frames read from host memory (ClipReader; three
    end before the last), at the production params. run_batch: each
    stream's danger counts equal its own lk_grid_flow_video scan's `good`
    sums, the ended streams masked, lk_level 3 times a step for all four
    streams; a checkpointed run and its resume equal the full run;
    run_batch_staged gives the same counts. At LKParams() (the exact path)
    over BATCH_EXACT_FRAMES frames a stream: patch_bilinear 4 and lk_level
    3 times a step, the counts each stream's exact scan's. The
    stream-batched kernels against their plain versions (batched_kernel_
    phase). Aggregate pairs/s of both runs beside the single-stream scan's
    (phase 5), and of run_batch with every stream alive (the first
    BATCH_RESUME_FRAMES frames) beside one stream's scan of the same frames,
    timed in turns; launches and syncs per step; entry() once at 720p."""
    import os

    from hackathonopticalflow_tpu_torch.apps.batch_runner import BatchRunnerConfig, run_batch, run_batch_staged
    from hackathonopticalflow_tpu_torch.core import LKParams, measurement_grid
    from hackathonopticalflow_tpu_torch.entry import entry
    from hackathonopticalflow_tpu_torch.flow import lk_grid

    params = LKParams(grid_step=30, compute_err=False)
    streams = batch_streams(dev)
    b = len(streams)
    bgr = {f"stream{i}": ClipReader(f).bgr for i, f in enumerate(streams)}  # replicated once, off the clock
    pts = torch.from_numpy(measurement_grid(H, W, params.grid_step)).to(dev)
    log(f"batch streams: {b} x {H}p, frames {list(BATCH_LENGTHS)}, zoom {list(BATCH_ZOOMS)}/frame")

    def cfg(lk=params, **kw):
        return BatchRunnerConfig(videos=list(bgr), lk=lk, device=str(dev),
                                 open_reader=lambda path: ClipReader(bgr[path]), **kw)

    def own_scans(lk, frames=None):
        return [lk_grid.lk_grid_flow_video(torch.from_numpy(f[:frames]).to(dev), pts, lk=lk, device=dev)
                .good.sum(1).tolist() for f in streams]

    want = own_scans(params)
    full, cnt = counted(lambda: run_batch(cfg()))
    launches = cnt.launched["lk_level"]
    replayed = cnt.replayed.get("lk_level", 0)
    steps = full["steps"]
    counts = full["danger_counts"]
    lengths = [len(c) for c in counts]
    log(f"batch run_batch ({b} streams, {steps} steps, {full['total_frames']} pairs): lk_level launches "
        f"{launches} (the step graph's warm-up and capture), executions by its replays {replayed} "
        f"({3 * (steps + 1)} expected: 3 a step for all streams, a warm-up step included), patch_bilinear "
        f"{cnt.launched['patch_bilinear']}; pairs per stream {lengths} (ended streams masked); counts equal to "
        f"each stream's own scan {counts == want}")
    if (launches != 2 * 3 or replayed != 3 * (steps + 1) or steps != max(BATCH_LENGTHS) - 1 or counts != want
            or lengths != [n - 1 for n in BATCH_LENGTHS]):
        raise SystemExit("the batch runner disagrees with the streams' own scans")

    ck = os.path.join("build", "chip_smoke_batch.ckpt.npz")
    os.makedirs("build", exist_ok=True)
    if os.path.exists(ck):
        os.remove(ck)
    every = (BATCH_RESUME_FRAMES - 1) // 2
    part1 = run_batch(cfg(max_frames=BATCH_RESUME_FRAMES, checkpoint_path=ck, checkpoint_every=every))
    part2 = run_batch(cfg(checkpoint_path=ck, checkpoint_every=every))
    os.remove(ck)
    resumed = [x + y for x, y in zip(part1["danger_counts"], part2["danger_counts"])]
    log(f"batch checkpointed run: {part1['steps']} steps, resume from step {part2['first_step']}: "
        f"{part2['steps']} steps; counts equal to the full run {resumed == counts}")
    if resumed != counts or part2["first_step"] != BATCH_RESUME_FRAMES:
        raise SystemExit("the resumed batch run disagrees with the full run")

    staged = run_batch_staged(cfg(), reps=2)
    log(f"batch run_batch_staged: counts equal to run_batch's {staged['danger_counts'] == counts}")
    if staged["danger_counts"] != counts:
        raise SystemExit("run_batch_staged disagrees with run_batch")

    exact = LKParams()
    want_exact = own_scans(exact, BATCH_EXACT_FRAMES)
    ex, ex_runs = counted(lambda: run_batch(cfg(lk=exact, max_frames=BATCH_EXACT_FRAMES)))
    ex_launches = (ex_runs.launched["lk_level"], ex_runs.launched["patch_bilinear"])
    ex_replayed = (ex_runs.replayed.get("lk_level", 0), ex_runs.replayed.get("patch_bilinear", 0))
    log(f"batch run_batch at LKParams() ({ex['steps']} steps): launches (warm-up and capture) lk_level "
        f"{ex_launches[0]}, patch_bilinear {ex_launches[1]}; executions by graph replays lk_level {ex_replayed[0]}, "
        f"patch_bilinear {ex_replayed[1]} (3 and 4 a step, a warm-up step included); counts equal to each "
        f"stream's own exact scan {ex['danger_counts'] == want_exact}")
    if (ex_replayed != (3 * (ex["steps"] + 1), 4 * (ex["steps"] + 1)) or ex_launches != (6, 8)
            or ex["danger_counts"] != want_exact):
        raise SystemExit("the batch runner on the exact path disagrees")

    fps = max(run_batch(cfg())["aggregate_fps"] for _ in range(3))
    staged_fps = staged["aggregate_fps"]
    # every stream alive (their first BATCH_RESUME_FRAMES frames) against
    # one stream's scan of the same frames, timed in turns (best of 3)
    first = torch.from_numpy(streams[0][:BATCH_RESUME_FRAMES]).to(dev)
    alive_fps = scan1_fps = 0.0
    for _ in range(3):
        alive_fps = max(alive_fps, run_batch(cfg(max_frames=BATCH_RESUME_FRAMES))["aggregate_fps"])
        scan1_fps = max(scan1_fps, (BATCH_RESUME_FRAMES - 1) / host_seconds(
            lambda: lk_grid.lk_grid_flow_video(first, pts, lk=params, device=dev)))
    prof_steps = BATCH_PROFILE_FRAMES - 1
    calls, syncs = api_calls(lambda: run_batch(cfg(max_frames=BATCH_PROFILE_FRAMES)))
    per = prof_steps + 1  # the warm-up step included
    log(f"batch run_batch {b} x {H}p: {fps:.2f} pairs/s aggregate (best of 3; {fps / b:.2f} steps/s), "
        f"run_batch_staged {staged_fps:.2f} pairs/s (best of 2); single-stream scan (phase 5) {scan_fps:.2f} "
        f"fps; batched / single {fps / scan_fps:.3f}")
    log(f"batch run_batch with all {b} streams alive ({BATCH_RESUME_FRAMES - 1} steps): {alive_fps:.2f} pairs/s; "
        f"one stream's scan of the same frames {scan1_fps:.2f} fps (in turns, best of 3); batched / single "
        f"{alive_fps / scan1_fps:.3f}")
    log(f"batch per step ({prof_steps} steps and a warm-up step, profiled): kernel launches {calls / per:.1f}, "
        "syncs " + (", ".join(f"{k} {v / per:.2f}" for k, v in syncs.items()) or "none"))

    kernels = batched_kernel_phase(dev, streams)
    kernels["lk_level"]["launches"] = launches
    kernels["lk_level"]["launches_by_path"] = {"batch_runner": launches, "batch_runner exact": ex_launches[0]}
    kernels["lk_level"]["executions_by_path"] = {"batch_runner": cnt.ran["lk_level"],
                                                 "batch_runner exact": ex_runs.ran["lk_level"]}
    kernels["patch_bilinear"]["launches"] = ex_launches[1]
    kernels["patch_bilinear"]["launches_by_path"] = {"batch_runner exact": ex_launches[1]}
    kernels["patch_bilinear"]["executions_by_path"] = {"batch_runner exact": ex_runs.ran["patch_bilinear"]}

    step, args = entry(device=dev)
    out = step(*args)
    torch.cuda.synchronize()
    finite = all(bool(torch.isfinite(v.float()).all()) for v in out.values())
    log(f"entry() at 720p: {', '.join(f'{k} {tuple(v.shape)}' for k, v in out.items())}; finite {finite}")
    if not finite or out["dense_flow"].shape != (720, 1280, 2):
        raise SystemExit("entry() gave non-finite values")
    return {
        "kernels": kernels,
        "batch_counts": counts,
        "batch_launches": (cnt, ex_runs),
        "batch_pairs_per_s": fps,
        "batch_staged_pairs_per_s": staged_fps,
        "batch_all_alive_pairs_per_s": alive_fps,
        "batch_single_stream_scan_fps": scan1_fps,
        "batch_launches_per_step": calls / per,
        "batch_syncs_per_step": {k: v / per for k, v in syncs.items()},
    }


GRAPH_TURNS = 1  # phase 24: rounds of eager, graphed, graphed, eager timings


def _same(a, b) -> bool:
    """Whether two results are identical: tensors by torch.equal, arrays
    by np.array_equal, containers element by element."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.shape == b.shape and bool(torch.equal(a, b))
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def graph_phase(dev, clip, dense_clip) -> dict:
    """Phase 24: every captured step (utils/graphs.py) against its eager
    form. For each path (the sparse scan; the pathfinder app's
    run_batched, one graph a chunk, and its per-pair compute_frame; the
    batch runner's step at B = 4; the dense scan in every coefficient
    mode; farneback_flow per pair in "image" and "hybrid"; the dense
    viewer's per-pair flows; the tracker scan, its two graphs; the
    tracker app; collect_tracks): the graphed run identical (torch.equal)
    to the eager run (chip_smoke.eager: every step's __wrapped__) over the
    whole clip, then again with every graphed call (input copies, replay,
    output copies) under torch.cuda.set_sync_debug_mode("error"); the
    graph pool's reserved bytes after the path's captures; both forms'
    fps timed in turns (eager, graphed, graphed, eager, GRAPH_TURNS
    rounds; the best of each); the graphed form's host launches (kernels
    and graphs) and syncs a pair or step (torch.profiler; the eager
    form's: profile_torch_scan.py --eager)."""
    from hackathonopticalflow_tpu_torch.apps.batch_runner import BatchRunnerConfig, run_batch
    from hackathonopticalflow_tpu_torch.apps.dense_viewer import DenseViewerApp, DenseViewerConfig
    from hackathonopticalflow_tpu_torch.apps.pathfinder import PathfinderApp, PathfinderConfig
    from hackathonopticalflow_tpu_torch.apps.tracker_app import TrackerApp, TrackerAppConfig
    from hackathonopticalflow_tpu_torch.core import FarnebackParams, LKParams, TrackerParams, measurement_grid
    from hackathonopticalflow_tpu_torch.flow import dense, lk_grid, tracker
    from hackathonopticalflow_tpu_torch.nav import odometry as odo
    from hackathonopticalflow_tpu_torch.utils import graphs

    params = LKParams(grid_step=30, compute_err=False)
    tparams = TrackerParams()
    pts = torch.from_numpy(measurement_grid(H, W, params.grid_step)).to(dev)
    pairs = clip.shape[0] - 1
    frames = clip.cpu().numpy()
    bgr = ClipReader(frames).bgr
    dense_pairs = dense_clip.shape[0] - 1
    dense_frames = dense_clip.cpu().numpy()
    dense_bgr = ClipReader(dense_frames[: DENSE_VIEWER_PAIRS + 1]).bgr
    streams = batch_streams(dev)
    stream_bgr = {f"stream{i}": ClipReader(f).bgr for i, f in enumerate(streams)}
    s0 = tracker.track_step(tracker.init_tracker(tparams, dev), clip[0], clip[0], tparams, device=dev)

    pf = PathfinderApp(PathfinderConfig(video="synthetic zoom clip", lk=params, max_frames=pairs, device=str(dev)),
                       open_reader=lambda path: ClipReader(bgr))
    viewer = DenseViewerApp(DenseViewerConfig(video="synthetic zoom clip", max_frames=DENSE_VIEWER_PAIRS,
                                              device=str(dev)), open_reader=lambda path: ClipReader(dense_bgr))
    track_app = TrackerApp(TrackerAppConfig(video="synthetic zoom clip", params=tparams, max_frames=pairs,
                                            device=str(dev)), open_reader=lambda path: ClipReader(bgr[:pairs]))
    batch_cfg = BatchRunnerConfig(videos=list(stream_bgr), lk=params, device=str(dev),
                                  open_reader=lambda path: ClipReader(stream_bgr[path]))

    def pair_loop(fn, n):
        return lambda: [fn(t) for t in range(1, n + 1)]

    def pf_run():
        pf.reader.seek(0)  # run reads the app's own reader
        return pf.run(headless=True, render=False)["danger_counts"]

    paths = {
        "sparse scan": (pairs, lambda: lk_grid.lk_grid_flow_video(clip, pts, lk=params, device=dev), ()),
        "pathfinder run_batched": (pairs, lambda: pf.run_batched(chunk=APP_CHUNK)["danger_counts"], (pf,)),
        "pathfinder compute_frame": (pairs, pair_loop(lambda t: pf.compute_frame(frames[t - 1], frames[t]), pairs),
                                     ()),
        "pathfinder run": (pairs, pf_run, ()),
        "batch runner (4 streams)": (max(BATCH_LENGTHS) - 1, lambda: run_batch(batch_cfg)["danger_counts"], ()),
        **{f"dense scan {mode}": (dense_pairs, lambda mode=mode: dense.farneback_flow_video(
            dense_clip, FarnebackParams(warp_mode=mode), device=dev), ())
           for mode in ("exact", "packed", "pallas", "pallas_bf16")},
        **{f"dense pair {mode}": (dense_pairs, pair_loop(lambda t, mode=mode: dense.farneback_flow(
            dense_clip[t - 1], dense_clip[t], FarnebackParams(warp_mode=mode), device=dev), dense_pairs), ())
           for mode in ("image", "hybrid")},
        "dense viewer compute_frame": (DENSE_VIEWER_PAIRS, pair_loop(
            lambda t: viewer.compute_frame(dense_frames[t - 1], dense_frames[t]), DENSE_VIEWER_PAIRS), ()),
        "tracker scan": (pairs, lambda: tracker.track_video(clip, tparams, s0, device=dev), ()),
        "tracker app (pose on)": (pairs, lambda: {k: v for k, v in track_app.run(headless=True).items()
                                                  if k in ("final_heads", "poses", "final_tracks")}, ()),
        "collect_tracks": (pairs + 1, lambda: tuple(odo.collect_tracks(clip, tparams, device=dev)), ()),
    }
    out = {}
    for name, (units, run, objs) in paths.items():
        t0 = time.perf_counter()
        graphs.clear_caches()
        torch.cuda.empty_cache()
        with eager(*objs):
            want = run()
        got = run()  # captures
        torch.cuda.synchronize()
        pool = graphs.pool_bytes(dev)
        with strict_replays():
            again = run()
            torch.cuda.synchronize()
        same = _same(got, want) and _same(again, want)
        best = {"eager": float("inf"), "graphed": float("inf")}
        for _ in range(GRAPH_TURNS):
            for form in ("eager", "graphed", "graphed", "eager"):
                with eager(*objs) if form == "eager" else contextlib.nullcontext():
                    best[form] = min(best[form], host_seconds(run))
        launches, syncs = api_calls(run)
        rec = {
            "identical": same,
            "pool_bytes": pool,
            "fps": {form: units / t for form, t in best.items()},
            "host_launches_per_unit": launches / units,
            "syncs_per_unit": sum(syncs.values()) / units,
        }
        out[name] = rec
        log(f"graphs {name} ({units} pairs or steps): replay identical to eager {same} (every replay under "
            f"sync debug mode 'error'); fps graphed {rec['fps']['graphed']:.2f}, eager {rec['fps']['eager']:.2f} "
            f"({rec['fps']['graphed'] / rec['fps']['eager']:.3f}x; in turns, best of {2 * GRAPH_TURNS}); graphed "
            f"host launches {rec['host_launches_per_unit']:.2f} and syncs {rec['syncs_per_unit']:.2f} a pair or "
            f"step; graph pool {pool / 2**20:.1f} MiB; {time.perf_counter() - t0:.1f} s")
        if not same:
            raise SystemExit(f"graphs: {name} replayed disagrees with its eager form")
    return {"graphs": out}


def ba_window_state(dev):
    """The first keyframe window of scene_table()'s 3D scene at
    OdometryConfig() (its 4 keyframes, its 256 slots as landmarks) as
    nav/odometry.py's batched window solve starts it: the unit-step
    essential chain, the DLT landmarks and the reprojection gate, on
    `dev`. Returns (BAState, the resolved config)."""
    from hackathonopticalflow_tpu_torch.nav import odometry as odo
    from hackathonopticalflow_tpu_torch.nav.ba import BAState
    from hackathonopticalflow_tpu_torch.nav.camera import Pinhole

    scene, _ = scene_table(h=H, w=W)
    table = odo.TrackTable(*scene)
    cam = Pinhole.from_fov(W, H, 155.0)
    cfg = odo.resolve_config(odo.OdometryConfig(), cam)
    kf = odo.select_keyframes(table, cam, cfg, dev)[: cfg.window]
    pos, mask = odo.build_window(table, kf, cfg)
    obs = cam.normalize(pos).to(dev)
    mask = torch.from_numpy(mask).to(dev)
    rv, tv, points = odo._init_chain_core(obs, mask, cfg.inlier_thresh)
    ok = odo._reproj_mask(points, rv, tv, obs, mask, cfg)
    return BAState(rvecs=rv, tvecs=tv, points=points, obs=obs, mask=ok), cfg


MESH_RANKS = 4  # phase 22: gloo ranks sharing cuda:0
MESH_TIMEOUT_S = 600.0  # a world's deadline: past it every rank is killed and the run fails
TILE_SEEDS = (0, 1)  # phase 22(a)'s two 720p zoom streams
TOL_TILE_EPE_PX = 1e-3  # tiled against single-rank Farneback over the core rows
SHARED = "ranks sharing one GPU: times measure overhead, not scaling"


def _wrapper_counts() -> dict:
    """The kernels' wrapper counts (eager launches, and launches recorded
    into a graph)."""
    from hackathonopticalflow_tpu_torch.ops.gather_rects import gather_rects
    from hackathonopticalflow_tpu_torch.ops.grid_templates import grid_templates
    from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level
    from hackathonopticalflow_tpu_torch.ops.patch_bilinear import patch_bilinear
    from hackathonopticalflow_tpu_torch.ops.warp_bilinear import warp_bilinear

    return {"lk_level": lk_level.launches, "warp_bilinear": warp_bilinear.launches,
            "patch_bilinear": patch_bilinear.launches, "gather_rects": gather_rects.launches,
            "grid_templates": grid_templates.launches}


def _launch_counts() -> dict:
    """The kernels' executions on the device since _zero_launch_counts():
    the wrappers' counts less the launches that captures recorded, plus
    the launches that graph replays ran."""
    from hackathonopticalflow_tpu_torch.utils import graphs

    stats = graphs.launch_stats()
    return {k: v - stats["captured"].get(k, 0) + stats["replayed"].get(k, 0) for k, v in _wrapper_counts().items()}


def _zero_launch_counts() -> None:
    """Every kernel's wrapper count, and the graphs' counts, to 0."""
    from hackathonopticalflow_tpu_torch.utils import graphs

    graphs.reset_stats()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def mesh_rank(dev, inp: dict) -> dict:
    """One rank of phases 22 and 23 (a world of inp["n"] ranks, started by
    parallel/mesh.py::run_on_mesh). Each step runs once to warm up (index
    caches), then once with the launch counts set to 0 and its time taken
    between a barrier and a synchronize; results come back on the CPU:
    (a) tiled_farneback_multi on an inp["tile_mesh"] (stream, tile) mesh,
        FarnebackParams() in "exact" and "pallas", halo inp["halo"];
    (b) stream_batched_grid_flow over an (n,) 'stream' mesh at the
        production and the exact LKParams;
    (c) distributed_bundle_adjust and ring_bundle_adjust over an (n,) 'win'
        mesh;
    (d) (with "halo" in inp) halo_exchange_rows of a frame's row block in
        every mode, held here against the padded frame, and the q99
        psum-histogram quantile of (a)'s exact flow over the tile axis;
    (e) (with "batch" in inp) run_batch with n_devices=n, each rank making
        its own streams (make_clip);
    (f) (with "dryrun" in inp) the flow paths of dryrun_multichip(n) on
        its own mesh (entry.py::_dryrun_flow).
    Steps (a), (b) and (f) run once more with every kernel replaced by its
    plain version (the collectives unchanged); out["plain equal"] says
    whether each step's result is identical (torch.equal) to the kernels'."""
    import torch.distributed as dist

    from hackathonopticalflow_tpu_torch import entry
    from hackathonopticalflow_tpu_torch import parallel as par
    from hackathonopticalflow_tpu_torch.apps.batch_runner import BatchRunnerConfig, run_batch
    from hackathonopticalflow_tpu_torch.core import FarnebackParams, LKParams
    from hackathonopticalflow_tpu_torch.nav.ba import BAState
    fb = importlib.import_module("hackathonopticalflow_tpu_torch.ops.farneback")
    from hackathonopticalflow_tpu_torch.ops import lk as lk_mod
    from hackathonopticalflow_tpu_torch.ops import patch as patch_mod
    from hackathonopticalflow_tpu_torch.ops.grid_templates import grid_templates_reference
    from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level_reference
    from hackathonopticalflow_tpu_torch.ops.patch_bilinear import patch_bilinear_reference
    from hackathonopticalflow_tpu_torch.ops.warp_bilinear import warp_bilinear_reference

    n = inp["n"]
    out = {"seconds": {}, "launches": {}, "plain equal": {}}

    def plain(fn):
        with eager(), mock.patch.object(fb, "warp_bilinear", warp_bilinear_reference), \
                mock.patch.object(lk_mod, "lk_level", lk_level_reference), \
                mock.patch.object(lk_mod, "grid_templates", grid_templates_reference), \
                mock.patch.object(patch_mod, "patch_bilinear", patch_bilinear_reference):
            return fn()

    def equal(a, b) -> bool:
        if isinstance(a, torch.Tensor):
            return bool(torch.equal(a.cpu(), b.cpu()))
        return all(equal(x, y) for x, y in zip(a, b))

    def step(name, fn):
        fn()
        dist.barrier()
        _sync(dev)
        _zero_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        _sync(dev)
        out["seconds"][name] = time.perf_counter() - t0
        out["launches"][name] = _launch_counts()
        return res

    grid = par.stream_tile_mesh(*inp["tile_mesh"], dev)
    prev, nxt = (par.shard_rows(par.shard_rows(torch.from_numpy(f), grid, "stream"), grid, "tile", 1)
                 for f in inp["dense"])
    tile = par.TileConfig(halo=inp["halo"])
    for mode in ("exact", "pallas"):
        params = FarnebackParams(warp_mode=mode)
        run = lambda: par.tiled_farneback_multi(prev, nxt, grid, params, tile)  # noqa: E731
        out[f"tiled {mode}"] = step(f"tiled {mode}", run).cpu()
        out["plain equal"][f"tiled {mode}"] = equal(out[f"tiled {mode}"], plain(run))
    out["grid coords"] = (grid.axis("stream").index, grid.axis("tile").index)

    streams = par.make_mesh((n,), ("stream",), dev)
    a, b = (par.shard_rows(torch.from_numpy(f), streams, "stream") for f in inp["sparse"])
    pts = torch.from_numpy(inp["pts"])
    for name, lk in (("production", LKParams(grid_step=30, compute_err=False)), ("exact", LKParams())):
        run = lambda: par.stream_batched_grid_flow(a, b, pts, streams, lk=lk)  # noqa: E731
        res = step(f"grid {name}", run)
        out[f"grid {name}"] = type(res)(*(f.cpu() for f in res))
        out["plain equal"][f"grid {name}"] = equal(res, plain(run))

    flat = par.make_mesh((n,), ("win",), dev)
    state = BAState(*map(torch.from_numpy, inp["ba"]))
    for name, fn, shard in (("ba_dist", par.distributed_bundle_adjust, par.shard_landmarks),
                            ("ba_ring", par.ring_bundle_adjust, par.shard_keyframes)):
        local = shard(state, flat, "win")
        st, stats = step(name, lambda: fn(local, flat, "win", iters=inp["ba_iters"], lam=inp["ba_lambda"]))
        out[name] = (st.rvecs.cpu(), st.tvecs.cpu(), st.points.cpu(), type(stats)(*(x.cpu() for x in stats)))

    if "halo" in inp["steps"]:
        tiles = par.make_mesh((n,), ("tile",), dev)
        frame = torch.from_numpy(inp["halo_frame"]).to(dev)
        block = par.shard_rows(frame, tiles, "tile")
        h, rows, r = inp["halo"], block.shape[0], tiles.axis("tile").index
        pads = {"edge": "replicate", "reflect": "reflect", "constant": "constant"}
        out["halo equal"] = {}
        for mode, pad in pads.items():
            got = step(f"halo {mode}", lambda: par.halo_exchange_rows(block, h, tiles, "tile", mode))
            padded = torch.nn.functional.pad(frame[None, None], (0, 0, h, h), mode=pad)[0, 0]
            out["halo equal"][mode] = bool(torch.equal(got, padded[r * rows : r * rows + rows + 2 * h]))
        out["halo bytes per exchange"] = 2 * h * block[0].numel() * block.element_size()
        mag = torch.linalg.vector_norm(out["tiled exact"].to(dev), dim=-1)
        out["q99"] = float(par.psum_histogram_quantile(mag, 99.0, grid, "tile", 0.0, 64.0))

    if "batch" in inp["steps"]:
        specs = inp["batch"]

        def reader(path):
            i = int(path[len("stream"):])
            return ClipReader(make_clip(dev, H, W, specs[i][0], seed=i, zoom=specs[i][1]).cpu().numpy())

        cfg = BatchRunnerConfig(videos=[f"stream{i}" for i in range(len(specs))], n_devices=n, device=str(dev),
                                lk=LKParams(grid_step=30, compute_err=False), open_reader=reader)
        dist.barrier()
        _zero_launch_counts()
        out["run_batch"] = run_batch(cfg)
        out["launches"]["run_batch"] = _launch_counts()

    if "dryrun" in inp["steps"]:
        dry_mesh = entry._dryrun_mesh(dev, n)
        run = lambda: entry._dryrun_flow(dry_mesh, np.random.RandomState(0))  # noqa: E731
        out["plain equal"]["dryrun flow"] = equal(run(), plain(run))
    return out


def hist_quantile(x: torch.Tensor, q: float, lo: float, hi: float, bins: int = 4096) -> torch.Tensor:
    """The centre of the first of `bins` bins over [lo, hi] whose
    cumulative count reaches q% of the values: psum_histogram_quantile in
    one process."""
    xc = torch.clamp(x.reshape(-1).to(torch.float32), lo, hi)
    idx = torch.clamp(((xc - lo) / (hi - lo) * bins).to(torch.int64), 0, bins - 1)
    cdf = torch.cumsum(torch.bincount(idx, minlength=bins), 0)
    target = q / 100.0 * cdf[-1].to(torch.float32)
    i = int(torch.clamp(torch.searchsorted(cdf.to(torch.float32), target[None]), 0, bins - 1)[0])
    return lo + (i + 0.5) * (hi - lo) / bins


def _max_epe(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(a.double() - b.double(), dim=-1).max())


def _ba_within(got, want, observed: torch.Tensor) -> tuple[bool, str]:
    """tests/test_pose_ba.py's bounds: rvecs and tvecs 1e-4, points 1e-3
    (the observed landmarks; a landmark no keyframe sees keeps the DLT's
    degenerate ~1e9 value, held to 1e-5 relative), cost 1e-3 relative,
    n_obs equal."""
    (rv, tv, pts, st), (rv_w, tv_w, pts_w, st_w) = got, want
    d_rv = float((rv - rv_w).abs().max())
    d_tv = float((tv - tv_w).abs().max())
    d_pts = float((pts - pts_w)[observed].abs().max())
    rel_unobs = float(((pts - pts_w)[~observed].abs() / pts_w[~observed].abs().clamp(min=1.0)).max()) \
        if bool((~observed).any()) else 0.0
    d_cost = abs(float(st.cost) - float(st_w.cost)) / max(float(st_w.cost), 1.0)
    ok = (d_rv <= 1e-4 and d_tv <= 1e-4 and d_pts <= 1e-3 and rel_unobs <= 1e-5 and d_cost <= 1e-3
          and int(st.n_obs) == int(st_w.n_obs))
    return ok, (f"|d rvecs| {d_rv:.3g}, |d tvecs| {d_tv:.3g}, |d points| {d_pts:.3g} (unobserved rel "
                f"{rel_unobs:.3g}), cost rel {d_cost:.3g}, n_obs {int(st.n_obs)} / {int(st_w.n_obs)}")


def parallel_phases(dev, batch_counts: list, batch_fps: float) -> dict:
    """Phases 22 and 23: the multi-rank layer (parallel/) on the GPU.

    22: a world of MESH_RANKS gloo ranks, each on cuda:0 (mesh_rank, steps
    (a)-(e)): (a) two 720p zoom streams tiled (2, 2), 360-row tiles with
    derive_halo's 142 rows (644-row slabs), "exact" and "pallas", against
    each stream's single-rank farneback over the core rows (at least the
    halo from the frame's top and bottom): max EPE <= TOL_TILE_EPE_PX,
    bit-identity printed; (b) four 1080p zoom streams, one a rank, equal
    (torch.equal) to each stream's lk_grid_flow at the production and the
    exact LKParams; (c) both BAs on ba_window_state() (256 landmarks, 64 a
    rank; 4 keyframes, one a rank) within tests/test_pose_ba.py's bounds
    of bundle_adjust, the replicated poses identical on every rank; (d)
    halo_exchange_rows of a 1080p frame in every mode equal to the padded
    frame's rows, the q99 histogram quantile of each rank equal to one
    process's over its stream's assembled flow; (e) run_batch(n_devices=4) on phase 21's four streams, counts
    equal to phase 21's; (f) dryrun_multichip(4)'s flow paths on the
    world's ranks. (a), (b) and (f) are held, rank by rank, against a
    rerun through the kernels' plain versions (torch.equal). Then
    dryrun_multichip(4, backend="gloo").
    Each step's wall time beside the single-rank time of the same work.
    23: a world of one NCCL rank, steps (a)-(c) on 1 x 1 and (1,) meshes,
    every collective a real NCCL call and the halo's ring a
    self-permutation: (b) and the distributed BA identical to the
    single-device functions, (a) and the ring BA as in 22."""
    from hackathonopticalflow_tpu_torch import parallel as par
    from hackathonopticalflow_tpu_torch.core import FarnebackParams, LKParams, measurement_grid
    from hackathonopticalflow_tpu_torch.entry import dryrun_multichip
    from hackathonopticalflow_tpu_torch.flow.dense import farneback_flow
    from hackathonopticalflow_tpu_torch.flow.lk_grid import lk_grid_flow
    from hackathonopticalflow_tpu_torch.nav.ba import bundle_adjust

    halo = par.derive_halo(FarnebackParams())
    dense = [make_clip(dev, DENSE_H, DENSE_W, 2, DENSE_CELL, seed=s) for s in TILE_SEEDS]
    dense_prev, dense_next = torch.stack([c[0] for c in dense]), torch.stack([c[1] for c in dense])
    sparse = [make_clip(dev, H, W, 2, seed=i, zoom=z) for i, z in enumerate(BATCH_ZOOMS)]
    sparse_prev, sparse_next = torch.stack([c[0] for c in sparse]), torch.stack([c[1] for c in sparse])
    pts_np = measurement_grid(H, W, 30)
    pts = torch.from_numpy(pts_np).to(dev)
    state, cfg = ba_window_state(dev)
    observed = state.mask.any(0).cpu()
    inp = {
        "dense": (dense_prev.cpu().numpy(), dense_next.cpu().numpy()),
        "halo": halo,
        "sparse": (sparse_prev.cpu().numpy(), sparse_next.cpu().numpy()),
        "pts": pts_np,
        "ba": tuple(x.cpu().numpy() for x in state),
        "ba_iters": cfg.ba_iters,
        "ba_lambda": cfg.ba_lambda,
        "halo_frame": sparse[0][0].float().cpu().numpy(),
        "batch": list(zip(BATCH_LENGTHS, BATCH_ZOOMS)),
    }

    # the single-rank references and their times, warmed up first
    single = {}
    single_s = {}

    def timed(name, fn):
        fn()
        single_s[name] = host_seconds(lambda: single.__setitem__(name, fn()))

    lks = {"production": LKParams(grid_step=30, compute_err=False), "exact": LKParams()}
    for mode in ("exact", "pallas"):
        timed(f"tiled {mode}", lambda: farneback_flow(dense_prev, dense_next, FarnebackParams(warp_mode=mode),
                                                      device=dev))
    for name, lk in lks.items():
        timed(f"grid {name}", lambda: lk_grid_flow(sparse_prev, sparse_next, pts, lk=lk, device=dev))
    timed("ba", lambda: bundle_adjust(state, iters=cfg.ba_iters, lam=cfg.ba_lambda))
    per_stream = {name: [lk_grid_flow(sparse_prev[i], sparse_next[i], pts, lk=lk, device=dev)
                         for i in range(len(sparse))] for name, lk in lks.items()}
    ba_single = single["ba"]
    ba_want = (ba_single[0].rvecs.cpu(), ba_single[0].tvecs.cpu(), ba_single[0].points.cpu(),
               type(ba_single[1])(*(x.cpu() for x in ba_single[1])))
    core = slice(halo, DENSE_H - halo)

    def check_world(label, ranks, grid_shape, exact_ba_dist, note):
        """Phase 22 / 23's comparisons of steps (a)-(c), (d)'s quantile and
        every kernel step against its plain rerun."""
        ns, nt = grid_shape
        res = {"max_epe": {}, "bit_identical": {}, "seconds": {}, "single_seconds": {}}
        plain_ok = {k: all(r["plain equal"][k] for r in ranks) for k in ranks[0]["plain equal"]}
        log(f"{label} each rank's kernel steps identical to their rerun through the plain versions (warp_bilinear, "
            f"lk_level, patch_bilinear at the ranks' slab and stream shapes): {plain_ok}")
        if not all(plain_ok.values()):
            raise SystemExit(f"{label}: a kernel disagrees with its plain version on the ranks' inputs")
        for mode in ("exact", "pallas"):
            key = f"tiled {mode}"
            flows = torch.stack([torch.cat([ranks[s * nt + t][key] for t in range(nt)], dim=-3)
                                 for s in range(ns)]).reshape(len(TILE_SEEDS), DENSE_H, DENSE_W, 2)
            want = single[key].cpu()
            epe = _max_epe(flows[:, core], want[:, core])
            same = bool(torch.equal(flows[:, core], want[:, core]))
            res["max_epe"][mode], res["bit_identical"][mode] = epe, same
            # each rank sends two halo-row strips of each frame of the pair
            pair_bytes = 2 * 2 * halo * (len(TILE_SEEDS) // ns) * DENSE_W * dense_prev.element_size()
            log(f"{label} (a) tiled_farneback_multi {mode}, {ns} x {nt} mesh, {DENSE_H // nt}-row tiles, halo "
                f"{halo} ({DENSE_H // nt + 2 * halo}-row slabs, {pair_bytes} halo bytes sent per rank per "
                f"frame pair): core rows "
                f"{halo}-{DENSE_H - halo} max EPE {epe:.3g} px against single-rank farneback "
                f"(<= {TOL_TILE_EPE_PX}); bit-identical {same}; warp_bilinear launches per rank "
                f"{[r['launches'][key]['warp_bilinear'] for r in ranks]}")
            if not epe <= TOL_TILE_EPE_PX:
                raise SystemExit(f"{label}: tiled Farneback ({mode}) disagrees with the single rank")
            if mode == "exact" and "q99" in ranks[0]:
                # (d): psum_histogram_quantile's 4096 bins over [0, 64] of
                # each stream's whole tiled flow, in one process
                mags = [torch.linalg.vector_norm(f.to(dev), dim=-1) for f in flows]
                want_q = [float(hist_quantile(m, 99.0, 0.0, 64.0)) for m in mags]
                got_q = [[ranks[s * nt + t]["q99"] for t in range(nt)] for s in range(ns)]
                exact_q = [float(torch.quantile(m.reshape(-1).double(), 0.99)) for m in mags]
                same_q = all(q == w for qs, w in zip(got_q, want_q) for q in qs)
                log(f"{label} (d) q99 of the tiled flow magnitudes, psum_histogram_quantile over the tile axis per "
                    f"rank {got_q}; one process over each stream's assembled flow {want_q}: equal {same_q} "
                    f"(torch.quantile {exact_q}, bin width {64.0 / 4096})")
                if not same_q:
                    raise SystemExit(f"{label}: the psum histogram quantile disagrees with one process's")
        for name in lks:
            key = f"grid {name}"
            per = len(sparse) // len(ranks)
            same = all(torch.equal(getattr(ranks[i // per][key], f)[i % per], getattr(per_stream[name][i], f).cpu())
                       for i in range(len(sparse)) for f in per_stream[name][i]._fields)
            res["bit_identical"][key] = same
            log(f"{label} (b) stream_batched_grid_flow {name}, {len(sparse)} x {H}p streams, {per} a rank: identical "
                f"to each stream's lk_grid_flow {same}; lk_level / patch_bilinear launches per rank "
                f"{[(r['launches'][key]['lk_level'], r['launches'][key]['patch_bilinear']) for r in ranks]}")
            if not same:
                raise SystemExit(f"{label}: stream-sharded grid flow disagrees with the single stream")
        for name in ("ba_dist", "ba_ring"):
            rv0, tv0 = ranks[0][name][:2]
            replicated = all(torch.equal(r[name][0], rv0) and torch.equal(r[name][1], tv0) for r in ranks)
            pts_all = torch.cat([r[name][2] for r in ranks]) if name == "ba_dist" else ranks[0][name][2]
            got = (rv0, tv0, pts_all, ranks[0][name][3])
            ok, msg = _ba_within(got, ba_want, observed)
            same = all(torch.equal(x, y) for x, y in zip(got[:3], ba_want[:3]))
            res["bit_identical"][name] = same
            log(f"{label} (c) {name} ({state.points.shape[0]} landmarks, {state.rvecs.shape[0]} keyframes over "
                f"{len(ranks)} ranks, {cfg.ba_iters} iterations): cost {float(got[3].initial_cost):.4g} -> "
                f"{float(got[3].cost):.4g}; against bundle_adjust: {msg}; identical {same}; poses identical on "
                f"every rank {replicated}")
            if not ok or not replicated or (exact_ba_dist and name == "ba_dist" and not same):
                raise SystemExit(f"{label}: {name} disagrees with bundle_adjust")
        for key in ("tiled exact", "tiled pallas", "grid production", "grid exact", "ba_dist", "ba_ring"):
            res["seconds"][key] = max(r["seconds"][key] for r in ranks)
            res["single_seconds"][key] = single_s["ba" if key.startswith("ba") else key]
        log(f"{label} wall per step, ms (slowest rank, after a warm-up) / single rank, one process on the same GPU: "
            + ", ".join(f"{k} {res['seconds'][k] * 1e3:.1f} / {res['single_seconds'][k] * 1e3:.1f}"
                        for k in res["seconds"]) + f" ({note})")
        return res

    # ---- 22. four gloo ranks share the GPU ----
    t0 = time.perf_counter()
    ranks4 = par.run_on_mesh(mesh_rank, MESH_RANKS, ({**inp, "n": MESH_RANKS, "tile_mesh": (2, 2),
                                                     "steps": ("halo", "batch", "dryrun")},),
                             device="cuda", backend="gloo", timeout_s=MESH_TIMEOUT_S)
    world_s = time.perf_counter() - t0
    log(f"phase 22: {MESH_RANKS} gloo ranks on cuda:0, world {world_s:.1f} s (spawn, CUDA contexts, steps)")
    r22 = check_world("gloo x4", ranks4, (2, 2), False, SHARED)
    halo_ok = all(all(r["halo equal"].values()) for r in ranks4)
    q99 = [r["q99"] for r in ranks4]
    log(f"gloo x4 (d) halo_exchange_rows of a {H}x{W} float32 frame, {H // MESH_RANKS}-row tiles, halo {halo}: "
        f"equal to the padded frame's rows in every mode {halo_ok}; {ranks4[0]['halo bytes per exchange']} bytes sent "
        f"per rank per exchange (two {halo}-row strips), staged through pinned host memory (gloo); wall per exchange "
        + ", ".join(f"{m} {max(r['seconds'][f'halo {m}'] for r in ranks4) * 1e3:.2f} ms" for m in ("edge", "reflect",
                                                                                                   "constant"))
        + f"; q99 of the tiled flow magnitudes per rank {q99}")
    if not halo_ok:
        raise SystemExit("gloo x4: halo exchange disagrees with the padded frame")
    rb = ranks4[0]["run_batch"]
    same_rb = all(r["run_batch"]["danger_counts"] == batch_counts for r in ranks4)
    rb_launches = sum(r["launches"]["run_batch"]["lk_level"] for r in ranks4)
    log(f"gloo x4 (e) run_batch(n_devices={MESH_RANKS}), streams {list(BATCH_LENGTHS)}: {rb['steps']} steps, "
        f"counts equal to phase 21's n_devices=1 run {same_rb}; lk_level launches per rank "
        f"{[r['launches']['run_batch']['lk_level'] for r in ranks4]}; {rb['aggregate_fps']:.2f} pairs/s "
        f"(phase 21, one process: {batch_fps:.2f}; {SHARED})")
    if not same_rb or rb["devices"] != MESH_RANKS:
        raise SystemExit("run_batch over 4 ranks disagrees with one device")
    t0 = time.perf_counter()
    dry = dryrun_multichip(MESH_RANKS, backend="gloo", timeout_s=MESH_TIMEOUT_S)
    dry_s = time.perf_counter() - t0
    log(f"gloo x4 (f) dryrun_multichip({MESH_RANKS}, backend='gloo'): {dry_s:.1f} s with its world; rank 0 "
        + ", ".join(f"{k} {v:.4g}" for k, v in dry[0].items() if k != "launches")
        + f"; launches per rank {[r['launches'] for r in dry]}")

    # ---- 23. one NCCL rank ----
    t0 = time.perf_counter()
    ranks1 = par.run_on_mesh(mesh_rank, 1, ({**inp, "n": 1, "tile_mesh": (1, 1), "steps": ()},),
                             device="cuda", backend="nccl", timeout_s=MESH_TIMEOUT_S)
    log(f"phase 23: one NCCL rank, world {time.perf_counter() - t0:.1f} s")
    r23 = check_world("nccl x1", ranks1, (1, 1), True,
                      "one rank: the collectives' and the process's overhead, not scaling")

    def launches(ranks, key, kernel):
        return sum(r["launches"][key][kernel] for r in ranks)

    by_path = {
        "lk_level": {"parallel gloo x4": sum(launches(ranks4, k, "lk_level") for k in ("grid production", "grid exact"))
                     + rb_launches,
                     "parallel nccl x1": sum(launches(ranks1, k, "lk_level") for k in ("grid production", "grid exact")),
                     "dryrun gloo x4": sum(r["launches"]["lk_level"] for r in dry)},
        "patch_bilinear": {"parallel gloo x4": launches(ranks4, "grid exact", "patch_bilinear"),
                           "parallel nccl x1": launches(ranks1, "grid exact", "patch_bilinear"),
                           "dryrun gloo x4": sum(r["launches"]["patch_bilinear"] for r in dry)},
        "warp gather": {"parallel gloo x4": launches(ranks4, "tiled exact", "warp_bilinear"),
                        "parallel nccl x1": launches(ranks1, "tiled exact", "warp_bilinear"),
                        "dryrun gloo x4": sum(r["launches"]["warp_bilinear"] for r in dry)},
        "warp slab f32": {"parallel gloo x4": launches(ranks4, "tiled pallas", "warp_bilinear"),
                          "parallel nccl x1": launches(ranks1, "tiled pallas", "warp_bilinear")},
    }
    return {
        "by_path": by_path,
        "record": {"mesh_gloo_x4": {**r22, "world_s": world_s, "run_batch_pairs_per_s": rb["aggregate_fps"],
                                    "dryrun_s": dry_s, "q99": q99[0],
                                    "halo_bytes_per_exchange": ranks4[0]["halo bytes per exchange"]},
                   "mesh_nccl_x1": r23},
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

    names = ["lk_level", "warp_bilinear", "patch_bilinear", "gather_rects", "grid_templates"]
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
                if name in ("lk_level", "patch_bilinear", "grid_templates")}

    def phase(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    clip = make_clip(dev, H, W, N_FRAMES)
    log(f"1080p clip: {tuple(clip.shape)} uint8, zoom {ZOOM}/frame")
    sparse = phase(sparse_phases, dev, clip)
    gt = phase(grid_templates_phase, dev, clip)
    dense_clip = make_clip(dev, DENSE_H, DENSE_W, DENSE_FRAMES, DENSE_CELL)
    floor_ms = launch_floor_ms(dev)
    log(f"launch floor (the least of {FLOOR_REPLAYS} graph replays of a one-element in-place add): "
        f"{floor_ms:.4f} ms")
    dense = phase(dense_phases, dev, dense_clip, floor_ms)
    track = phase(tracker_phases, dev, clip)
    new_lk = phase(new_lk_phases, dev, clip)
    exact_pb = phase(exact_patch_phase, dev, clip)
    gather = phase(gather_rects_phase, dev, clip)
    scans = phase(new_scan_phases, dev, clip)
    app = phase(app_phase, dev, clip, sparse["scan_fps"])
    ego = phase(ego_phase, dev, clip, track.pop("history"))
    track_app = phase(tracker_app_phase, dev, clip, track["tracker_fps"])
    slab = phase(slab_phase, dev, dense_clip, floor_ms)
    modes = phase(dense_modes_phase, dev, dense_clip)
    viewer = phase(dense_viewer_phase, dev, dense_clip, modes["fps"])
    batch = phase(batch_phase, dev, sparse["scan_fps"])
    mesh = phase(parallel_phases, dev, batch.pop("batch_counts"), batch["batch_pairs_per_s"])
    captured = phase(graph_phase, dev, clip, dense_clip)

    foreign = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "hackathonopticalflow_tpu"))
    if foreign:
        raise SystemExit(f"the port loaded jax or the JAX package: {foreign[:5]}")

    # launches_by_path: each path's counted run (its graphs captured in
    # it), as the kernels' wrappers count; executions_by_path: the kernels'
    # runs on the device there, graph replays included (phases 22-23: the
    # ranks' runs after a warm-up run, executions only)
    def add(rec: dict, kernel: str, path: str, runs: Runs) -> None:
        rec["launches_by_path"][path] = runs.launched[kernel]
        rec["executions_by_path"][path] = runs.ran[kernel]

    def total(rec: dict) -> None:
        rec["launches"] = sum(rec["launches_by_path"].values())
        rec["executions"] = sum(rec["executions_by_path"].values())

    odo_runs = ego.pop("odometry_launches")
    track_app_runs = track_app.pop("tracker_app_launches")
    viewer_runs = viewer.pop("dense_viewer_launches")
    batch_runs, batch_exact_runs = batch.pop("batch_launches")
    lk = sparse.pop("kernel")
    lk_track = track.pop("lk_level")
    lk["launches_by_path"]["tracker"] = lk_track.pop("launches")
    lk["executions_by_path"]["tracker"] = lk_track.pop("executions")
    lk["launches_by_path"].update(scans.pop("lk_level_launches"))
    lk["executions_by_path"].update(scans.pop("lk_level_executions"))
    lk["launches_by_path"]["app"] = app.pop("app_launches")
    lk["executions_by_path"]["app"] = app.pop("app_executions")
    for path, runs in (("odometry", odo_runs), ("tracker_app", track_app_runs), ("dense_viewer", viewer_runs),
                       ("batch_runner", batch_runs), ("batch_runner exact", batch_exact_runs)):
        add(lk, "lk_level", path, runs)
    lk["executions_by_path"].update(mesh["by_path"]["lk_level"])
    total(lk)
    lk["max_abs_err"] = max(lk["max_abs_err"], lk_track.pop("max_abs_err"), new_lk.pop("max_abs_err"))
    lk["replaces"] += ", hackathonopticalflow_tpu/ops/lk_pallas2.py:64"
    merge_records(lk, lk_track)
    merge_records(lk, new_lk)
    lk["variants"] = variants["lk_level"]
    pb = track.pop("kernel")
    pb["launches_by_path"]["exact"] = scans.pop("patch_bilinear_launches")["exact"]
    pb["executions_by_path"]["exact"] = scans.pop("patch_bilinear_executions")["exact"]
    for path, runs in (("odometry", odo_runs), ("tracker_app", track_app_runs), ("dense_viewer", viewer_runs),
                       ("batch_runner exact", batch_exact_runs)):
        add(pb, "patch_bilinear", path, runs)
    pb["executions_by_path"].update(mesh["by_path"]["patch_bilinear"])
    total(pb)
    merge_records(pb, exact_pb)
    pb["variants"] = variants["patch_bilinear"]
    batch_kernels = batch.pop("kernels")
    for rec in batch_kernels.values():
        total(rec)
    warp = dense.pop("kernel")
    for m in ("packed", "hybrid"):
        warp["launches_by_path"][f"dense {m}"] = modes["launches"][m]
        warp["executions_by_path"][f"dense {m}"] = modes["executions"][m]
    add(warp, "warp_bilinear", "dense_viewer", viewer_runs)
    warp["executions_by_path"].update(mesh["by_path"]["warp gather"])
    total(warp)
    for variant, mode in (("f32", "pallas"), ("bf16", "pallas_bf16")):
        slab[variant]["launches_by_path"] = {f"dense {mode}": modes["launches"][mode]}
        slab[variant]["executions_by_path"] = {f"dense {mode}": modes["executions"][mode]}
    slab["f32"]["executions_by_path"].update(mesh["by_path"]["warp slab f32"])
    for variant in ("f32", "bf16"):
        total(slab[variant])
    gather["executions_by_path"] = dict(gather["launches_by_path"])
    total(gather)
    add(gt, "grid_templates", "sparse", sparse.pop("grid_templates_runs"))
    for path, runs in (("dense_viewer", viewer_runs), ("batch_runner", batch_runs)):
        add(gt, "grid_templates", path, runs)
    total(gt)
    gt["variants"] = variants["grid_templates"]
    record = {"kernels": [lk, warp, slab["f32"], slab["bf16"], pb, gather, gt, batch_kernels["lk_level"],
                          batch_kernels["patch_bilinear"]], **sparse, **dense, **track, **scans,
              **app, **ego, **track_app, "dense_modes_fps": modes["fps"],
              "dense_modes_median_epe_px": modes["median_epe_px"], **viewer, **batch, **mesh["record"],
              **captured}
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
