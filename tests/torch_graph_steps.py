"""The port's captured steps with seeded inputs, for tests/test_torch_graphs.py
(their eager forms on the CPU) and tests/test_torch_cuda.py (their graphs
on the GPU). Imports no jax.

STEPS[name](device) gives (the graphed function, its arguments) at
144x256: numpy frames from a seed, prepared where the step takes a
prepared frame, on `device`.
"""

import importlib

import numpy as np
import torch

from chip_smoke import ClipReader
from hackathonopticalflow_tpu_torch.apps import batch_runner as tbr
from hackathonopticalflow_tpu_torch.apps import pathfinder as tpf
from hackathonopticalflow_tpu_torch.apps.pathfinder import PathfinderApp, PathfinderConfig
from hackathonopticalflow_tpu_torch.core import (
    FarnebackParams,
    FeatureParams,
    FilterParams,
    LKParams,
    NormalizeParams,
    TrackerParams,
    measurement_grid,
)
from hackathonopticalflow_tpu_torch.flow import dense as tdense
from hackathonopticalflow_tpu_torch.flow import lk_grid as tgrid
from hackathonopticalflow_tpu_torch.flow import tracker as ttr
from hackathonopticalflow_tpu_torch.ops import lk as tlk

# the package's ops/__init__ re-exports a function named farneback
tfb = importlib.import_module("hackathonopticalflow_tpu_torch.ops.farneback")

H, W = 144, 256
SPARSE = LKParams(grid_step=30, compute_err=False)
TRACKER = TrackerParams(max_tracks=64, features=FeatureParams(max_candidates=256))


def frames(n: int, seed: int = 0, dx: int = 2, dy: int = 1, h: int = H, w: int = W) -> np.ndarray:
    """n u8 frames of a seeded smooth texture drifting by (dx, dy) px a
    frame."""
    rng = np.random.RandomState(seed)
    sm = rng.uniform(0, 255, (h + n * dy + 8, w + n * dx + 8))
    for _ in range(4):
        p = np.pad(sm, 1, mode="reflect")
        sm = 0.25 * p[:-2, 1:-1] + 0.5 * p[1:-1, 1:-1] + 0.25 * p[2:, 1:-1]
        sm = 0.25 * sm[:, :-2] + 0.5 * sm[:, 1:-1] + 0.25 * sm[:, 2:]
    sm = np.clip(np.floor(sm + 0.5), 0, 255).astype(np.uint8)
    return np.stack([sm[t * dy : t * dy + h, t * dx : t * dx + w] for t in range(n)])


def grid(device, h: int = H, w: int = W) -> torch.Tensor:
    return torch.from_numpy(measurement_grid(h, w, SPARSE.grid_step)).float().to(device)


def sparse_step(device):
    f = torch.from_numpy(frames(2)).to(device)
    return tgrid._video_step, (tlk.prepare_frame(f[0], SPARSE).img_p, f[1], grid(device), SPARSE,
                               NormalizeParams(), FilterParams())


def sparse_pair(device, h: int = H, w: int = W):
    f = torch.from_numpy(frames(2, h=h, w=w)).to(device)
    return tgrid._pair_flow, (f[0], f[1], grid(device, h, w), SPARSE, NormalizeParams(), FilterParams())


def chunk(device):
    """The pathfinder app's chunk of 3 pairs, its frames on the host (the
    app hands its pinned buffer to the graph)."""
    clip = frames(4)
    cfg = PathfinderConfig(video="clip", lk=SPARSE, device=str(device))
    app = PathfinderApp(cfg, open_reader=lambda path: ClipReader(clip))
    return app._chunk, (torch.from_numpy(clip), app._pts_dev)


def pathfinder_pair(device):
    """The pathfinder app's pair as `run` dispatches it: the flow and its
    pack."""
    f = torch.from_numpy(frames(2)).to(device)
    return tpf._pair_packed, (f[0], f[1], grid(device), SPARSE, NormalizeParams(), FilterParams())


def batch_step(device):
    f = torch.from_numpy(np.stack([frames(2, seed=s) for s in (0, 1)], 1)).to(device)  # (2, B, H, W)
    return tbr._batch_step, (tlk.prepare_frame(f[0], SPARSE).img_p, f[1], grid(device), SPARSE,
                             NormalizeParams(), FilterParams())


def dense_step(device, mode):
    params = FarnebackParams(warp_mode=mode)
    f = torch.from_numpy(frames(2, dx=1)).to(device)
    return tdense._video_step, (tfb.prepare_frame(f[0], params), f[1], params)


def dense_pair(device, mode):
    f = torch.from_numpy(frames(2, dx=1)).to(device)
    return tdense._pair_flow, (f[0], f[1], FarnebackParams(warp_mode=mode))


def tracker_state(device):
    """A state with live tracks (a seeding step), the previous frame's
    pyramid and the next frame."""
    f = torch.from_numpy(frames(2)).to(device)
    s = ttr.track_step(ttr.init_tracker(TRACKER, device=device), f[0], f[0], TRACKER, device=device)
    return s, tlk.prepare_frame(f[0].float(), TRACKER.lk), f[1]


def tracker_frame(device, detect):
    s, prev, frame = tracker_state(device)
    return ttr._frame_graph, (s.traj, s.length, s.alive, prev, frame, TRACKER, detect)


def tracker_prepared(device, detect):
    s, prev, frame = tracker_state(device)
    cur = tlk.prepare_frame(frame.float(), TRACKER.lk)
    return ttr._step_graph, (s.traj, s.length, s.alive, prev, cur, frame.float(), TRACKER, detect)


STEPS = {
    "sparse step": sparse_step,
    "sparse pair": sparse_pair,
    "pathfinder chunk": chunk,
    "pathfinder pair": pathfinder_pair,
    "batch step B=2": batch_step,
    **{f"dense step {m}": (lambda device, m=m: dense_step(device, m)) for m in tfb.COEF_MODES},
    **{f"dense pair {m}": (lambda device, m=m: dense_pair(device, m)) for m in ("exact", "image", "hybrid")},
    "tracker step detect": lambda device: tracker_frame(device, True),
    "tracker step no detect": lambda device: tracker_frame(device, False),
    "tracker prepared detect": lambda device: tracker_prepared(device, True),
    "tracker prepared no detect": lambda device: tracker_prepared(device, False),
}
