"""The trajectory-tracker viewer (port of
hackathonopticalflow_tpu/apps/tracker_app.py; the reference's
SparseOF.py:20-92), with the ego-motion step: each frame's relative pose
from the trajectories alive at both ends (essential-matrix RANSAC,
nav/pose.py).

Per frame: decode, gray conversion (io/prefetch.py's to_gray), one pinned
upload; the tracker step on the device, carrying the previous frame's
prepared pyramid; the pose on the device, fetched with its inlier count
in one small copy; drawing only when a writer or a window consumes the
frame. Frames come from `open_reader(video)`: cv2's `VideoReader` by
default, or any reader with height, width, fps, seek(i) and read().
Checkpoint / resume keeps every live trajectory and the poses, so a
resumed run equals an uninterrupted one.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from ..core import TrackerParams
from ..flow.device import resolve_device
from ..flow.tracker import _heads, init_tracker, track_frame
from ..io.prefetch import to_gray, upload
from ..io.video import VideoReader
from ..nav.camera import Pinhole
from ..nav.pose import estimate_relative_pose
from ..ops.lk import prepare_frame
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..viz.draw import put_text
from ..viz.layers import _host, draw_tracks
from .pathfinder import _need_cv2


def _pack_poses(poses: list[dict]) -> dict:
    """The variable-length pose list as a dict of stacked arrays, so the
    checkpoint's structure does not depend on its length."""
    n = len(poses)
    return {
        "frame": np.array([p["frame"] for p in poses], np.int64),
        "R": np.stack([p["R"] for p in poses]).astype(np.float32) if n else np.zeros((0, 3, 3), np.float32),
        "t": np.stack([p["t"] for p in poses]).astype(np.float32) if n else np.zeros((0, 3), np.float32),
        "inliers": np.array([p["inliers"] for p in poses], np.int64),
    }


def _unpack_poses(packed: dict) -> list[dict]:
    frames = np.asarray(packed["frame"])
    return [
        {
            "frame": int(frames[i]),
            "R": np.asarray(packed["R"][i]),
            "t": np.asarray(packed["t"][i]),
            "inliers": int(np.asarray(packed["inliers"][i])),
        }
        for i in range(len(frames))
    ]


@dataclasses.dataclass
class TrackerAppConfig:
    video: str
    params: TrackerParams = TrackerParams()
    start_frame: int = 0
    max_frames: int | None = None
    h_fov_deg: float = 155.0
    estimate_pose: bool = True
    #: checkpoint / resume: saves (frames done, previous gray frame, the
    #: whole tracker state, the poses) atomically every checkpoint_every
    #: frames and resumes from the file if it exists; unlike the
    #: reference's start_frame seek (SparseOF.py:17-18), the resumed run
    #: keeps every live trajectory
    checkpoint_path: str | None = None
    checkpoint_every: int = 50
    #: where the tracker and the pose run: the GPU unless "cpu" is asked for
    device: str = "cuda"


class TrackerApp:
    def __init__(self, cfg: TrackerAppConfig, open_reader: Callable = VideoReader):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.reader = open_reader(cfg.video)
        self.cam = Pinhole.from_fov(self.reader.width, self.reader.height, cfg.h_fov_deg)

    def _pose(self, prev_heads: torch.Tensor, prev_alive: torch.Tensor, heads: torch.Tensor,
              alive: torch.Tensor) -> np.ndarray:
        """[R (9), t (3), inliers, tracks alive at both ends] of the step
        from prev_heads to heads, in one device-to-host copy."""
        valid = alive & prev_alive
        pose = estimate_relative_pose(self.cam.normalize(prev_heads), self.cam.normalize(heads), valid)
        counts = torch.stack([pose.n_inliers, valid.sum()]).to(torch.float32)
        return torch.cat([pose.R.reshape(9), pose.t, counts]).cpu().numpy()

    def run(self, headless: bool = True, out_path: str | None = None) -> dict:
        """Track the video (and estimate each frame's pose); returns frames,
        frames_this_run, fps, final_tracks, final_heads and poses.
        headless=False shows the frames in a cv2 window (q quits)."""
        cfg = self.cfg
        reader = self.reader
        params = cfg.params
        if not headless:
            _need_cv2("interactive mode")
        state = init_tracker(params, self.device)
        prev_gray = None
        n_done = 0  # frames already processed (restored on resume)
        poses: list[dict] = []
        h, w = reader.height, reader.width
        if cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
            saved = load_checkpoint(
                cfg.checkpoint_path,
                {"n_done": np.int64(0), "prev_gray": np.zeros((h, w), np.uint8), "tracker": state,
                 "poses": _pack_poses([])},
            )
            n_done = int(saved["n_done"])
            prev_gray = np.asarray(saved["prev_gray"], np.uint8)
            state = saved["tracker"]._replace(frame_idx=int(saved["tracker"].frame_idx))
            poses = _unpack_poses(saved["poses"])
        reader.seek(cfg.start_frame + n_done)
        writer = None
        if out_path:
            _need_cv2("out_path")
            import cv2

            writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), reader.fps or 25.0, (w, h))
        n = n_done
        done_this_run = 0
        since_save = 0
        t0 = time.time()
        # the previous frame's prepared pyramid stays on the device; a step
        # (track_frame: the frame's pyramid, tracking, detection) is one
        # captured graph on the GPU
        prev_prep = None
        if prev_gray is not None:
            prev_prep = prepare_frame(upload(prev_gray, self.device).to(torch.float32), params.lk)
        heads = _heads(state)
        while cfg.max_frames is None or n < cfg.max_frames:
            frame = reader.read()
            if frame is None:
                break
            gray = to_gray(frame)
            img = upload(gray, self.device)
            if prev_prep is None:
                # the first step seeds detections on (f0, f0)
                prev_prep = prepare_frame(img.to(torch.float32), params.lk)
            prev_heads, prev_alive = heads, state.alive
            state, prev_prep, heads = track_frame(state, prev_prep, img, params)
            prev_gray = gray

            if cfg.estimate_pose and n > 0:
                row = self._pose(prev_heads, prev_alive, heads, state.alive)
                if row[13] >= 8:
                    poses.append({"frame": n, "R": row[:9].reshape(3, 3), "t": row[9:12], "inliers": int(row[12])})

            if writer is not None or not headless:
                out = frame.copy()
                alive = _host(state.alive)
                draw_tracks(out, _host(state.traj), _host(state.length), alive)
                put_text(out, f"track count: {int(alive.sum())}", (20, 50), 1.0)
                put_text(out, f"{(n + 1) / max(time.time() - t0, 1e-9):.2f} FPS", (20, 30))
                if writer is not None:
                    writer.write(out)
                if not headless:
                    import cv2

                    cv2.imshow("Optical Flow", out)
                    if cv2.waitKey(10) & 0xFF == ord("q"):
                        break
            n += 1
            done_this_run += 1
            since_save += 1
            if cfg.checkpoint_path and since_save >= cfg.checkpoint_every:
                save_checkpoint(cfg.checkpoint_path, n_done=np.int64(n), prev_gray=np.asarray(prev_gray, np.uint8),
                                tracker=state, poses=_pack_poses(poses))
                since_save = 0
        if writer is not None:
            writer.release()
        alive = _host(state.alive)
        wall = time.time() - t0
        return {
            "frames": n,
            "frames_this_run": done_this_run,
            "fps": done_this_run / max(wall, 1e-9),
            "final_tracks": int(alive.sum()),
            "final_heads": _host(_heads(state))[alive],
            "poses": poses,
        }


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="trajectory tracker on PyTorch (GPU unless --device cpu)")
    p.add_argument("video")
    p.add_argument("--out", default=None, help="render target mp4 (needs cv2)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cfg = TrackerAppConfig(video=args.video, max_frames=args.max_frames, device=args.device)
    stats = TrackerApp(cfg).run(headless=not args.interactive, out_path=args.out)
    stats.pop("poses", None)
    stats.pop("final_heads", None)
    print(stats)


if __name__ == "__main__":
    main()
