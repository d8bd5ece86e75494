"""The pathfinder viewer application (port of
hackathonopticalflow_tpu/apps/pathfinder.py; the reference's
pathfinder_viewer.py:226-361).

Pipeline per frame pair (device): grid LK flow -> radial normalize ->
robust filter; (host): decode, gray conversion, layer rendering and
compositing, FPS overlay. Supports:

- interactive mode (cv2 GUI) with the reference's keyboard map
  (pathfinder_viewer.py:314-337): space pause, 1 vectors, 2 lamps,
  3 lamps window, 4 filtered vectors, q/esc quit;
- headless mode: render composited frames to an mp4, or run compute-only
  for benchmarking;
- start_frame seek, and checkpoint/resume at chunk boundaries.

The device work is launched without host syncs (the grid path's index
tensors are cached per clip), so it overlaps the host's: `run` consumes
frame t-1's result while frame t's runs, and `run_batched` fetches chunk
i's result while chunk i+1 decodes and runs. Frames and results cross
through pinned host memory with non-blocking copies. Frames come from
`open_reader(video)`: cv2's `VideoReader` by default, or any reader with
height, width, fps, seek(i) and read() (io/prefetch.py). cv2 is needed
only to decode a video file, to write an mp4 and for interactive mode;
headless rendering falls back to viz/draw.py's numpy rasterizer.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch

from ..core import FilterParams, LKParams, NormalizeParams, measurement_grid
from ..flow.device import resolve_device
from ..flow.lk_grid import (
    GridFlowResult,
    lk_grid_flow,
    lk_grid_flow_video,
    pack_grid_result,
    unpack_grid_result,
)
from ..io.prefetch import FramePrefetcher, to_gray
from ..io.video import HAVE_CV2, VideoReader
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.logging import get_logger
from ..viz.draw import add_layers, put_text
from ..viz.layers import _host, draw_grid, draw_grid_vectors, draw_sparse_lamps

log = get_logger("apps.pathfinder")


@dataclasses.dataclass
class PathfinderConfig:
    video: str
    add_sparse_flow: bool = True  # pathfinder_viewer.py:11
    add_sparse_lamps: bool = True  # :12
    show_lamps: bool = False  # :13
    draw_bad_flow: bool = True  # :14
    start_frame: int = 0  # :15
    step: int = 30  # :16
    max_frames: int | None = None
    viewing_angle: float = 155.0  # :47
    viewing_angle_req: float = 60.0  # :48
    lk: LKParams = LKParams()
    norm: NormalizeParams = NormalizeParams()
    filt: FilterParams = FilterParams()
    #: checkpoint/resume: run_batched saves (absolute frame index, previous
    #: gray frame) atomically at chunk boundaries and, on start, resumes
    #: from the file if it exists; the resumed output stream equals the
    #: uninterrupted one
    checkpoint_path: str | None = None
    #: save cadence in frames (rounded up to chunk boundaries)
    checkpoint_every: int = 96
    #: where the flow runs: the GPU unless "cpu" is asked for
    device: str = "cuda"


def _need_cv2(what: str) -> None:
    if not HAVE_CV2:
        raise RuntimeError(f"{what} needs cv2, which is not installed; run headless without out_path")


class PathfinderApp:
    def __init__(self, cfg: PathfinderConfig, open_reader: Callable = VideoReader):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.open_reader = open_reader
        self.reader = open_reader(cfg.video)
        h, w = self.reader.height, self.reader.width
        self.pts = measurement_grid(h, w, cfg.step)
        self._pts_dev = torch.from_numpy(self.pts).to(self.device)
        self._warm: set = set()
        log.info("Video %s (%dx%d) on %s", cfg.video, w, h, self.device)

    def _chunk_fn(self, frames_dev: torch.Tensor) -> torch.Tensor:
        """One chunk's flow, packed into one (pairs, 10 N) tensor."""
        cfg = self.cfg
        res = lk_grid_flow_video(frames_dev, self._pts_dev, cfg.lk, cfg.norm, cfg.filt, device=self.device)
        return pack_grid_result(res)

    def warmup(self, chunk: int) -> None:
        """Builds the kernels and warms the device allocator for chunks of
        `chunk` pairs; run_batched calls it before its clock starts. A
        no-op on the CPU and after the first call for a chunk size."""
        if self.device.type != "cuda" or chunk in self._warm:
            return
        self._chunk_fn(torch.zeros((chunk + 1, self.reader.height, self.reader.width),
                                   dtype=torch.uint8, device=self.device))
        torch.cuda.synchronize(self.device)
        self._warm.add(chunk)

    def _upload(self, frames: np.ndarray) -> torch.Tensor:
        """u8 frames to the device, through pinned memory without blocking
        the host (the caching host allocator keeps the pinned block until
        the copy is done)."""
        t = torch.from_numpy(frames)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def compute_frame(self, prev_gray: np.ndarray, gray: np.ndarray) -> GridFlowResult:
        """Device-side computation for one frame pair; returns without
        waiting for the device."""
        cfg = self.cfg
        return lk_grid_flow(
            self._upload(prev_gray), self._upload(gray), self._pts_dev,
            cfg.lk, cfg.norm, cfg.filt, device=self.device,
        )

    def render_frame(self, img: np.ndarray, res, fps: float | None = None) -> np.ndarray:
        """Host-side layer compositing (pathfinder_viewer.py:292-312); res
        holds tensors or arrays."""
        cfg = self.cfg
        h, w = img.shape[:2]
        layers = [img]
        good = _host(res.good)
        pts_i = _host(res.pts)
        next_i = _host(res.next_pts)
        if cfg.add_sparse_flow:
            layers.append(draw_grid_vectors((h, w), pts_i, next_i, good, cfg.draw_bad_flow))
        if cfg.add_sparse_lamps:
            flow_good = (next_i - pts_i)[good]
            layers.append(draw_sparse_lamps((h, w), flow_good, pts_i[good]))
        out = add_layers(*layers)
        out = add_layers(
            out,
            draw_grid(
                (h, w), 20, colored_cross=True, viewing_angle_rect=True, cross=True,
                grid=False, blinds=True, viewing_angle=cfg.viewing_angle,
                viewing_angle_req=cfg.viewing_angle_req,
            ),
        )
        if fps is not None:
            put_text(out, f"{fps:.2f} FPS", (20, 30))
        return out

    def _writer(self, out_path: str | None):
        if out_path is None:
            return None
        _need_cv2("out_path")
        import cv2

        r = self.reader
        return cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), r.fps or 25.0, (r.width, r.height))

    def run(self, headless: bool = True, out_path: str | None = None, render: bool = True) -> dict:
        """Process the video one frame pair at a time; returns run metrics.
        headless=False opens the interactive cv2 window with the
        reference's keyboard map."""
        cfg = self.cfg
        if not headless:
            _need_cv2("interactive mode")
        reader = self.reader
        if cfg.start_frame:
            reader.seek(cfg.start_frame)
        prev = reader.read()
        if prev is None:
            raise IOError("no first frame")
        prev_gray = to_gray(prev)
        writer = self._writer(out_path)

        n = 0
        danger_counts = []
        t_start = time.time()
        compute_s = 0.0
        # one-frame pipeline: frame t's flow is launched and frame t-1's
        # result consumed while the device works; the fetch of `good` is
        # the only sync. Keyboard toggles act one frame late.
        pending: tuple | None = None  # (frame_bgr, res, t_dispatch)
        stop = False

        def consume(frame, res, t_disp):
            nonlocal compute_s, stop
            good = _host(res.good)  # sync point for this frame
            compute_s += time.time() - t_disp
            danger_counts.append(int(good.sum()))
            if render or writer is not None or not headless:
                host = GridFlowResult(*(_host(a) for a in res))
                fps = len(danger_counts) / max(time.time() - t_start, 1e-9)
                out = self.render_frame(frame, host, fps=fps)
                if writer is not None:
                    writer.write(out)
                if not headless:
                    import cv2

                    if cfg.show_lamps:
                        flow_good = (host.next_pts - host.pts)[good]
                        cv2.imshow("lamps", draw_sparse_lamps((reader.height, reader.width), flow_good,
                                                              host.pts[good]))
                    cv2.imshow("flow", out)
                    if not self._handle_key(cv2.waitKey(1) & 0xFF):
                        stop = True

        while cfg.max_frames is None or n < cfg.max_frames:
            frame = reader.read()
            if frame is None:
                break
            gray = to_gray(frame)
            t0 = time.time()
            res = self.compute_frame(prev_gray, gray)  # no sync
            prev_gray = gray
            n += 1
            if pending is not None:
                consume(*pending)
            pending = (frame, res, t0)
            if stop:
                pending = None
                break
        if pending is not None:
            consume(*pending)
        if writer is not None:
            writer.release()
        return self._stats(danger_counts, time.time() - t_start, compute_s, cfg.start_frame + 1)

    @staticmethod
    def _stats(danger_counts: list, wall: float, compute_s: float, first_pair_frame: int) -> dict:
        n = len(danger_counts)
        return {
            "frames": n,
            "first_pair_frame": first_pair_frame,
            "wall_s": wall,
            "compute_s": compute_s,
            "fps": n / max(wall, 1e-9),
            "compute_fps": n / max(compute_s, 1e-9),
            "mean_danger_points": float(np.mean(danger_counts)) if danger_counts else 0.0,
            "danger_counts": danger_counts,
        }

    def run_batched(self, chunk: int = 24, out_path: str | None = None, render: bool = False) -> dict:
        """Headless chunked pipeline. A background thread decodes and
        gray-converts frames (io/prefetch.py); chunks of `chunk` frame
        pairs go to the device as one uint8 copy through a pinned buffer;
        `lk_grid_flow_video` computes the chunk's LK -> radial normalize ->
        robust filter and `pack_grid_result` packs it into one tensor,
        which comes back with one non-blocking copy into a pinned buffer.
        Two buffers of each kind alternate between chunks, so chunk i's
        result is fetched while chunk i+1 decodes and runs. The tail chunk
        is padded with its last frame (fixed buffer shapes); only its valid
        pairs count. The per-pair outputs equal the one-pair loop's."""
        cfg = self.cfg
        keep_bgr = render or out_path is not None
        h, w = self.reader.height, self.reader.width
        dev = self.device
        cuda = dev.type == "cuda"
        # resume: restore (absolute next-frame index, previous gray); the
        # stream continues as the uninterrupted run's because checkpoints
        # land only on chunk boundaries
        resume_prev = None
        start_abs = cfg.start_frame
        if cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
            saved = load_checkpoint(
                cfg.checkpoint_path,
                {"frame_idx": np.int64(0), "prev_gray": np.zeros((h, w), np.uint8)},
            )
            start_abs = int(saved["frame_idx"])
            resume_prev = np.asarray(saved["prev_gray"], np.uint8)
            log.info("resuming from checkpoint at frame %d", start_abs)
        # max_frames counts decoded frames from cfg.start_frame in the
        # uninterrupted run; a resumed run decodes the remainder
        end_abs = None if cfg.max_frames is None else cfg.start_frame + cfg.max_frames + 1
        n_decode = None if end_abs is None else max(end_abs - start_abs, 0)
        # host buffers, pinned on the GPU so that both copies run without
        # blocking the host
        n_pts = self.pts.shape[0]
        frames_buf = [torch.empty((chunk + 1, h, w), dtype=torch.uint8, pin_memory=cuda) for _ in range(2)]
        results_buf = [torch.empty((chunk, 10 * n_pts), dtype=torch.float32, pin_memory=cuda) for _ in range(2)]
        self.warmup(chunk)  # outside the clock
        writer = self._writer(out_path)
        pts_i = np.trunc(self.pts + 0.5).astype(np.int32)
        pre = FramePrefetcher(cfg.video, start_frame=start_abs, max_frames=n_decode, depth=chunk + 2,
                              keep_bgr=keep_bgr, open_reader=self.open_reader)

        n = 0
        danger_counts = []
        since_save = 0
        compute_s = 0.0
        t_start = time.time()
        # (buffer slot, ready event, bgr frames, valid pairs, last gray, abs
        # index of the frame after the chunk's last pair, dispatch time)
        pending = None
        n_chunks = 0

        def consume(p):
            nonlocal n, since_save, compute_s
            slot, ready, bgrs, count, last_gray, abs_end, t_disp = p
            if ready is not None:
                ready.synchronize()  # this chunk's result is in results_buf[slot]
            compute_s += time.time() - t_disp
            host = unpack_grid_result(results_buf[slot].numpy(), pts_i)
            for i in range(count):
                danger_counts.append(int(host.good[i].sum()))
                n += 1
                if writer is not None or render:
                    one = GridFlowResult(*[a[i] for a in host])
                    out = self.render_frame(bgrs[i], one, fps=n / max(time.time() - t_start, 1e-9))
                    if writer is not None:
                        writer.write(out)
            since_save += count
            if cfg.checkpoint_path and since_save >= cfg.checkpoint_every:
                save_checkpoint(cfg.checkpoint_path, frame_idx=np.int64(abs_end),
                                prev_gray=np.asarray(last_gray, np.uint8))
                since_save = 0

        def dispatch(grays, bgrs, abs_end):
            nonlocal pending, n_chunks
            valid = len(grays) - 1
            if valid < 1:
                return
            # the slot's previous chunk (two chunks back) was consumed before
            # the last dispatch returned, so its copies are done
            slot = n_chunks % 2
            n_chunks += 1
            buf = frames_buf[slot].numpy()
            for i, g in enumerate(grays):
                buf[i] = g
            buf[len(grays):] = grays[-1]  # pad the tail chunk
            t0 = time.time()
            packed = self._chunk_fn(frames_buf[slot].to(dev, non_blocking=True))
            results_buf[slot].copy_(packed, non_blocking=True)
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(dev))
            prev, pending = pending, (slot, ready, bgrs[1:], valid, grays[-1], abs_end, t0)
            if prev is not None:
                consume(prev)

        buf_gray: list = []
        buf_bgr: list = []
        abs_next = start_abs  # absolute index of the next decoded frame
        if resume_prev is not None:
            # the checkpointed previous frame seeds the first pair
            buf_gray.append(resume_prev)
            buf_bgr.append(None)
        try:
            for item in pre:
                bgr, gray = item if keep_bgr else (None, item)
                buf_gray.append(gray)
                buf_bgr.append(bgr)
                abs_next += 1
                if len(buf_gray) == chunk + 1:
                    dispatch(buf_gray, buf_bgr, abs_next)
                    buf_gray, buf_bgr = [buf_gray[-1]], [buf_bgr[-1]]
            if len(buf_gray) > 1:
                dispatch(buf_gray, buf_bgr, abs_next)
            if pending is not None:
                consume(pending)
        finally:
            pre.close()
            if writer is not None:
                writer.release()
        first = start_abs + (0 if resume_prev is not None else 1)
        return self._stats(danger_counts, time.time() - t_start, compute_s, first)

    def _handle_key(self, key: int) -> bool:
        """Reference keyboard map (pathfinder_viewer.py:314-337)."""
        import cv2

        cfg = self.cfg
        if key == ord(" "):
            while True:
                k2 = cv2.waitKey(30) & 0xFF
                if k2 == ord(" "):
                    break
                if k2 in (ord("q"), 27):
                    return False
        if key == ord("1"):
            cfg.add_sparse_flow = not cfg.add_sparse_flow
        if key == ord("2"):
            cfg.add_sparse_lamps = not cfg.add_sparse_lamps
        if key == ord("3"):
            if not cfg.add_sparse_flow:
                cfg.add_sparse_flow = True
            cfg.show_lamps = not cfg.show_lamps
        if key == ord("4"):
            if not cfg.add_sparse_flow:
                cfg.add_sparse_flow = True
            cfg.draw_bad_flow = not cfg.draw_bad_flow
        if key in (ord("q"), 27):
            return False
        return True


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="pathfinder viewer on PyTorch (GPU unless --device cpu)")
    p.add_argument("video")
    p.add_argument("--out", default=None, help="headless render target mp4 (needs cv2)")
    p.add_argument("--start-frame", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--step", type=int, default=30)
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--no-render", action="store_true")
    p.add_argument("--exact", action="store_true",
                   help="the exact LK path (OpenCV-parity golden reference) instead of the grid kernels")
    p.add_argument("--chunk", type=int, default=None,
                   help="headless chunked pipeline: frame pairs per device chunk")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file: resumes from it if present; saves atomically at chunk "
                   "boundaries (chunked pipeline only)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cfg = PathfinderConfig(
        video=args.video,
        start_frame=args.start_frame,
        max_frames=args.max_frames,
        step=args.step,
        checkpoint_path=args.checkpoint,
        lk=LKParams() if args.exact else LKParams(grid_step=args.step, compute_err=False),
        device=args.device,
    )
    app = PathfinderApp(cfg)
    if args.chunk and not args.interactive:
        stats = app.run_batched(chunk=args.chunk, out_path=args.out, render=not args.no_render)
    else:
        stats = app.run(headless=not args.interactive, out_path=args.out, render=not args.no_render)
    stats.pop("danger_counts", None)
    print(stats)


if __name__ == "__main__":
    main()
