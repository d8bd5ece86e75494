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
tensors are cached per clip). `run` serves latency: it reads frame t's
result as one packed copy, right behind its own graph, and presents it
before it waits for frame t+1. `run_batched` serves throughput: it
fetches chunk i's result while chunk i+1 runs and the prefetch thread
converts chunk i+2 into its pinned buffer. Frames and
results cross through pinned host memory with non-blocking copies.
Frames come from `open_reader(video)`: cv2's `VideoReader` by default,
or any reader with height, width, fps, seek(i) and read()
(io/prefetch.py). cv2 is needed only to decode a video file, to write an
mp4 and for interactive mode; headless rendering falls back to
viz/draw.py's numpy rasterizer.
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
from ..io.prefetch import FramePrefetcher, to_gray, upload
from ..io.video import HAVE_CV2, VideoReader
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.graphs import graphed
from ..utils.logging import get_logger
from ..utils.profiling import span
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


@graphed
def _pair_packed(prev_gray, gray, pts, lk, norm, filt) -> torch.Tensor:
    """One pair's flow (`PathfinderApp.compute_frame`'s) packed into one
    (10 N,) tensor: `run`'s device work, one captured graph on the GPU."""
    return pack_grid_result(lk_grid_flow(prev_gray, gray, pts, lk, norm, filt, device=pts.device))


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
        # one captured graph per chunk size on the GPU, as the JAX app jits
        # one scan per chunk
        self._chunk = graphed(self._chunk_fn)
        self._warm: set = set()
        log.info("Video %s (%dx%d) on %s", cfg.video, w, h, self.device)

    def _chunk_fn(self, frames: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
        """One chunk's flow, packed into one (pairs, 10 N) tensor; frames
        (pairs + 1, H, W) uint8, pts the (N, 2) grid on the device. The
        GPU runs it as a captured graph (`self._chunk`), frames copied
        from their pinned buffer straight into its input."""
        cfg = self.cfg
        res = lk_grid_flow_video(frames, pts, cfg.lk, cfg.norm, cfg.filt, device=self.device)
        return pack_grid_result(res)

    def warmup(self, chunk: int) -> None:
        """Builds the kernels and captures the graph of chunks of `chunk`
        pairs; run_batched calls it before its clock starts. A no-op on
        the CPU and after the first call for a chunk size."""
        if self.device.type != "cuda" or chunk in self._warm:
            return
        self._chunk(torch.zeros((chunk + 1, self.reader.height, self.reader.width),
                                dtype=torch.uint8, device=self.device), self._pts_dev)
        torch.cuda.synchronize(self.device)
        self._warm.add(chunk)

    def compute_frame(self, prev_gray: np.ndarray, gray: np.ndarray) -> GridFlowResult:
        """Device-side computation for one frame pair, one captured graph on
        the GPU (lk_grid_flow's); returns without waiting for the device."""
        cfg = self.cfg
        return lk_grid_flow(
            upload(prev_gray, self.device), upload(gray, self.device), self._pts_dev,
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
        """Process the video one frame pair at a time, latency first;
        returns run metrics. headless=False opens the interactive cv2 window
        with the reference's keyboard map.

        Per frame: gray conversion; the pair's flow and pack as one graph
        (`_pair_packed`), its result copied into one pinned buffer right
        behind it and an event recorded; a wait on that event, the
        launching thread's only sync of the frame; the unpack and the
        present; only then the read of the next frame. So a frame's result
        never waits for the next camera frame, and keyboard toggles act on
        the next frame. The device idles while the host reads and converts
        a frame: to render a file, where no frame waits on a camera,
        `run_batched` is the faster path. `render_frame` gets numpy arrays,
        some of them views of the pinned buffer, valid until it returns."""
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
        dev = self.device
        cuda = dev.type == "cuda"
        # one pinned buffer: frame t is presented before frame t+1 is
        # dispatched, so nothing in flight writes it
        result = torch.empty(10 * self.pts.shape[0], dtype=torch.float32, pin_memory=cuda)
        ready = torch.cuda.Event() if cuda else None
        pts_i = np.trunc(self.pts + 0.5).astype(np.int32)

        n = 0
        danger_counts = []
        t_start = time.time()
        compute_s = 0.0
        shown = render or writer is not None or not headless
        # spans are keyed by the absolute index of the pair's second frame
        while cfg.max_frames is None or n < cfg.max_frames:
            frame = reader.read()
            if frame is None:
                break
            key = cfg.start_frame + n + 1
            with span("pathfinder.frame.gray", key):
                gray = to_gray(frame)
            t0 = time.time()
            with span("pathfinder.frame.dispatch", key):
                packed = _pair_packed(upload(prev_gray, dev), upload(gray, dev), self._pts_dev, cfg.lk, cfg.norm,
                                      cfg.filt)
                result.copy_(packed, non_blocking=True)
                if ready is not None:
                    ready.record(torch.cuda.current_stream(dev))
            prev_gray = gray
            n += 1
            with span("pathfinder.frame.fetch", key):
                if ready is not None:
                    ready.synchronize()  # the frame's only sync
                host = unpack_grid_result(result.numpy(), pts_i)
                compute_s += time.time() - t0
                danger_counts.append(int(host.good.sum()))
            if not shown:
                continue
            with span("pathfinder.frame.present", key):
                fps = len(danger_counts) / max(time.time() - t_start, 1e-9)
                out = self.render_frame(frame, host, fps=fps)
                if writer is not None:
                    writer.write(out)
                if not headless:
                    import cv2

                    if cfg.show_lamps:
                        flow_good = (host.next_pts - host.pts)[host.good]
                        cv2.imshow("lamps", draw_sparse_lamps((reader.height, reader.width), flow_good,
                                                              host.pts[host.good]))
                    cv2.imshow("flow", out)
                    if not self._handle_key(cv2.waitKey(1) & 0xFF):
                        break
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
        """Headless chunked pipeline. A background thread decodes frames
        and converts them to gray straight into the rows of pinned chunk
        buffers (io/prefetch.py), handing over one filled chunk of `chunk`
        frame pairs at a time; each goes to the device as one uint8 copy;
        `lk_grid_flow_video` computes the chunk's LK -> radial normalize ->
        robust filter and `pack_grid_result` packs it into one tensor,
        which comes back with one non-blocking copy into a pinned buffer.
        Chunk i's result is fetched while chunk i+1 runs and chunk i+2 is
        converted: three frame buffers, two result buffers. The tail chunk
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
        # blocking the host. Three frame slots: one the device reads, one
        # waiting for dispatch, one the prefetch thread fills; with two,
        # chunk i could not be filled before chunk i-2's result was in
        n_pts = self.pts.shape[0]
        frames_buf = [torch.empty((chunk + 1, h, w), dtype=torch.uint8, pin_memory=cuda) for _ in range(3)]
        results_buf = [torch.empty((chunk, 10 * n_pts), dtype=torch.float32, pin_memory=cuda) for _ in range(2)]
        self.warmup(chunk)  # outside the clock
        writer = self._writer(out_path)
        pts_i = np.trunc(self.pts + 0.5).astype(np.int32)
        pre = FramePrefetcher(cfg.video, start_frame=start_abs, max_frames=n_decode, keep_bgr=keep_bgr,
                              open_reader=self.open_reader, slots=[b.numpy() for b in frames_buf],
                              first=resume_prev)

        n = 0
        danger_counts = []
        since_save = 0
        compute_s = 0.0
        t_start = time.time()
        # (the prefetcher's Chunk, result buffer, ready event, dispatch
        # time, chunk index: the key of the chunk's spans)
        pending = None
        n_chunks = 0

        def consume(p):
            nonlocal n, since_save, compute_s
            item, res_slot, ready, t_disp, key = p
            if ready is not None:
                with span("pathfinder.chunk.wait", key):
                    ready.synchronize()  # the result is in, so the frames' copy is done
            compute_s += time.time() - t_disp
            with span("pathfinder.chunk.unpack", key):
                host = unpack_grid_result(results_buf[res_slot].numpy(), pts_i)
            with span("pathfinder.chunk.present", key):
                for i in range(item.pairs):
                    danger_counts.append(int(host.good[i].sum()))
                    n += 1
                    if writer is not None or render:
                        one = GridFlowResult(*[a[i] for a in host])
                        out = self.render_frame(item.bgr[i], one, fps=n / max(time.time() - t_start, 1e-9))
                        if writer is not None:
                            writer.write(out)
            since_save += item.pairs
            if cfg.checkpoint_path and since_save >= cfg.checkpoint_every:
                # the chunk's last gray frame, written before its slot goes back
                save_checkpoint(cfg.checkpoint_path, frame_idx=np.int64(item.end),
                                prev_gray=frames_buf[item.slot].numpy()[item.pairs])
                since_save = 0
            pre.release(item.slot)

        try:
            for item in pre:
                # the result buffer's previous chunk (two back) was consumed
                # before the last dispatch returned, so its copy is done
                key = n_chunks
                res_slot = n_chunks % 2
                n_chunks += 1
                t0 = time.time()
                with span("pathfinder.chunk.dispatch", key):
                    packed = self._chunk(frames_buf[item.slot], self._pts_dev)
                    results_buf[res_slot].copy_(packed, non_blocking=True)
                    ready = None
                    if cuda:
                        ready = torch.cuda.Event()
                        ready.record(torch.cuda.current_stream(dev))
                prev, pending = pending, (item, res_slot, ready, t0, key)
                if prev is not None:
                    consume(prev)
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
    # a no-op kept, as in the JAX package, so that old invocations still parse
    p.add_argument("--fast", action="store_true", help=argparse.SUPPRESS)
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
