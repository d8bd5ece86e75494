"""Background frame prefetch (port of
hackathonopticalflow_tpu/io/prefetch.py::FramePrefetcher).

The reference's loop decodes a frame, converts it, computes, then shows it,
fully serially (pathfinder_viewer.py:270-358). Here a background thread
decodes and converts each frame to gray into a bounded queue, so decode
overlaps the device's work. The thread touches no CUDA state: it yields
host uint8 arrays, and the consumer moves them to the device. An error in
the reader or the gray conversion ends the thread and is raised in the
consuming thread, after the frames before it. The thread's read and
gray conversion and the consumer's wait on the queue are spans
(utils/profiling.py), keyed by the frame's absolute index.

`batch_frames` decodes a run of frames into one device-resident (count,
H, W) uint8 tensor with a single transfer (the shape the clip scans take).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

import numpy as np
import torch

from . import native_lib
from ..flow.device import resolve_device
from ..ops.color import bgr2gray
from ..ops.image import resize_area
from ..utils.profiling import span
from .video import VideoReader


def to_gray(frame: np.ndarray) -> np.ndarray:
    """(H, W) uint8 gray of an (H, W, 3) uint8 BGR frame, OpenCV-exact:
    the native library when it builds, else ops/color.py's bgr2gray on a
    CPU tensor."""
    if native_lib.available():
        return native_lib.bgr2gray_u8(frame)
    return bgr2gray(torch.from_numpy(np.ascontiguousarray(frame))).numpy()


def upload(frame: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host frame to `device` in its own dtype (uint8 crosses as uint8):
    on CUDA through pinned memory without blocking the host (the caching
    host allocator keeps the pinned block until the copy is done); on the
    CPU the frame's tensor itself."""
    t = torch.from_numpy(frame)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class FramePrefetcher:
    """Background decode -> gray -> bounded queue; iterating yields gray
    (H, W) uint8 arrays, or (bgr, gray) pairs with keep_bgr.

    `open_reader(path)` opens the frame source, `VideoReader` (cv2) by
    default; any object with seek(i) and read() -> (H, W, 3) uint8 BGR frame
    or None serves."""

    def __init__(
        self,
        path: str,
        start_frame: int = 0,
        max_frames: int | None = None,
        depth: int = 4,
        keep_bgr: bool = False,
        open_reader: Callable = VideoReader,
    ):
        self.reader = open_reader(path)
        self.start_frame = start_frame
        if start_frame:
            self.reader.seek(start_frame)
        self.max_frames = max_frames
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.keep_bgr = keep_bgr
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self):
        n = 0
        try:
            while self.max_frames is None or n < self.max_frames:
                key = self.start_frame + n
                with span("prefetch.read", key):
                    frame = self.reader.read()
                if frame is None:
                    break
                with span("prefetch.gray", key):
                    g = to_gray(frame)
                if not self._put((frame, g) if self.keep_bgr else g):
                    return
                n += 1
        except Exception as e:  # handed to the consumer, which raises it
            self._put(e)
        finally:
            # the end marker, always: without it the consumer waits forever
            self._put(None)

    def __iter__(self):
        key = self.start_frame
        while True:
            with span("prefetch.get", key):
                item = self.q.get()
            key += 1
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item

    def close(self) -> None:
        """Stops the decode thread and waits for it."""
        self._stop.set()
        self._thread.join()


def batch_frames(
    path: str,
    start: int,
    count: int,
    resize_hw: tuple[int, int] | None = None,
    device: torch.device | str = "cuda",
    open_reader: Callable = VideoReader,
) -> torch.Tensor:
    """Decode up to `count` consecutive gray frames from frame `start` into
    one (count, H, W) uint8 tensor on `device` (the GPU unless "cpu"),
    moved there with one copy. With resize_hw = (h, w), each frame is
    shrunk there by `ops/image.py::resize_area` (cv2's INTER_AREA), rounded
    half up."""
    dev = resolve_device(device)
    out = []
    reader = open_reader(path)
    try:
        if start:
            reader.seek(start)
        for _ in range(count):
            frame = reader.read()
            if frame is None:
                break
            out.append(to_gray(frame))
    finally:
        reader.release()
    frames = upload(np.stack(out), dev)
    if resize_hw is not None:
        small = resize_area(frames.to(torch.float32), resize_hw[0], resize_hw[1])
        frames = torch.clamp(torch.floor(small + 0.5), 0, 255).to(torch.uint8)
    return frames
