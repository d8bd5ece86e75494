"""Background frame prefetch (port of
hackathonopticalflow_tpu/io/prefetch.py::FramePrefetcher).

The reference's loop decodes a frame, converts it, computes, then shows it,
fully serially (pathfinder_viewer.py:270-358). Here a background thread
decodes and converts each frame to gray into a bounded queue, so decode
overlaps the device's work. The thread touches no CUDA state: it yields
host uint8 arrays, and the consumer moves them to the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable

import numpy as np
import torch

from . import native_lib
from ..ops.color import bgr2gray
from .video import VideoReader


def to_gray(frame: np.ndarray) -> np.ndarray:
    """(H, W) uint8 gray of an (H, W, 3) uint8 BGR frame, OpenCV-exact:
    the native library when it builds, else ops/color.py's bgr2gray on a
    CPU tensor."""
    if native_lib.available():
        return native_lib.bgr2gray_u8(frame)
    return bgr2gray(torch.from_numpy(np.ascontiguousarray(frame))).numpy()


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
        while self.max_frames is None or n < self.max_frames:
            frame = self.reader.read()
            if frame is None:
                break
            g = to_gray(frame)
            if not self._put((frame, g) if self.keep_bgr else g):
                return
            n += 1
        self._put(None)

    def __iter__(self):
        while True:
            item = self.q.get()
            if item is None:
                return
            yield item

    def close(self) -> None:
        """Stops the decode thread and waits for it."""
        self._stop.set()
        self._thread.join()
