"""Background frame prefetch (port of
hackathonopticalflow_tpu/io/prefetch.py::FramePrefetcher).

The reference's loop decodes a frame, converts it, computes, then shows it,
fully serially (pathfinder_viewer.py:270-358). Here a background thread
decodes each frame and converts it to gray, so decode overlaps the
device's work. The thread touches no CUDA state. Per frame, it yields
host uint8 arrays through a bounded queue. Given slots, (chunk + 1, H, W)
uint8 arrays (views of the consumer's pinned chunk buffers), it converts
each frame straight into its row of a free slot and hands over one item a
chunk; the consumer gives the slot back once the device has read it. An
error in the reader or the gray conversion ends the thread and is raised
in the consuming thread, after the items before it. The thread's reads,
gray conversions and waits for a free slot and the consumer's waits on
the queue are spans (utils/profiling.py): frames keyed by their absolute
index, chunks by their index.

`batch_frames` decodes a run of frames into one device-resident (count,
H, W) uint8 tensor with a single transfer (the shape the clip scans take).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, NamedTuple

import numpy as np
import torch

from . import native_lib
from ..flow.device import resolve_device
from ..ops.color import bgr2gray
from ..ops.image import resize_area
from ..utils.profiling import span
from .video import VideoReader


def to_gray(frame: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """(H, W) uint8 gray of an (H, W, 3) uint8 BGR frame, OpenCV-exact,
    written into `out` when given (an (H, W) uint8 array with packed rows,
    such as one row of a chunk): the native library when it builds, its
    rows in bands over the CPUs the process may use, else ops/color.py's
    bgr2gray on a CPU tensor."""
    if native_lib.available():
        return native_lib.bgr2gray_u8(frame, out=out)
    g = bgr2gray(torch.from_numpy(np.ascontiguousarray(frame))).numpy()
    if out is None:
        return g
    out[...] = g
    return out


def upload(frame: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host frame to `device` in its own dtype (uint8 crosses as uint8):
    on CUDA through pinned memory without blocking the host (the caching
    host allocator keeps the pinned block until the copy is done); on the
    CPU the frame's tensor itself."""
    t = torch.from_numpy(frame)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class Chunk(NamedTuple):
    """A filled slot. Rows 0..pairs of `slots[slot]` hold the chunk's gray
    frames, row 0 the frame before its first pair; the rows after them
    repeat its last frame. `bgr`: the BGR frames of rows 1..pairs with
    keep_bgr, else None. `end`: the absolute index of the frame after the
    chunk."""

    slot: int
    pairs: int
    bgr: list | None
    end: int


class FramePrefetcher:
    """Background decode -> gray. Iterating yields gray (H, W) uint8 arrays,
    or (bgr, gray) pairs with keep_bgr; with `slots`, `Chunk`s.

    `open_reader(path)` opens the frame source, `VideoReader` (cv2) by
    default; any object with seek(i) and read() -> (H, W, 3) uint8 BGR frame
    or None serves. `slots`: (chunk + 1, H, W) uint8 arrays that the thread
    fills, a chunk at a time, after the consumer's `release(slot)` of the
    chunk before in that slot; row 0 of each chunk carries the last row of
    the one before, and `first` (the gray frame before `start_frame`, on a
    resume) that of the first chunk. Slots of one row take a frame each
    and carry nothing (a `Chunk` of 0 pairs: its frame in row 0). A slot is
    never refilled before it is released. Per frame, `depth` items may wait
    in the queue."""

    def __init__(
        self,
        path: str,
        start_frame: int = 0,
        max_frames: int | None = None,
        depth: int = 4,
        keep_bgr: bool = False,
        open_reader: Callable = VideoReader,
        slots: list[np.ndarray] | None = None,
        first: np.ndarray | None = None,
    ):
        self.reader = open_reader(path)
        self.start_frame = start_frame
        if start_frame:
            self.reader.seek(start_frame)
        self.max_frames = max_frames
        self.keep_bgr = keep_bgr
        self.slots = slots
        self._first = first
        self._free: queue.Queue = queue.Queue()
        for i in range(len(slots or ())):
            self._free.put(i)
        self.q: queue.Queue = queue.Queue(maxsize=depth if slots is None else len(slots))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def release(self, slot: int) -> None:
        """Hands back a chunk's slot: the consumer no longer reads it."""
        self._free.put(slot)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _open(self, shape: tuple, key: int):
        """(slot, rows) for the next item: a free slot, waited for; per
        frame, a new one-row array. rows is None once stopped."""
        if self.slots is None:
            return None, np.empty((1, *shape), np.uint8)
        with span("prefetch.slot_wait", key):
            while not self._stop.is_set():
                try:
                    slot = self._free.get(timeout=0.1)
                    return slot, self.slots[slot]
                except queue.Empty:
                    continue
        return None, None

    def _item(self, slot, rows: np.ndarray, filled: int, bgrs: list, n: int):
        if self.slots is None:
            return (bgrs[0], rows[0]) if self.keep_bgr else rows[0]
        pairs = filled - 1
        rows[filled:] = rows[filled - 1]  # a short tail repeats its last frame
        return Chunk(slot, pairs, bgrs[len(bgrs) - pairs :] if self.keep_bgr else None, self.start_frame + n)

    def _run(self):
        # the band count of each conversion counts this thread among those
        # converting at the same time
        with native_lib.converting():
            self._work()

    def _work(self):
        # a chunk's last row is the next one's row 0; a frame's row is its own
        overlap = 0 if self.slots is None or len(self.slots[0]) == 1 else 1
        carry = self._first if overlap else None
        n = 0  # frames read and converted
        key = 0  # items opened
        slot, rows, filled, bgrs = None, None, 0, []
        try:
            while self.max_frames is None or n < self.max_frames:
                fkey = self.start_frame + n
                with span("prefetch.read", fkey):
                    frame = self.reader.read()
                if frame is None:
                    break
                if rows is None:
                    slot, rows = self._open(frame.shape[:2], key)
                    if rows is None:
                        return
                    key += 1
                    filled, bgrs = 0, []
                    if carry is not None:
                        rows[0] = carry
                        filled = 1
                with span("prefetch.gray", fkey):
                    to_gray(frame, out=rows[filled])
                filled += 1
                n += 1
                if self.keep_bgr:
                    bgrs.append(frame)
                if filled == len(rows):
                    if not self._put(self._item(slot, rows, filled, bgrs, n)):
                        return
                    carry = rows[-1] if overlap else None
                    rows = None
            if rows is not None and filled > overlap:
                self._put(self._item(slot, rows, filled, bgrs, n))
        except Exception as e:  # handed to the consumer, which raises it
            self._put(e)
        finally:
            # the end marker, always: without it the consumer waits forever
            self._put(None)

    def __iter__(self):
        key = self.start_frame if self.slots is None else 0
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
