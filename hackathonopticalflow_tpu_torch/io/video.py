"""Host-side video decode (the port's copy of
hackathonopticalflow_tpu/io/video.py).

Frames are decoded on the host (cv2/ffmpeg) into numpy buffers, converted
to gray by the prefetch pipeline (io/prefetch.py) and moved to the device
by the app. This module mirrors the reference's access patterns:
sequential playback (pathfinder_viewer.py:274) and random-access frame
grabs by index (Operations.py:8-33, CAP_PROP_POS_FRAMES seeks).

OpenCV is optional at runtime: it is the decode backend when present and
the golden-test oracle; raw .npy/.npz frame dumps are supported for
cv2-free environments.
"""

from __future__ import annotations

import pathlib
from typing import Iterator, Sequence

import numpy as np

try:  # pragma: no cover - availability depends on the environment
    import cv2

    HAVE_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    HAVE_CV2 = False


class VideoReader:
    """Sequential/seekable frame reader over cv2.VideoCapture."""

    def __init__(self, path: str | pathlib.Path):
        if not HAVE_CV2:
            raise RuntimeError("cv2 is required for video decode")
        self.path = str(path)
        self.cap = cv2.VideoCapture(self.path)
        if not self.cap.isOpened():
            raise FileNotFoundError(self.path)
        self.length = int(self.cap.get(cv2.CAP_PROP_FRAME_COUNT))
        self.fps = self.cap.get(cv2.CAP_PROP_FPS)
        self.width = int(self.cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        self.height = int(self.cap.get(cv2.CAP_PROP_FRAME_HEIGHT))

    def seek(self, frame_idx: int) -> None:
        self.cap.set(cv2.CAP_PROP_POS_FRAMES, frame_idx)

    def read(self) -> np.ndarray | None:
        ok, frame = self.cap.read()
        return frame if ok else None

    def read_gray(self) -> np.ndarray | None:
        frame = self.read()
        if frame is None:
            return None
        return cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)

    def frames(self, start: int = 0, count: int | None = None) -> Iterator[np.ndarray]:
        if start:
            self.seek(start)
        n = 0
        while count is None or n < count:
            frame = self.read()
            if frame is None:
                return
            yield frame
            n += 1

    def release(self) -> None:
        self.cap.release()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()


def read_frames(
    path: str | pathlib.Path, indices: Sequence[int], gray: bool = False
) -> list[np.ndarray]:
    """Random-access frame grab by index list (Operations.py:8-33 analog)."""
    out = []
    with VideoReader(path) as vr:
        for idx in indices:
            vr.seek(idx)
            frame = vr.read_gray() if gray else vr.read()
            if frame is None:
                raise IOError(f"lost frame {idx} of {path}")
            out.append(frame)
    return out


def read_gray_pair(path: str | pathlib.Path, idx: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic consecutive gray frame pair — the kernel-test fixture
    (analog of the reference's frame-pair development workflow)."""
    a, b = read_frames(path, [idx, idx + 1], gray=True)
    return a, b
