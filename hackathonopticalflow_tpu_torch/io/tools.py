"""Offline video/image utilities, the framework's Operations.py layer
(port of hackathonopticalflow_tpu/io/tools.py, over the port's ops):

- grab_frames: random-access frame grabs (Operations.py:8-33)
- resize_image: aspect-preserving resize (Operations.py:36-48), through
  the port's INTER_AREA / INTER_LINEAR ops
- transcode: re-encode a video at a scale factor
  (Operations.change_format, Operations.py:231-269)
- compare_blur_threshold: the Gaussian-blur / binarization comparison
  script (Operations.py:51-69), returning the three binarized images
  instead of opening windows
- channel_histograms: per-channel 256-bin histograms and a hue view
  (Operations.color_hsv_division, Operations.py:212-228)
- export_raw_gray: decode a clip to the raw byte stream that the native
  RawFrameRing prefetcher reads

These are host tools: numpy arrays in and out, the arithmetic on CPU
tensors. cv2 is needed only to decode or encode a video file and to open
windows (io/video.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.color import bgr2gray, bgr2hsv
from ..ops.image import gaussian_blur, resize_area, resize_bilinear, threshold_binary
from ..ops.stats import histogram256
from .video import VideoReader, read_frames


def grab_frames(path: str, indices, gray: bool = False) -> list[np.ndarray]:
    return read_frames(path, indices, gray=gray)


class FrameQueue:
    """Bounded ring of recent (frame, frame_index) pairs: the reference's
    frame_queue (DenseOF.py:19,503-508), kept for replay and debug access
    to recent frames. Holds at most maxlen + 1 items, as the JAX
    package's."""

    def __init__(self, maxlen: int = 5):
        self.maxlen = maxlen
        self._items: list[tuple[np.ndarray, int]] = []

    def push(self, frame: np.ndarray, idx: int) -> None:
        if len(self._items) > self.maxlen:
            self._items.pop(0)
        self._items.append((frame, idx))

    def __len__(self) -> int:
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def latest(self, n: int = 1):
        return self._items[-n:]


def resize_image(
    image: np.ndarray, des_w: int = 100, des_h: int | None = None, area: bool = True
) -> np.ndarray:
    """Aspect-preserving resize (Operations.py:36-48 semantics) of an
    (H, W) or (H, W, C) image, rounded half up into its dtype."""
    if des_h is None:
        des_h = int(image.shape[0] * des_w / image.shape[1])
    x = torch.from_numpy(np.ascontiguousarray(image)).to(torch.float32)
    if x.dim() == 3:
        x = torch.movedim(x, -1, 0)
    fn = resize_area if area else resize_bilinear
    out = fn(x, des_h, des_w)
    if out.dim() == 3:
        out = torch.movedim(out, 0, -1)
    return torch.clamp(out + 0.5, 0, 255).numpy().astype(image.dtype)


def transcode(src: str, dst: str, percent: int = 75, fps: float = 15.0) -> int:
    """Re-encode at `percent` scale (Operations.change_format parity: mp4v
    fourcc, fixed output fps). Returns the frame count."""
    import cv2

    with VideoReader(src) as vr:
        w = int(vr.width * percent / 100)
        h = int(vr.height * percent / 100)
        writer = cv2.VideoWriter(dst, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h), True)
        n = 0
        for frame in vr.frames():
            writer.write(resize_image(frame, w, h))
            n += 1
        writer.release()
    return n


def compare_blur_threshold(img_bgr: np.ndarray, thresh: float = 70.0) -> dict:
    """Gray -> {none, 3x3, 7x7} Gaussian blur -> binary threshold
    (Operations.py:51-69)."""
    g = bgr2gray(torch.from_numpy(np.ascontiguousarray(img_bgr))).to(torch.float32)
    out = {}
    for name, k in [("raw", None), ("blur3", 3), ("blur7", 7)]:
        x = g if k is None else gaussian_blur(g, k, 0.0)
        out[name] = threshold_binary(x, thresh).numpy().astype(np.uint8)
    return out


def channel_histograms(img_bgr: np.ndarray) -> dict:
    """Per-HSV-channel histograms and the hue view
    (Operations.color_hsv_division)."""
    hsv = bgr2hsv(torch.from_numpy(np.ascontiguousarray(img_bgr)))
    hists = {name: histogram256(hsv[..., i]).numpy() for i, name in enumerate(["h", "s", "v"])}
    h = hsv[..., 0].numpy()
    hue_view = np.stack([h, h, h], axis=-1).astype(np.uint8)
    return {"hists": hists, "hue_view": hue_view}


def open_images(images, names: str = "Name") -> None:
    """Interactive multi-window display (Operations.open_images,
    Operations.py:72-87): generated window names, Esc or closing the first
    window exits. Needs cv2 and a display; a no-op headless."""
    import cv2

    if not isinstance(images, (list, tuple)):
        images = [images]
    name_list = names.split()
    if len(name_list) != len(images):
        name_list = [name_list[0]] + [f"{name_list[0]}{i}" for i in range(1, len(images))]
    try:
        for name, image in zip(name_list, images):
            cv2.imshow(name, np.asarray(image))
        while cv2.getWindowProperty(name_list[0], cv2.WND_PROP_VISIBLE) >= 1:
            if (0xFF & cv2.waitKey(1)) == 27:
                break
        cv2.destroyAllWindows()
    except cv2.error:  # headless environment
        cv2.destroyAllWindows()


def export_raw_gray(src: str, dst: str, max_frames: int | None = None) -> tuple[int, int, int]:
    """Decode to raw concatenated gray frames (the native prefetcher's
    input format). Returns (n_frames, height, width)."""
    from .prefetch import to_gray

    n = 0
    with VideoReader(src) as vr, open(dst, "wb") as f:
        h, w = vr.height, vr.width
        for frame in vr.frames():
            if max_frames is not None and n >= max_frames:
                break
            f.write(to_gray(frame).tobytes())
            n += 1
    return n, h, w
