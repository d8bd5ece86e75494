"""Host-side decode, gray conversion and prefetch (ports of
hackathonopticalflow_tpu/io/)."""

from . import native_lib, tools
from .prefetch import FramePrefetcher, batch_frames, to_gray
from .video import HAVE_CV2, VideoReader, read_frames, read_gray_pair

__all__ = [
    "FramePrefetcher", "HAVE_CV2", "VideoReader", "batch_frames", "native_lib", "read_frames",
    "read_gray_pair", "to_gray", "tools",
]
