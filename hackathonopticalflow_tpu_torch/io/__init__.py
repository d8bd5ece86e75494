"""Host-side decode, gray conversion and prefetch (ports of
hackathonopticalflow_tpu/io/)."""

from . import native_lib
from .prefetch import FramePrefetcher, to_gray
from .video import HAVE_CV2, VideoReader, read_frames, read_gray_pair

__all__ = [
    "FramePrefetcher", "HAVE_CV2", "VideoReader", "native_lib", "read_frames",
    "read_gray_pair", "to_gray",
]
