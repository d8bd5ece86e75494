"""ctypes bindings for the native host runtime (the port's copy of
hackathonopticalflow_tpu/io/native_lib.py over its own io/native/hofio.cpp).

Builds the shared library with g++ -O3 -march=native at first use into
build/native/ at the repository root (a git-ignored directory), under a
name carrying the hash of the source, the flags and the host CPU's
instruction-set flags (a library built for one CPU is never loaded on
another); nothing is built beside the source. -march=native lets g++
vectorize the gray conversion's three-channel loads (PERF.md gives its
time per 1080p frame). All entry points degrade gracefully: callers can
check `available()` and fall back to their own paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "native" / "hofio.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread"]
_lock = threading.Lock()
_lib = None
_build_err: str | None = None


def _cpu_flags() -> bytes:
    """The host CPU's instruction-set flags (Linux), else its name."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return line.encode()
    except OSError:
        pass
    return platform.processor().encode()


def library_path() -> Path:
    """Where the shared library of hofio.cpp is (or will be) built for
    this host."""
    key = _SRC.read_bytes() + " ".join(_FLAGS).encode() + _cpu_flags()
    return BUILD_DIR / f"libhofio-{hashlib.sha1(key).hexdigest()[:12]}.so"


def _load():
    global _lib, _build_err
    with _lock:
        if _lib is not None or _build_err is not None:
            return _lib
        try:
            so = library_path()
            if not so.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = so.with_suffix(f".{os.getpid()}.tmp")
                subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)], check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(str(so))
            lib.hof_bgr2gray_u8.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            lib.hof_u8_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            lib.hof_ring_open.restype = ctypes.c_void_p
            lib.hof_ring_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int]
            lib.hof_ring_next.restype = ctypes.c_int
            lib.hof_ring_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            lib.hof_ring_close.argtypes = [ctypes.c_void_p]
            lib.hof_trace_contours.restype = ctypes.c_int
            lib.hof_trace_contours.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
            ]
            _lib = lib
        except Exception as e:  # no compiler, or a failed build: callers fall back
            _build_err = str(e)
        return _lib


def available() -> bool:
    return _load() is not None


def bgr2gray_u8(bgr: np.ndarray) -> np.ndarray:
    """OpenCV-exact BGR->gray on the host (native)."""
    lib = _load()
    bgr = np.ascontiguousarray(bgr, dtype=np.uint8)
    h, w = bgr.shape[:2]
    out = np.empty((h, w), np.uint8)
    lib.hof_bgr2gray_u8(bgr.ctypes.data, out.ctypes.data, h * w)
    return out


class RawFrameRing:
    """Background-threaded raw-frame file reader with an SPSC ring buffer
    (the host side of the decode -> device prefetch pipeline): frames of
    `frame_shape` u8, read in order until the file ends."""

    def __init__(self, path: str, frame_shape: tuple[int, ...], n_slots: int = 4):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native lib unavailable: {_build_err}")
        self._lib = lib
        self.frame_shape = tuple(frame_shape)
        self._bytes = int(np.prod(frame_shape))
        self._h = lib.hof_ring_open(str(path).encode(), self._bytes, n_slots)
        if not self._h:
            raise FileNotFoundError(path)

    def next(self) -> np.ndarray | None:
        out = np.empty(self.frame_shape, np.uint8)
        ok = self._lib.hof_ring_next(self._h, out.ctypes.data)
        return out if ok else None

    def close(self):
        if self._h:
            self._lib.hof_ring_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def trace_contours(
    binary: np.ndarray, max_pts: int = 1 << 20, max_contours: int = 4096
) -> list[np.ndarray]:
    """Outer-border contours of a binary image (native border following,
    the framework's cv2.findContours equivalent, reference
    DenseOF.py:394-399)."""
    lib = _load()
    b = np.ascontiguousarray(binary != 0).astype(np.uint8)
    h, w = b.shape
    xy = np.empty((max_pts, 2), np.int32)
    lens = np.empty(max_contours, np.int32)
    n = lib.hof_trace_contours(
        b.ctypes.data, h, w, xy.ctypes.data, max_pts, lens.ctypes.data, max_contours
    )
    out = []
    off = 0
    for i in range(n):
        out.append(xy[off : off + lens[i]].copy())
        off += lens[i]
    return out
