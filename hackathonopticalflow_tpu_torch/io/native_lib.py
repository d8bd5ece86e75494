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

The gray conversion writes into a destination the caller may give (a row
of a pinned chunk), its rows split in bands over the library's parked
threads; `gray_bands` picks the band count from the frame's rows, the
CPUs the process may run on and the threads converting at the same time.
The bits do not depend on it.
"""

from __future__ import annotations

import contextlib
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
            lib.hof_bgr2gray_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int,
            ]
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


#: the fewest rows a band of the gray conversion takes: a frame too small
#: for two such bands converts on the calling thread alone, since waking a
#: parked pool thread takes about as long as such a band's work (PERF.md §6)
BAND_ROWS = 128


def _cpus() -> int:
    if hasattr(os, "sched_getaffinity"):
        return len(os.sched_getaffinity(0))
    return os.cpu_count() or 1


_converters = 0  # threads inside converting()
_converters_lock = threading.Lock()


@contextlib.contextmanager
def converting():
    """Counts the calling thread, while inside, among the threads that
    convert frames at the same time, each a stream of its own (a frame
    prefetcher's thread): gray_bands shares the CPUs among them."""
    global _converters
    with _converters_lock:
        _converters += 1
    try:
        yield
    finally:
        with _converters_lock:
            _converters -= 1


def gray_bands(rows: int) -> int:
    """Bands for a frame of `rows` rows: the CPUs the process may run on,
    less one for the loop that consumes the frames, shared by the threads
    that convert at the same time (`converting`; a converting thread takes
    a band itself), at least BAND_ROWS rows each; at least one. Under the
    benchmark's four CPUs one converting thread gets three bands: on the
    four CPUs of an H100 machine's host the review ran 508, 820-875 and 940
    pairs/s at one, two and three. Four threads, the fleet's, get one each:
    their bands queued on the one pool of parked threads, polling, took the
    CPUs the consuming loop needed (PERF.md §6)."""
    return max(1, min((_cpus() - 1) // max(_converters, 1), rows // BAND_ROWS))


def bgr2gray_u8(bgr: np.ndarray, out: np.ndarray | None = None, bands: int | None = None) -> np.ndarray:
    """OpenCV-exact BGR->gray on the host (native): (H, W, 3) uint8 to
    (H, W) uint8, written into `out` when given (any array of that shape
    whose rows are packed, such as a row of a (n, H, W) chunk), in `bands`
    row bands (`gray_bands(H)` by default); returns the gray array."""
    lib = _load()
    if bgr.ndim != 3 or bgr.shape[2] != 3:
        raise ValueError(f"a BGR frame is (H, W, 3), not {bgr.shape}")
    if bgr.dtype != np.uint8 or bgr.strides[1:] != (3, 1):
        bgr = np.ascontiguousarray(bgr, dtype=np.uint8)
    h, w = bgr.shape[:2]
    if out is None:
        out = np.empty((h, w), np.uint8)
    elif out.shape != (h, w) or out.dtype != np.uint8 or out.strides[1] != 1 or not out.flags.writeable:
        raise ValueError(f"gray destination must be writeable ({h}, {w}) uint8 with packed rows")
    lib.hof_bgr2gray_u8(bgr.ctypes.data, bgr.strides[0], out.ctypes.data, out.strides[0], h, w,
                        gray_bands(h) if bands is None else bands)
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
