"""The port's host layer: the native library (gray conversion, the raw
frame ring, contours) against the JAX package's copy, the frame
prefetcher, and checkpoint round trips."""

from pathlib import Path
from typing import NamedTuple
from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import ClipReader
from hackathonopticalflow_tpu.io import native_lib as jnative
from hackathonopticalflow_tpu_torch.io import native_lib as tnative
from hackathonopticalflow_tpu_torch.io import prefetch as tprefetch
from hackathonopticalflow_tpu_torch.io.prefetch import FramePrefetcher, to_gray
from hackathonopticalflow_tpu_torch.ops.color import bgr2gray
from hackathonopticalflow_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _gray_clip(n=7, h=36, w=52, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w)).astype(np.uint8)


def test_native_library_builds_into_build_dir():
    assert tnative.available()
    so = tnative.library_path()
    assert so.exists() and so.parent == REPO / "build" / "native"
    assert not list((REPO / "hackathonopticalflow_tpu_torch").rglob("*.so"))


@pytest.mark.parametrize("seed", [0, 1])
def test_native_gray_identical(seed):
    """The native conversion equals the JAX package's copy and the port's
    bgr2gray, bit for bit."""
    bgr = np.random.RandomState(seed).randint(0, 256, (37, 53, 3)).astype(np.uint8)
    got = tnative.bgr2gray_u8(bgr)
    assert np.array_equal(got, jnative.bgr2gray_u8(bgr))
    assert np.array_equal(got, bgr2gray(torch.from_numpy(bgr)).numpy())


@pytest.mark.parametrize("n_slots", [1, 4])
def test_raw_frame_ring_in_order_until_eof(tmp_path, n_slots):
    frames = _gray_clip(9)
    path = tmp_path / "clip.raw"
    path.write_bytes(frames.tobytes())
    with tnative.RawFrameRing(str(path), frames.shape[1:], n_slots) as ring:
        got = []
        while (f := ring.next()) is not None:
            got.append(f)
        assert ring.next() is None
    assert len(got) == len(frames)
    assert all(np.array_equal(a, b) for a, b in zip(got, frames))


def test_raw_frame_ring_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        tnative.RawFrameRing(str(tmp_path / "none.raw"), (4, 4))


def test_trace_contours_identical():
    img = np.zeros((40, 60), np.uint8)
    img[5:15, 5:20] = 1
    img[20:35, 30:55] = 1
    img[25:30, 40:45] = 0
    img[2, 50] = 1
    got = tnative.trace_contours(img)
    want = jnative.trace_contours(img)
    assert len(got) == len(want) >= 3
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("keep_bgr", [False, True])
def test_prefetcher_in_order(native, keep_bgr):
    """Frames from start_frame, max_frames of them, gray as to_gray gives
    it, with the native library or without it."""
    clip = _gray_clip(9)
    with mock.patch.object(tprefetch.native_lib, "available", lambda: native):
        pre = FramePrefetcher("clip", start_frame=2, max_frames=5, depth=2, keep_bgr=keep_bgr,
                              open_reader=lambda path: ClipReader(clip))
        items = list(pre)
        pre.close()
    assert len(items) == 5
    for t, item in enumerate(items):
        bgr, gray = item if keep_bgr else (None, item)
        assert gray.dtype == np.uint8 and np.array_equal(gray, clip[2 + t])
        if keep_bgr:
            assert bgr.shape == clip.shape[1:] + (3,) and np.array_equal(to_gray(bgr), gray)


def test_prefetcher_close_stops_early():
    """A consumer that stops before the end stops the decode thread."""
    pre = FramePrefetcher("clip", depth=1, open_reader=lambda path: ClipReader(_gray_clip(20)))
    it = iter(pre)
    next(it)
    pre.close()
    assert not pre._thread.is_alive()


class _Pose(NamedTuple):
    r: torch.Tensor
    t: np.ndarray


def test_checkpoint_round_trip(tmp_path):
    path = str(tmp_path / "ck.npz")
    state = {
        "frame_idx": np.int64(41),
        "prev_gray": _gray_clip(1)[0],
        "track": (_Pose(torch.arange(6, dtype=torch.float32).reshape(2, 3), np.ones(3)), [torch.tensor(True), None]),
    }
    save_checkpoint(path, **state)
    assert not (tmp_path / "ck.npz.tmp.npz").exists()
    zero = {
        "frame_idx": np.int64(0),
        "prev_gray": np.zeros_like(state["prev_gray"]),
        "track": (_Pose(torch.zeros(2, 3), np.zeros(3)), [torch.tensor(False), None]),
        "poses": np.zeros(2),  # not in the file: comes back as the template
    }
    got = load_checkpoint(path, zero)
    assert int(got["frame_idx"]) == 41
    assert np.array_equal(got["prev_gray"], state["prev_gray"])
    pose, (alive, none) = got["track"]
    assert isinstance(pose, _Pose) and torch.equal(pose.r, state["track"][0].r)
    assert np.array_equal(pose.t, np.ones(3)) and bool(alive) and none is None
    assert got["poses"] is zero["poses"]
    with pytest.raises(ValueError, match="structure"):
        load_checkpoint(path, {"track": (torch.zeros(2, 3),)})
