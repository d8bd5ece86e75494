"""The port's host layer: the native library (gray conversion, the raw
frame ring, contours) against the JAX package's copy, the frame
prefetcher, and checkpoint round trips."""

import sys
import threading
import time
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


def _bgr(h, w, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("bands", [1, 2, 3, 7])
@pytest.mark.parametrize("hw", [(37, 53), (1, 29), (5, 8), (129, 7)])
def test_banded_gray_equals_bgr2gray(bands, hw):
    """The native conversion in any number of row bands, more bands than
    rows included, equals ops/color.py's bgr2gray bit for bit, into a new
    array and into a row of a larger destination whose rows are strided."""
    bgr = _bgr(*hw, seed=bands)
    want = bgr2gray(torch.from_numpy(bgr)).numpy()
    assert np.array_equal(tnative.bgr2gray_u8(bgr, bands=bands), want)
    big = np.full((3, hw[0] + 2, hw[1] + 5), 7, np.uint8)
    dst = big[1, 1 : 1 + hw[0], 2 : 2 + hw[1]]
    assert tnative.bgr2gray_u8(bgr, out=dst, bands=bands) is dst
    assert np.array_equal(dst, want)
    big[1, 1 : 1 + hw[0], 2 : 2 + hw[1]] = 7
    assert (big == 7).all(), "a write outside the destination"


def test_banded_gray_from_several_threads():
    """Twelve threads convert at once through the shared pool, each in 3
    bands, with a short switch interval: every result is its frame's."""
    frames = [_bgr(300, 64, seed=s) for s in range(12)]
    want = [bgr2gray(torch.from_numpy(f)).numpy() for f in frames]
    bad = []

    def convert(i):
        out = np.empty((300, 64), np.uint8)
        for _ in range(40):
            tnative.bgr2gray_u8(frames[i], out=out, bands=3)
            if not np.array_equal(out, want[i]):
                bad.append(i)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=convert, args=(i,), daemon=True) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and bad == []


def test_gray_bands_from_rows_and_cpus():
    """One band a CPU the process may use less one, of BAND_ROWS rows at
    least; one at the least."""
    with mock.patch.object(tnative, "_cpus", lambda: 4):
        rows = (1, 2 * tnative.BAND_ROWS - 1, 2 * tnative.BAND_ROWS, 1080)
        assert [tnative.gray_bands(r) for r in rows] == [1, 1, 2, 3]
    with mock.patch.object(tnative, "_cpus", lambda: 8):
        assert tnative.gray_bands(1080) == min(7, 1080 // tnative.BAND_ROWS)
        assert tnative.gray_bands(tnative.BAND_ROWS - 1) == 1
    with mock.patch.object(tnative, "_cpus", lambda: 1):
        assert tnative.gray_bands(1080) == 1


def test_gray_bands_share_the_cpus_among_converting_threads():
    """The CPUs less the consumer's, shared by the threads converting at
    once; at least one band; a running prefetcher counts as one."""
    with mock.patch.object(tnative, "_cpus", lambda: 4):
        with tnative.converting():
            assert tnative.gray_bands(1080) == 3
            with tnative.converting(), tnative.converting(), tnative.converting():
                assert tnative.gray_bands(1080) == 1
            assert tnative.gray_bands(1080) == 3
    with mock.patch.object(tnative, "_cpus", lambda: 8):
        with tnative.converting(), tnative.converting():
            assert tnative.gray_bands(1080) == 3
    assert tnative._converters == 0
    clip = _gray_clip(30)
    pre, _ = _chunks(clip, 2, n_slots=2)
    next(iter(pre))
    assert tnative._converters == 1
    pre.close()
    assert tnative._converters == 0


def test_bgr2gray_refuses_a_wrong_destination():
    bgr = _bgr(6, 8)
    for out in (np.empty((6, 9), np.uint8), np.empty((6, 8), np.int16), np.empty((6, 16), np.uint8)[:, ::2]):
        with pytest.raises(ValueError):
            tnative.bgr2gray_u8(bgr, out=out)
    with pytest.raises(ValueError):
        tnative.bgr2gray_u8(bgr[..., 0])


@pytest.mark.parametrize("native", [True, False])
def test_to_gray_into_a_row_of_a_chunk(native):
    """to_gray(frame, out=...) fills one row of an (n, H, W) array and
    leaves the other rows alone, with the native library or without it."""
    bgr = _bgr(9, 13)
    chunk = np.full((4, 9, 13), 3, np.uint8)
    with mock.patch.object(tprefetch.native_lib, "available", lambda: native):
        got = to_gray(bgr, out=chunk[2])
    assert got is chunk[2] or np.shares_memory(got, chunk[2])
    assert np.array_equal(chunk[2], bgr2gray(torch.from_numpy(bgr)).numpy())
    assert (chunk[[0, 1, 3]] == 3).all()


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


def test_raw_frame_ring_one_slot_stress(tmp_path):
    """100,000 one-byte frames through one slot: producer and consumer hand
    the slot back and forth at every frame, so a wakeup the ring loses
    leaves one of them asleep. The reader runs in a helper thread so that a
    hang fails the test."""
    n = 100_000
    frames = (np.arange(n) % 251).astype(np.uint8)
    path = tmp_path / "tiny.raw"
    path.write_bytes(frames.tobytes())
    got = []

    def consume():
        with tnative.RawFrameRing(str(path), (1, 1), 1) as ring:
            while (f := ring.next()) is not None:
                got.append(int(f[0, 0]))

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive(), f"the ring stopped after {len(got)} frames"
    assert np.array_equal(np.asarray(got), frames)


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


class _FailingReader(ClipReader):
    """Raises on its 3rd read."""

    def read(self):
        if self.pos == 2:
            raise OSError("decode failed at frame 2")
        return super().read()


def test_prefetcher_raises_reader_error():
    """A reader error reaches the consumer after the frames before it,
    instead of leaving it waiting for frames that never come. The consumer
    runs in a helper thread so that a hang fails the test."""
    got, raised = [], []

    def consume():
        pre = FramePrefetcher("clip", depth=2, open_reader=lambda path: _FailingReader(_gray_clip(9)))
        try:
            for g in pre:
                got.append(g)
        except OSError as e:
            raised.append(e)
        finally:
            pre.close()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "the consumer still waits for frames"
    assert len(got) == 2 and [str(e) for e in raised] == ["decode failed at frame 2"]


def _chunks(clip, chunk, n_slots=3, first=None, start=0, max_frames=None, keep_bgr=False, reader=ClipReader):
    """A chunk-filling prefetcher over `clip` and its slots (of one row
    each with chunk 0)."""
    slots = [np.zeros((chunk + 1,) + clip.shape[1:], np.uint8) for _ in range(n_slots)]
    pre = FramePrefetcher("clip", start_frame=start, max_frames=max_frames, keep_bgr=keep_bgr,
                          open_reader=lambda path: reader(clip), slots=slots, first=first)
    return pre, slots


@pytest.mark.parametrize("keep_bgr", [False, True])
def test_chunk_prefetcher_fills_slot_rows(keep_bgr):
    """Chunks of 3 pairs over 9 frames: rows 1.. are the chunk's frames as
    to_gray gives them, row 0 the previous chunk's last frame, and the
    short tail (2 pairs) repeats its last frame; `end` is the frame after
    the chunk, `bgr` the frames of rows 1.. with keep_bgr."""
    clip = _gray_clip(9)
    pre, slots = _chunks(clip, 3, keep_bgr=keep_bgr)
    seen = []
    for c in pre:
        seen.append((c.pairs, c.end, slots[c.slot].copy(), c.bgr))
        pre.release(c.slot)
    pre.close()
    assert [(p, e) for p, e, _, _ in seen] == [(3, 4), (3, 7), (2, 9)]
    for i, (pairs, end, rows, bgr) in enumerate(seen):
        first = end - pairs - 1
        assert np.array_equal(rows[: pairs + 1], clip[first:end])
        assert (rows[pairs + 1 :] == clip[end - 1]).all()
        if keep_bgr:
            assert len(bgr) == pairs and all(np.array_equal(to_gray(b), clip[first + 1 + k]) for k, b in enumerate(bgr))
        else:
            assert bgr is None


def test_chunk_prefetcher_resumes_from_the_saved_gray():
    """A resumed run's first chunk has the saved gray as row 0 and the
    frames from start_frame after it; max_frames counts decoded frames."""
    clip = _gray_clip(9)
    saved = np.full(clip.shape[1:], 200, np.uint8)
    pre, slots = _chunks(clip, 2, first=saved, start=4, max_frames=3)
    got = []
    for c in pre:
        got.append((c.pairs, c.end, slots[c.slot].copy()))
        pre.release(c.slot)
    pre.close()
    assert [(p, e) for p, e, _ in got] == [(2, 6), (1, 7)]
    assert np.array_equal(got[0][2], np.stack([saved, clip[4], clip[5]]))
    assert np.array_equal(got[1][2], np.stack([clip[5], clip[6], clip[6]]))


def test_one_row_slots_take_a_frame_each_and_carry_nothing():
    """Slots of one row (a stream's row of a frame batch): every frame
    from start_frame into its own slot's row 0, a Chunk of 0 pairs a frame
    with `end` the frame after it, `first` unused; the slots come round in
    the order they are released."""
    clip = _gray_clip(7)
    pre, slots = _chunks(clip, 0, first=np.full(clip.shape[1:], 200, np.uint8), start=2)
    got = []
    for c in pre:
        got.append((c.slot, c.pairs, c.end, slots[c.slot][0].copy()))
        pre.release(c.slot)
    pre.close()
    assert [(slot, p, e) for slot, p, e, _ in got] == [(0, 0, 3), (1, 0, 4), (2, 0, 5), (0, 0, 6), (1, 0, 7)]
    assert all(np.array_equal(rows, clip[e - 1]) for _, _, e, rows in got)


def test_chunk_prefetcher_one_frame_makes_no_chunk():
    pre, _ = _chunks(_gray_clip(1), 2)
    assert list(pre) == []
    pre.close()


def test_chunk_prefetcher_never_refills_a_slot_before_its_release():
    """With two slots and a consumer that holds each chunk's slot a while,
    the thread waits: a slot handed out keeps its rows until released,
    and the thread's waits are `prefetch.slot_wait` spans."""
    clip = _gray_clip(20)
    pre, slots = _chunks(clip, 2, n_slots=2)
    held = []
    for c in pre:
        held.append((c.slot, slots[c.slot].copy()))
        if len(held) == 2:
            time.sleep(0.05)  # the thread has a chunk ready and no free slot
            for slot, rows in held:
                assert np.array_equal(slots[slot], rows), "a slot refilled before its release"
                pre.release(slot)
            held = []
    for slot, _ in held:
        pre.release(slot)
    pre.close()


def test_chunk_prefetcher_raises_reader_error_after_the_chunks_before_it():
    """A reader error inside the second chunk reaches the consumer after
    the first chunk; the consumer runs in a helper thread so that a hang
    fails the test."""
    got, raised = [], []

    class Failing(ClipReader):
        def read(self):
            if self.pos == 5:
                raise OSError("decode failed at frame 5")
            return super().read()

    def consume():
        pre, _ = _chunks(_gray_clip(9), 3, reader=Failing)
        try:
            for c in pre:
                got.append((c.pairs, c.end))
                pre.release(c.slot)
        except OSError as e:
            raised.append(e)
        finally:
            pre.close()

    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive(), "the consumer still waits for chunks"
    assert got == [(3, 4)] and [str(e) for e in raised] == ["decode failed at frame 5"]


def test_chunk_prefetcher_close_mid_run_joins_the_thread():
    """A consumer that stops with every slot held and more frames to come
    stops the thread, which waits for a free slot."""
    pre, _ = _chunks(_gray_clip(30), 2, n_slots=2)
    it = iter(pre)
    next(it)
    next(it)
    time.sleep(0.02)
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
