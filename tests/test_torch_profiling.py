"""The port's span recorder (utils/profiling.py) and the spans its host
loops leave, on the CPU: nothing is recorded without a profiler; under
one, spans from any thread are kept and device_trace writes them into its
Chrome trace on the trace's clock; `run`, `run_batched` and
`farneback_flow_video` leave one set of spans a frame or chunk,
`track_video` one a step around its preparation spans, and `run_batch`
one a step keyed by the step's index."""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import ClipReader
from hackathonopticalflow_tpu_torch.apps.batch_runner import BatchRunnerConfig, run_batch
from hackathonopticalflow_tpu_torch.apps.pathfinder import PathfinderApp, PathfinderConfig
from hackathonopticalflow_tpu_torch.core import FeatureParams, LKParams, TrackerParams
from hackathonopticalflow_tpu_torch.flow.dense import farneback_flow_video
from hackathonopticalflow_tpu_torch.flow.tracker import track_video
from hackathonopticalflow_tpu_torch.utils import profiling
from hackathonopticalflow_tpu_torch.utils.profiling import clear_spans, device_trace, span, spans

torch.set_num_threads(1)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _keys(found, name):
    return [s.key for s in found if s.name == name]


def _clip(n_frames: int) -> np.ndarray:
    rng = np.random.default_rng(7)
    return rng.integers(0, 256, (n_frames, 64, 96), dtype=np.uint8)


def test_span_without_a_profiler_is_one_object_and_records_nothing():
    clear_spans()
    first = span("pathfinder.frame.gray", 1)
    assert span("prefetch.get") is first and span("x", "y") is first
    with span("dense.upload"):
        pass
    assert spans() == []


def test_spans_of_two_threads_under_a_profiler():
    clear_spans()
    seen = {}

    def work():
        seen["tid"] = threading.get_native_id()
        with span("prefetch.read", 5):
            time.sleep(0.002)

    with _cpu_profile():
        with span("pathfinder.frame.fetch", 4):
            time.sleep(0.002)
        t = threading.Thread(target=work)
        t.start()
        t.join()
    with span("after", 6):
        pass
    got = spans()
    assert [(s.name, s.key) for s in got] == [("pathfinder.frame.fetch", 4), ("prefetch.read", 5)]
    assert got[0].thread == threading.get_native_id() and got[1].thread == seen["tid"] != got[0].thread
    assert got[0].start_ns < got[0].end_ns <= got[1].start_ns < got[1].end_ns
    assert got[0].end_ns - got[0].start_ns >= 2_000_000
    clear_spans()
    assert spans() == []


def test_device_trace_writes_the_spans_on_the_trace_clock(tmp_path):
    clear_spans()
    with device_trace(str(tmp_path)):
        torch.ones(64).sum()
        time.sleep(0.005)
        with span("dense.upload"):
            time.sleep(0.02)
        time.sleep(0.005)
        torch.zeros(64).sum()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    mine = [e for e in events if e.get("cat") == "span"]
    assert [(e["name"], e["ph"], e["args"]["key"], e["tid"]) for e in mine] == [
        ("dense.upload", "X", None, threading.get_native_id())]
    (anchor,) = [e for e in events if e.get("name") == profiling.ANCHOR]
    before = next(e for e in events if e.get("name") == "aten::ones")
    after = next(e for e in events if e.get("name") == "aten::zeros")
    s = mine[0]
    assert s["pid"] == anchor["pid"] and s["dur"] == pytest.approx(spans()[0].end_ns / 1e3
                                                                    - spans()[0].start_ns / 1e3)
    # the span lies between the ops around it, 5 ms from each, on the
    # trace's clock
    assert anchor["ts"] < before["ts"] < s["ts"] and s["ts"] + s["dur"] < after["ts"]
    assert s["ts"] - before["ts"] > 4e3 and after["ts"] - (s["ts"] + s["dur"]) > 4e3


def test_run_leaves_one_set_of_frame_spans_a_pair():
    clear_spans()
    gray = _clip(4)
    app = PathfinderApp(PathfinderConfig(video="clip", lk=LKParams(grid_step=30, compute_err=False), device="cpu"),
                        open_reader=lambda path: ClipReader(gray))
    with _cpu_profile():
        stats = app.run(headless=True, render=True)
    got = spans()
    assert stats["frames"] == 3
    stages = ["pathfinder.frame.gray", "pathfinder.frame.dispatch", "pathfinder.frame.fetch",
              "pathfinder.frame.present"]
    assert sorted({s.name for s in got}) == sorted(stages)
    for name in stages:
        assert _keys(got, name) == [1, 2, 3], name
    at = {(s.name, s.key): s for s in got}
    for k in (1, 2, 3):
        # latency first: frame k is presented before frame k + 1 is converted
        assert at["pathfinder.frame.gray", k].end_ns <= at["pathfinder.frame.dispatch", k].start_ns
        assert at["pathfinder.frame.dispatch", k].end_ns <= at["pathfinder.frame.fetch", k].start_ns
        assert at["pathfinder.frame.fetch", k].end_ns <= at["pathfinder.frame.present", k].start_ns
        if k < 3:
            assert at["pathfinder.frame.present", k].end_ns <= at["pathfinder.frame.gray", k + 1].start_ns


def test_run_batched_leaves_chunk_and_prefetch_spans():
    clear_spans()
    gray = _clip(6)
    app = PathfinderApp(PathfinderConfig(video="clip", lk=LKParams(grid_step=30, compute_err=False), device="cpu"),
                        open_reader=lambda path: ClipReader(gray))
    with _cpu_profile():
        stats = app.run_batched(chunk=2, render=True)
    got = spans()
    assert stats["frames"] == 5
    # three chunks of 2, 2 and 1 pairs; no event to wait on on the CPU; the
    # prefetch thread fills the chunks, so the main loop has no fill
    for name in ("pathfinder.chunk.dispatch", "pathfinder.chunk.unpack", "pathfinder.chunk.present"):
        assert _keys(got, name) == [0, 1, 2], name
    assert "pathfinder.chunk.fill" not in {s.name for s in got}
    # frames 0-5 read and converted into their rows, and the read that
    # finds the end; the consumer takes the three chunks and the end marker
    assert _keys(got, "prefetch.read") == list(range(7))
    assert _keys(got, "prefetch.gray") == list(range(6))
    assert sorted(_keys(got, "prefetch.get")) == list(range(4))
    # a wait for a free slot, at most one a chunk
    waits = _keys(got, "prefetch.slot_wait")
    assert len(set(waits)) == len(waits) and set(waits) <= {0, 1, 2}
    assert {s.name for s in got} - {"prefetch.slot_wait"} == {
        "pathfinder.chunk.dispatch", "pathfinder.chunk.unpack", "pathfinder.chunk.present", "prefetch.read",
        "prefetch.gray", "prefetch.get"}
    main = threading.get_native_id()
    on_prefetch = ("prefetch.read", "prefetch.gray", "prefetch.slot_wait")
    assert all((s.thread != main) == (s.name in on_prefetch) for s in got)
    at = {(s.name, s.key): s for s in got}
    # a chunk is handed over after its last frame's conversion: frames 2,
    # 4 and 5 end chunks 0, 1 and 2
    for chunk, last in enumerate((2, 4, 5)):
        assert at["prefetch.gray", last].end_ns <= at["prefetch.get", chunk].end_ns


def test_run_batch_leaves_one_set_of_step_spans_a_step():
    """Two streams of 4 and 3 frames with the hook set: three steps, the
    second stream masked in the third. The fill, dispatch and unpack of
    step k are keyed k; the last fill (key 4) finds both streams ended and
    dispatches nothing; no event to wait on on the CPU; a step is unpacked
    one step late, after the next one's dispatch, and the hook is called
    inside its unpack."""
    clear_spans()
    clips = [_clip(4), _clip(3)]
    calls = []

    def hook(stream, pair, res):
        calls.append((stream, pair, time.perf_counter_ns()))

    cfg = BatchRunnerConfig(videos=["0", "1"], lk=LKParams(grid_step=30, compute_err=False), device="cpu",
                            open_reader=lambda v: ClipReader(clips[int(v)]), on_result=hook)
    with _cpu_profile():
        stats = run_batch(cfg)
    got = spans()
    assert stats["steps"] == 3 and [(s, k) for s, k, _ in calls] == [(0, 1), (1, 1), (0, 2), (1, 2), (0, 3)]
    for name in ("batch.step.dispatch", "batch.step.unpack"):
        assert _keys(got, name) == [1, 2, 3], name
    assert _keys(got, "batch.step.fill") == [1, 2, 3, 4]
    names = {s.name for s in got}
    assert "batch.step.wait" not in names and names >= {"prefetch.read", "prefetch.gray", "prefetch.get"}
    main = threading.get_native_id()
    assert all(s.thread == main for s in got if s.name.startswith("batch.step."))
    at = {(s.name, s.key): s for s in got if s.name.startswith("batch.step.")}
    for k in (1, 2, 3):
        assert at["batch.step.fill", k].end_ns <= at["batch.step.dispatch", k].start_ns
        after = at["batch.step.dispatch", k + 1] if k < 3 else at["batch.step.fill", 4]
        assert after.end_ns <= at["batch.step.unpack", k].start_ns
        unpack = at["batch.step.unpack", k]
        assert all(unpack.start_ns <= t <= unpack.end_ns for _, pair, t in calls if pair == k)


def test_farneback_flow_video_leaves_its_preparation_spans():
    clear_spans()
    frames = torch.from_numpy(_clip(3)[:, :32, :48].copy())
    with _cpu_profile():
        flows = farneback_flow_video(frames, device="cpu")
    got = spans()
    assert flows.shape == (2, 32, 48, 2)
    assert [(s.name, s.key) for s in got] == [("dense.upload", None), ("dense.first_frame", None)]
    assert got[0].end_ns <= got[1].start_ns


def _tracker_frames(n_frames: int) -> torch.Tensor:
    """A smooth texture drifting by (+1, +1) px a frame, u8."""
    rng = np.random.default_rng(11)
    lat = rng.uniform(10, 245, (12, 14))
    big = np.kron(lat, np.ones((8, 8)))
    for _ in range(3):
        big = 0.25 * (np.roll(big, 1, 0) + np.roll(big, -1, 0) + np.roll(big, 1, 1) + np.roll(big, -1, 1))
    frames = np.stack([big[t : t + 48, t : t + 64] for t in range(n_frames)])
    return torch.from_numpy(np.floor(frames + 0.5).astype(np.uint8))


TRACKER = TrackerParams(max_tracks=32, features=FeatureParams(max_candidates=64))


def test_track_video_records_its_spans_only_under_a_profiler():
    frames = _tracker_frames(8)
    clear_spans()
    plain_state, plain = track_video(frames, TRACKER, device="cpu")
    assert spans() == []
    with _cpu_profile():
        state, traced = track_video(frames, TRACKER, device="cpu")
    got = spans()
    assert [(s.name, s.key) for s in got[:2]] == [("tracker.upload", None), ("tracker.first_frame", None)]
    # one span a pair, keyed by the frame index before the step; detection
    # at frame indices 0 and 5 (detect_interval 5)
    assert [(s.name, s.key) for s in got[2:]] == [
        ("tracker.step.detect" if k % 5 == 0 else "tracker.step.track", k) for k in range(7)]
    assert all(a.end_ns <= b.start_ns for a, b in zip(got, got[1:]))
    # the history is the same with the profiler and without it
    for a, b in zip(traced, plain):
        assert torch.equal(a, b)
    for a, b in zip(state[:3], plain_state[:3]):
        assert torch.equal(a, b)
    assert int(plain[1][-1].sum()) > 0


def test_track_video_keys_its_steps_by_the_carried_frame_index():
    frames = _tracker_frames(6)
    first, _ = track_video(frames[:3], TRACKER, device="cpu")
    clear_spans()
    with _cpu_profile():
        track_video(frames[2:], TRACKER, state=first, device="cpu")
    # the state arrives at frame index 2: steps 2, 3 and 4, none detecting
    assert [(s.name, s.key) for s in spans()[2:]] == [("tracker.step.track", k) for k in (2, 3, 4)]


def test_spans_from_many_threads_are_all_kept():
    """More threads than cores record at once, with the interpreter
    switching threads as often as it can: no span is lost."""
    clear_spans()
    n_threads, each = 2 * (os.cpu_count() or 1) + 2, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for i in range(each):
                with span("prefetch.read", t * each + i):
                    pass

        with _cpu_profile():
            threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert sorted(s.key for s in spans()) == list(range(n_threads * each))
