"""The benchmark's readers of the port's spans (portbench/harness/spans.py,
portbench/metrics/<name>.py) on hand-made readings: a trace with known
device intervals, a window on the host clock, and spans on the host
clock, which the readers move onto the trace's."""

import pytest

from hackathonopticalflow_tpu_torch.utils import profiling
from hackathonopticalflow_tpu_torch.utils.profiling import Span
from portbench.harness.cell import Reading, Window
from portbench.harness.spec import BENCH_DIR, load_module
from portbench.harness.timeline import Event, Trace

NAMES = ("result_held_ms.live", "host_ms_per_frame.live", "frames_wait.pairs", "prefetch_busy.pairs",
         "chunk_host_ms.pairs", "prep_idle.fields")
T0_NS = 42_000_000_000  # the window's start on the host clock
TRACE_T0_US = 1_000_000.0  # the window's start on the trace's clock: another origin
MAIN, PREFETCH = 11, 12


def read(name, r):
    return load_module(BENCH_DIR / "metrics" / f"{name}.py").read(r)


def at(name, key, start_ms, end_ms, tid=MAIN):
    """A span from start_ms to end_ms after the window's start, host clock."""
    return Span(name, key, tid, T0_NS + int(start_ms * 1e6), T0_NS + int(end_ms * 1e6))


def reading(busy_ms=((0.0, 100.0),), trace=True):
    """A 100-ms window whose device is busy over `busy_ms`."""
    dev = [Event("kernel", TRACE_T0_US + 1e3 * a, TRACE_T0_US + 1e3 * b, 7) for a, b in busy_ms]
    tr = Trace((TRACE_T0_US, TRACE_T0_US + 1e5), dev, []) if trace else None
    win = Window(T0_NS / 1e9, T0_NS / 1e9 + 0.1, answers=10, attempted=10, steps=[])
    return Reading(ctx=None, win=win, trace=tr, setup_s=1.0)


@pytest.fixture
def recorded(monkeypatch):
    """Hands the readers `found` as the port's spans."""
    found = []
    monkeypatch.setattr(profiling, "spans", lambda: list(found))
    return found


def test_result_held_is_the_median_gap_from_dispatch_to_fetch(recorded):
    recorded += [
        # frame 0 was dispatched before the window: it has no gap there
        at("pathfinder.frame.dispatch", 0, -5, -3), at("pathfinder.frame.fetch", 0, 1, 2),
        at("pathfinder.frame.dispatch", 1, 2, 4), at("pathfinder.frame.fetch", 1, 18, 19),
        at("pathfinder.frame.dispatch", 2, 19, 21), at("pathfinder.frame.fetch", 2, 37, 38),
        at("pathfinder.frame.dispatch", 3, 38, 40), at("pathfinder.frame.fetch", 3, 70, 71),
        at("pathfinder.frame.gray", 3, 50, 60),
    ]
    # gaps 14, 16 and 30 ms
    assert read("result_held_ms.live", reading()) == pytest.approx(16.0)


def test_host_ms_per_frame_sums_a_frames_four_stages(recorded):
    stages = ("gray", "dispatch", "fetch", "present")
    for key, durations in ((1, (1, 2, 3, 1)), (2, (2, 2, 2, 2)), (3, (1, 1, 1, 1))):
        t = 20.0 * key
        for stage, d in zip(stages, durations):
            recorded.append(at(f"pathfinder.frame.{stage}", key, t, t + d))
            t += d + 0.5
    # a gray conversion whose frame was never dispatched in the window
    recorded.append(at("pathfinder.frame.gray", 4, 90, 99))
    assert read("host_ms_per_frame.live", reading()) == pytest.approx(7.0)


def test_frames_wait_is_the_union_of_the_queue_waits(recorded):
    recorded += [
        at("prefetch.get", 0, 10, 20), at("prefetch.get", 1, 15, 25),
        # clipped at the window's end; one starting after it is not read
        at("prefetch.get", 2, 95, 110), at("prefetch.get", 3, 101, 150),
        at("prefetch.read", 0, 30, 60, PREFETCH),
    ]
    assert read("frames_wait.pairs", reading()) == pytest.approx(20.0)


def test_prefetch_busy_is_the_union_of_reads_and_conversions(recorded):
    recorded += [
        at("prefetch.read", 0, 0, 10, PREFETCH), at("prefetch.gray", 0, 5, 30, PREFETCH),
        at("prefetch.read", 1, 50, 52, PREFETCH), at("prefetch.get", 0, 0, 90),
    ]
    assert read("prefetch_busy.pairs", reading()) == pytest.approx(32.0)


def test_chunk_host_ms_leaves_the_wait_out(recorded):
    stages = ("fill", "dispatch", "wait", "unpack", "present")
    for key, durations in ((0, (4, 1, 0, 3, 2)), (1, (5, 1, 40, 4, 2)), (2, (4, 1, 1, 4, 2))):
        t = 30.0 * key
        for stage, d in zip(stages, durations):
            recorded.append(at(f"pathfinder.chunk.{stage}", key, t, t + d))
            t += d
    # sums 10, 12 and 11 ms
    assert read("chunk_host_ms.pairs", reading()) == pytest.approx(11.0)


def test_prep_idle_counts_only_idle_time_inside_the_preparation(recorded):
    busy = ((0.0, 20.0), (30.0, 100.0))  # idle from 20 to 30 ms
    recorded += [at("dense.upload", None, 15, 25), at("dense.first_frame", None, 22, 35)]
    assert read("prep_idle.fields", reading(busy)) == pytest.approx(10.0)
    # busy time inside the spans does not count, nor idle time outside them
    recorded[:] = [at("dense.upload", None, 0, 18), at("dense.first_frame", None, 26, 28)]
    assert read("prep_idle.fields", reading(busy)) == pytest.approx(2.0)
    # with the device idle throughout, the spans' union
    assert read("prep_idle.fields", reading(())) == pytest.approx(18.0 + 2.0)


@pytest.mark.parametrize("name", NAMES)
def test_span_readers_find_nothing_without_a_trace_or_spans(recorded, name):
    assert read(name, reading()) is None
    recorded += [at(n, 1, 10 + i, 11 + i) for i, n in enumerate((
        "pathfinder.frame.gray", "pathfinder.frame.dispatch", "pathfinder.frame.fetch", "pathfinder.frame.present",
        "prefetch.get", "prefetch.read", "prefetch.gray", "pathfinder.chunk.fill", "pathfinder.chunk.dispatch",
        "pathfinder.chunk.unpack", "pathfinder.chunk.present", "dense.upload", "dense.first_frame"))]
    assert read(name, reading(trace=False)) is None
    assert read(name, reading((), trace=True)) is not None


# ---- the tracker cell's readers (portbench/metrics/*.tracks.py, *.roofline.py) ----

import json  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import numpy as np  # noqa: E402

from portbench.harness.correlation import Launches, read_launches  # noqa: E402
from portbench.harness.roofline import bound_s, lk_level_work  # noqa: E402
from portbench.harness.tracker_check import Chunk  # noqa: E402
from portbench.harness.tracker_work import patch_work  # noqa: E402

TRACKER_NAMES = ("device_ms_per_pair.tracks", "device_idle.tracks", "prep_idle.tracks", "detect_share.tracks",
                 "lk_level_tracker.roofline", "patch_bilinear.roofline")
with open(BENCH_DIR / "configs" / "tracker-1080p.json") as _f:
    TRACKER_CFG = json.load(_f)


def tracker_reading(busy_ms=((0.0, 100.0),), trace=True, launches=None, kernels=(), steps=1, live=100,
                    ref_stats=None):
    """`reading` with the tracker's context: the configuration, one chunk
    of `steps` steps with `live` slots alive throughout, and `kernels`,
    (name, start_ms, end_ms) device events, besides the busy ones."""
    r = reading(busy_ms, trace)
    if trace:
        r.trace.device += [Event(n, TRACE_T0_US + 1e3 * a, TRACE_T0_US + 1e3 * b, 7) for n, a, b in kernels]
        if launches is not None:
            r.trace.launches = launches
    alive = np.zeros((steps, 256), bool)
    alive[:, :live] = True
    r.win.data = {"chunks": [Chunk(0, alive, np.ones((steps, 256), np.int32))], "kept": {},
                  "start_alive": alive[0], "ref_stats": ref_stats or {}}
    r.ctx = SimpleNamespace(cfg=TRACKER_CFG)
    return r


def test_tracker_device_readers_take_the_union():
    r = tracker_reading(((0.0, 30.0), (20.0, 50.0)))
    assert read("device_idle.tracks", r) == pytest.approx(50.0)
    assert read("device_ms_per_pair.tracks", r) == pytest.approx(50.0 / 10)


def test_tracker_prep_idle_counts_idle_time_inside_the_upload_and_first_frame(recorded):
    busy = ((0.0, 20.0), (30.0, 100.0))  # idle from 20 to 30 ms
    recorded += [at("tracker.upload", None, 15, 25), at("tracker.first_frame", None, 22, 35),
                 at("tracker.step.track", 1, 18, 29)]
    assert read("prep_idle.tracks", tracker_reading(busy)) == pytest.approx(10.0)


def test_detect_share_reads_the_graphs_the_detect_steps_launched(recorded):
    us = lambda ms: TRACE_T0_US + 1e3 * ms  # noqa: E731
    recorded += [at("tracker.step.detect", 5, 5, 20), at("tracker.step.track", 6, 45, 60),
                 at("tracker.step.detect", 10, 92, 99),
                 # a step span before the window, whose launch is not in the trace's window either
                 at("tracker.step.detect", 0, -9, -8)]
    # a step's launch is paired with its span by order, not by time: the
    # second step's launch lies outside its span
    launches = Launches(
        host=[(us(10), us(10.01), 1), (us(70), us(70.01), 2), (us(95), us(95.01), 4), (us(-8.5), us(-8.4), 3)],
        device={1: [(us(20), us(30)), (us(30), us(40))], 2: [(us(60), us(90))], 3: [(us(2), us(4))],
                # ops past the window's end are not read
                4: [(us(96), us(110))]})
    busy = ((2.0, 4.0), (20.0, 40.0), (60.0, 90.0), (96.0, 100.0))
    # graphs 1 and 4, launched by the detect steps: 20 + 4 of 56 busy ms
    assert read("detect_share.tracks", tracker_reading(busy, launches=launches)) == pytest.approx(100 * 24 / 56)
    # without the launches' correlation ids, without step spans, or with
    # another number of launches than steps, nothing
    assert read("detect_share.tracks", tracker_reading(busy)) is None
    fewer = launches._replace(host=launches.host[:2])
    assert read("detect_share.tracks", tracker_reading(busy, launches=fewer)) is None
    recorded[:] = [at("tracker.upload", None, 1, 2)]
    assert read("detect_share.tracks", tracker_reading(busy, launches=launches)) is None


def test_read_launches_keeps_graph_launches_and_the_ops_they_ran(tmp_path):
    events = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch", "ts": 10, "dur": 2, "args": {"correlation": 7}},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": 12, "dur": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 20, "dur": 5, "args": {"correlation": 7}},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": 25, "dur": 1, "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 30, "dur": 1, "args": {"correlation": 8}},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1, "dur": 1, "args": {}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = read_launches(path)
    assert got.host == [(10.0, 12.0, 7)]
    assert got.device == {7: [(20.0, 25.0), (25.0, 26.0)], 8: [(30.0, 31.0)]}


def test_lk_level_tracker_roofline_counts_each_launch_over_every_slot():
    name = "void (anonymous namespace)::lk_level_kernel<4, 2, false, false>(float const*)"
    kernels = [(name, 10.0 + i, 10.0 + i + 0.005) for i in range(6)]  # 6 launches of 5 us
    pad = 26
    planes = [((1080 + 3) // 4 + 2 * pad) * ((1920 + 3) // 4 + 2 * pad),
              (540 + 2 * pad) * (960 + 2 * pad), (1080 + 2 * pad) * (1920 + 2 * pad)]
    # the floor: the 100 live slots past the gate, one iteration each
    floor = sum(bound_s(*lk_level_work(256, 15, 15, 8, p, 100, 100)) for p in planes) / 3
    got = read("lk_level_tracker.roofline", tracker_reading(kernels=kernels))
    assert got == pytest.approx(100.0 * 6 * floor / 30e-6)
    # where the reference replayed the step, its counts
    stats = [{"good": 250, "iterations": 1000}] * 6
    exact = sum(bound_s(*lk_level_work(256, 15, 15, 8, p, 250, 1000)) for p in planes) / 3
    got = read("lk_level_tracker.roofline", tracker_reading(kernels=kernels, ref_stats={(0, 0): stats}))
    assert got == pytest.approx(100.0 * 6 * exact / 30e-6)
    assert 0 < got < 100
    assert read("lk_level_tracker.roofline", tracker_reading()) is None


def test_patch_bilinear_roofline_counts_templates_and_err_windows():
    n_bytes, ops = patch_work(256, 3, 15, 15, 10**9, True)
    assert n_bytes == 256 * 3 * 16 * 16 * 4 + 256 * 8 + 256 * 3 * 225 * 4 and ops == 256 * 3 * 225 * 11 + 12 * 256
    assert patch_work(256, 1, 15, 15, 10**9, False)[1] == 256 * 225 * 7 + 12 * 256
    # the crops never count more than the planes
    assert patch_work(256, 1, 15, 15, 100, False)[0] == 400 + 256 * 8 + 256 * 225 * 4
    kernels = [("void patch_bilinear_kernel<true>(float const*)", 10.0 + i, 10.0 + i + 0.002) for i in range(8)]
    got = read("patch_bilinear.roofline", tracker_reading(kernels=kernels))
    assert 0 < got < 100
    assert read("patch_bilinear.roofline", tracker_reading()) is None


@pytest.mark.parametrize("name", TRACKER_NAMES)
def test_tracker_readers_find_nothing_without_a_trace(recorded, name):
    recorded += [at(n, 1, 10 + i, 11 + i) for i, n in enumerate(
        ("tracker.upload", "tracker.first_frame", "tracker.step.detect", "tracker.step.track"))]
    assert read(name, tracker_reading(trace=False)) is None
