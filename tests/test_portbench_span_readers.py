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
