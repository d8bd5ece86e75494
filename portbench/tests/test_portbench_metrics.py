"""The metric readers' arithmetic on made-up windows and traces."""

import numpy as np
import pytest

import portbench_tiny
from portbench.harness.cell import Reading, Window
from portbench.harness.roofline import bound_s, lk_level_work, warp_work
from portbench.harness.spec import load_benchmark, metric_module, resolve_cell
from portbench.harness.timeline import Event, Trace, covered, union

CELL = resolve_cell(portbench_tiny.ROOT, "pathfinder-1080p.live60")


def reading(win=None, trace=None):
    win = win or Window(0.0, 1.0, answers=10, attempted=10, steps=[])
    return Reading(ctx=None, win=win, trace=trace, setup_s=3.0)


def test_latency_p95_is_the_percentile_over_every_frame():
    rng = np.random.default_rng(0)
    lat = rng.uniform(0.015, 0.020, 400)
    lat[::16] = 0.050  # one frame in 16 stalls: 6% of them, spread out
    lat = list(lat)
    r = reading(Window(0.0, 1.0, answers=400, attempted=400, steps=[], latencies_s=lat))
    p95 = metric_module(CELL, "latency_p95_ms").read(r)
    assert p95 == pytest.approx(1e3 * np.percentile(lat, 95))
    # a percentile of chunk medians would hide the slow frames
    chunk_medians = [np.median(lat[i:i + 24]) for i in range(0, 400, 24)]
    assert p95 > 1e3 * np.percentile(chunk_medians, 95) + 5
    assert metric_module(CELL, "latency_p50_ms").read(r) == pytest.approx(1e3 * np.median(lat))


def test_device_idle_takes_the_union_of_intervals():
    # a copy overlapping a kernel: the sum of durations (90) passes the
    # busy time (60); the idle share comes from the union
    dev = [Event("kernel_a", 10, 60, 7), Event("Memcpy HtoD", 20, 50, 8), Event("kernel_b", 90, 100, 7)]
    tr = Trace((0.0, 100.0), dev, [])
    assert union([(10, 60), (20, 50), (90, 100)]) == [(10, 60), (90, 100)]
    assert covered([(10, 60), (20, 50)]) == 50
    idle = metric_module(CELL, "device_idle.pairs").read(reading(trace=tr))
    assert idle == pytest.approx(40.0)
    assert tr.busy_us() == 60
    # intervals outside the window are clipped to it
    assert Trace((50.0, 95.0), dev, []).busy_us() == 15


def test_host_readers_count_the_launching_thread():
    host = [Event("cudaGraphLaunch", 1, 2, 1), Event("cudaGraphLaunch", 3, 4, 1), Event("cudaLaunchKernel", 5, 6, 2),
            Event("cudaStreamSynchronize", 10, 40, 1), Event("cudaEventSynchronize", 30, 60, 1),
            Event("cudaStreamSynchronize", 0, 90, 2)]
    tr = Trace((0.0, 100.0), [Event("k", 0, 10, 7)], host)
    assert tr.main_tid() == 1
    win = Window(0.0, 1.0, answers=3, attempted=3, steps=[])
    assert metric_module(CELL, "host_sync_wait.pairs").read(reading(win, tr)) == pytest.approx(50.0)
    assert metric_module(CELL, "syncs_per_frame.live").read(reading(win, tr)) == pytest.approx(2 / 3)
    assert metric_module(CELL, "launches_per_pair.pairs").read(reading(win, tr)) == pytest.approx(1.0)
    assert metric_module(CELL, "device_ms_per_frame.live").read(reading(win, tr)) == pytest.approx(10e-3 / 3)
    # one idle gap, 10-100: at its midpoint the thread waits on an event
    assert tr.idle_by_host() == {"cudaEventSynchronize": pytest.approx(90)}


def test_readers_find_nothing_without_a_trace():
    for m in load_benchmark(portbench_tiny.ROOT)["per_layer"]:
        assert metric_module(CELL, m["name"]).read(reading()) is None


def test_roofline_counts():
    # one grid level: 2304 points, window 45, crops of margin 20, every
    # point live, 3 iterations a point
    n_bytes, f32, f64 = lk_level_work(2304, 45, 45, 20, 1_000_000_000, 2304, 3 * 2304)
    assert n_bytes == 2304 * 3 * 2025 * 4 + 2304 * 86 * 86 * 4 + 2304 * 26
    assert f32 == 16 * 3 * 2304 * 2025 and f64 == 6 * 2304 * 2025 + 4 * 3 * 2304 * 2025
    # the crops never count more than the level planes
    assert lk_level_work(10, 45, 45, 20, 100, 10, 0)[0] == 10 * 3 * 2025 * 4 + 400 + 260
    b, ops = warp_work(5, 720, 1280, "gather")
    assert b == 48 * 720 * 1280 and ops == 53 * 720 * 1280
    assert bound_s(b, ops) == pytest.approx(b / 3.35e12)
