"""The benchmark's fleet cell on the CPU, through the port's plain
versions: the configuration is the pathfinder's flow on the traffic's
streams; a tiny run of the cell reads correct; two streams' results
swapped, one stream's results a step late and the control each read
bad; and the cell's span readers (`step_host_ms.fleet`,
`frames_wait.fleet`, `gray_ms.fleet`) on a hand-made reading."""

import copy

import pytest
import torch

from hackathonopticalflow_tpu_torch.apps import batch_runner
from hackathonopticalflow_tpu_torch.utils import profiling
from hackathonopticalflow_tpu_torch.utils.profiling import Span
from portbench.harness.cell import Reading, Window, run_cell
from portbench.harness.spec import BENCH_DIR, load_module, resolve_cell
from portbench.harness.timeline import Event, Trace
from portbench.tests import portbench_tiny

torch.set_num_threads(1)

ROOT = portbench_tiny.ROOT
CELL = "fleet4-1080p.lockstep"
CHECKS = ("bad_pairs", "raw_next_pts_max_px", "modulus_max", "ang_max_rad")


def test_the_configuration_is_the_pathfinders_flow_on_the_traffics_streams():
    fleet = resolve_cell(ROOT, CELL)
    review = resolve_cell(ROOT, "pathfinder-1080p.review")
    for key in ("height", "width", "lk", "normalize", "filter"):
        assert fleet.config[key] == review.config[key], key
    assert fleet.traffic["streams"] == fleet.config["streams"] == 4
    assert fleet.traffic["entry"] == "pathfinder_run_batch" and set(fleet.limits) == set(CHECKS)


def test_a_tiny_run_of_the_cell_is_correct():
    out = portbench_tiny.run_tiny(CELL)
    assert out["correct"], out["checks"]
    assert out["checks"] == {name: {"value": 0.0, "limit": 0.0} for name in CHECKS}
    win = out["_window"]
    pairs = win.data["pairs"]
    assert out["failed"] == 0 and out["attempted"] == win.answers == sum(pairs) and min(pairs) >= 1
    assert [len(r) for r in win.data["results"]] == pairs
    assert win.notes["bad_pairs_by_stream"] == [0, 0, 0, 0]
    # one step a frame index, every stream in each; none before the
    # window's first pair on the CPU (no warm-up step there)
    assert len(win.steps) == max(pairs) == win.notes["steps"] and all(len(s) == 4 for s in win.steps)
    assert set(out["metrics"]) == {"pairs_per_s", "setup_s"}


def _swapped(monkeypatch):
    """The step's packed results of streams 0 and 1 trade places."""
    orig = batch_runner._batch_step

    def swap(*args):
        out, planes = orig(*args)
        return out[[1, 0, 2, 3]], planes

    monkeypatch.setattr(batch_runner, "_batch_step", swap)


def _late(monkeypatch):
    """Stream 2's results come one step late: from the second step on, it
    is handed the step before's."""
    orig = batch_runner._batch_step
    before = {}

    def late(*args):
        out, planes = orig(*args)
        held = out.clone()
        if "out" in before:
            held[2] = before["out"][2]
        before["out"] = out
        return held, planes

    monkeypatch.setattr(batch_runner, "_batch_step", late)


@pytest.mark.parametrize("fault", ["swapped", "late", "control"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    if fault == "swapped":
        _swapped(monkeypatch)
    elif fault == "late":
        _late(monkeypatch)
    out = portbench_tiny.run_tiny(CELL, control=fault == "control")
    assert not out["correct"], out["checks"]
    by_stream = out["_window"].notes["bad_pairs_by_stream"]
    bad = {"swapped": [0, 1], "late": [2], "control": [0, 1, 2, 3]}[fault]
    assert [i for i, n in enumerate(by_stream) if n] == bad, by_stream
    assert out["checks"]["bad_pairs"]["value"] == sum(by_stream)


def test_a_traffic_of_other_streams_fails_set_up_at_once():
    cell = portbench_tiny.tiny_cell(CELL)
    cell.config = copy.deepcopy(cell.config)
    cell.config["streams"] = 3
    with pytest.raises(ValueError, match="states 3"):
        run_cell(ROOT, CELL, portbench_tiny.SEED, 0.2, False, device="cpu", cell=cell)


# ---- the cell's span readers ----

T0_NS = 42_000_000_000  # the window's start on the host clock
TRACE_T0_US = 1_000_000.0  # the window's start on the trace's clock: another origin
MAIN, PREFETCH = 11, 12


def at(name, key, start_ms, end_ms, tid=MAIN):
    return Span(name, key, tid, T0_NS + int(start_ms * 1e6), T0_NS + int(end_ms * 1e6))


def read(name, trace=True):
    """The metric over a 100-ms window whose device is busy throughout."""
    tr = Trace((TRACE_T0_US, TRACE_T0_US + 1e5), [Event("kernel", TRACE_T0_US, TRACE_T0_US + 1e5, 7)], [])
    win = Window(T0_NS / 1e9, T0_NS / 1e9 + 0.1, answers=12, attempted=12, steps=[])
    reading = Reading(ctx=None, win=win, trace=tr if trace else None, setup_s=1.0)
    return load_module(BENCH_DIR / "metrics" / f"{name}.py").read(reading)


@pytest.fixture
def recorded(monkeypatch):
    found = []
    monkeypatch.setattr(profiling, "spans", lambda: list(found))
    return found


def test_step_host_ms_sums_fill_dispatch_and_unpack_and_leaves_the_waits_out(recorded):
    stages = ("fill", "dispatch", "wait", "unpack")
    for key, durations in ((1, (4, 2, 0, 3)), (2, (5, 2, 30, 4)), (3, (4, 1, 1, 3))):
        t = 30.0 * (key - 1)
        for stage, d in zip(stages, durations):
            recorded.append(at(f"batch.step.{stage}", key, t, t + d))
            t += d
    # the queue waits inside a fill are not the loop's work: 1 + 0.5 ms in
    # step 1's fill (0-4 ms), 3 ms in step 2's (30-35 ms); one outside
    # every fill is left alone
    recorded += [at("prefetch.get", 1, 0.5, 1.5), at("prefetch.get", 1, 3.5, 4), at("prefetch.get", 2, 31, 34),
                 at("prefetch.get", 3, 36, 38)]
    # the last fill finds every stream ended and dispatches nothing; a
    # step dispatched before the window is not read
    recorded += [at("batch.step.fill", 4, 95, 96), at("batch.step.dispatch", 0, -5, -3),
                 at("batch.step.unpack", 0, 1, 2)]
    # sums 9 - 1.5, 11 - 3 and 8 ms (without the waits' 9 ms)
    assert read("step_host_ms.fleet") == pytest.approx(8.0)


def test_gray_ms_is_the_median_frame_of_any_stream(recorded):
    # four prefetch threads convert frame 5 at once (1, 2, 4 and 3 ms),
    # one of them frame 6 (6 ms); keys repeat across streams
    recorded += [at("prefetch.gray", 5, 10, 11, 12), at("prefetch.gray", 5, 10, 12, 13),
                 at("prefetch.gray", 5, 10, 14, 14), at("prefetch.gray", 5, 10, 13, 15),
                 at("prefetch.gray", 6, 20, 26, 12), at("prefetch.read", 6, 0, 9, 12)]
    assert read("gray_ms.fleet") == pytest.approx(3.0)


def test_frames_wait_is_the_union_of_the_streams_queue_waits(recorded):
    # four prefetchers' queues, waited for one after another by the loop;
    # keys repeat across streams
    recorded += [at("prefetch.get", 5, 10, 14), at("prefetch.get", 5, 14, 20), at("prefetch.get", 5, 18, 22),
                 at("prefetch.get", 6, 60, 63), at("prefetch.read", 6, 0, 90, PREFETCH),
                 at("prefetch.get", 7, 101, 120)]
    assert read("frames_wait.fleet") == pytest.approx(15.0)


@pytest.mark.parametrize("name", ["step_host_ms.fleet", "frames_wait.fleet", "gray_ms.fleet"])
def test_fleet_span_readers_find_nothing_without_a_trace_or_spans(recorded, name):
    assert read(name) is None
    recorded += [at("batch.step.fill", 1, 1, 2), at("batch.step.dispatch", 1, 2, 3), at("prefetch.get", 1, 3, 4),
                 at("prefetch.gray", 1, 0, 1, PREFETCH)]
    assert read(name, trace=False) is None
    assert read(name) is not None
