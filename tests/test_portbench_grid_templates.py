"""The benchmark's reader of the grid template kernel's roofline share
(portbench/metrics/grid_templates.roofline.py) on hand-made traces."""

import json
from types import SimpleNamespace

import pytest

from portbench.harness.cell import Reading, Window
from portbench.harness.spec import BENCH_DIR, load_module
from portbench.harness.timeline import Event, Trace

T0_US = 1_000_000.0
CFG = json.loads((BENCH_DIR / "configs" / "pathfinder-1080p.json").read_text())
# the review's launch: 2304 points x 3 planes x 45 x 45 float32 at 3.35 TB/s
LAUNCH_BOUND_US = 2304 * 3 * 45 * 45 * 4 / 3.35e12 * 1e6


def read(trace, streams=1):
    win = Window(0.0, 0.1, answers=10, attempted=10, steps=[])
    ctx = SimpleNamespace(cfg=CFG, traffic={"streams": streams})
    return load_module(BENCH_DIR / "metrics" / "grid_templates.roofline.py").read(Reading(ctx, win, trace, 1.0))


def kernel(start_us, dur_us, name="void (anonymous namespace)::grid_templates_kernel(float const*)"):
    return Event(name, T0_US + start_us, T0_US + start_us + dur_us, 7)


@pytest.mark.parametrize("streams", [1, 4])
def test_share_is_the_templates_bound_over_the_launches_time(streams):
    dev = [kernel(10, 40), kernel(100, 50), kernel(200, 30, "lk_level_kernel<8, 8>"),
           kernel(-20, 40), kernel(1e5 + 5, 40)]  # before and after the window: not read
    got = read(Trace((T0_US, T0_US + 1e5), dev, []), streams)
    assert got == pytest.approx(100.0 * 2 * streams * LAUNCH_BOUND_US / 90.0)


def test_nothing_to_read_without_the_kernel_or_a_trace():
    assert read(None) is None
    assert read(Trace((T0_US, T0_US + 1e5), [kernel(10, 40, "patch_bilinear_kernel<8>")], [])) is None
