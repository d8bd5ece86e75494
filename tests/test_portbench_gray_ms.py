"""The benchmark's reader of the frame stage's gray conversion time
(portbench/metrics/gray_ms.pairs.py) on hand-made readings: spans on the
host clock inside and outside a 100-ms window."""

import pytest

from hackathonopticalflow_tpu_torch.utils import profiling
from hackathonopticalflow_tpu_torch.utils.profiling import Span
from portbench.harness.cell import Reading, Window
from portbench.harness.spec import BENCH_DIR, load_module
from portbench.harness.timeline import Event, Trace

T0_NS = 42_000_000_000  # the window's start on the host clock
TRACE_T0_US = 1_000_000.0
PREFETCH = 12


def read(trace=True):
    tr = Trace((TRACE_T0_US, TRACE_T0_US + 1e5), [Event("kernel", TRACE_T0_US, TRACE_T0_US + 10.0, 7)], [])
    win = Window(T0_NS / 1e9, T0_NS / 1e9 + 0.1, answers=10, attempted=10, steps=[])
    r = Reading(ctx=None, win=win, trace=tr if trace else None, setup_s=1.0)
    return load_module(BENCH_DIR / "metrics" / "gray_ms.pairs.py").read(r)


def at(name, key, start_ms, dur_ms):
    return Span(name, key, PREFETCH, T0_NS + int(start_ms * 1e6), T0_NS + int((start_ms + dur_ms) * 1e6))


@pytest.fixture
def recorded(monkeypatch):
    found = []
    monkeypatch.setattr(profiling, "spans", lambda: list(found))
    return found


def test_gray_ms_is_the_median_conversion_of_a_frame(recorded):
    recorded += [
        at("prefetch.gray", 0, -5, 3.0),  # started before the window: not read
        at("prefetch.gray", 1, 1, 0.6), at("prefetch.gray", 2, 2, 0.9), at("prefetch.gray", 3, 3, 1.2),
        at("prefetch.gray", 4, 101, 4.0),  # after the window: not read
        at("prefetch.read", 2, 1.8, 0.1), at("prefetch.slot_wait", 1, 4, 9.0),
    ]
    assert read() == pytest.approx(0.9)


def test_nothing_to_read_without_gray_spans_or_a_trace(recorded):
    recorded += [at("prefetch.read", 1, 1, 0.1), at("prefetch.get", 0, 2, 5.0)]
    assert read() is None
    recorded.append(at("prefetch.gray", 1, 1, 0.6))
    assert read(trace=False) is None
