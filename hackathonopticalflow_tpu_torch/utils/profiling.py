"""Timing / metrics utilities (port of
hackathonopticalflow_tpu/utils/profiling.py).

Replaces the reference's manual time.time_ns FPS arithmetic
(pathfinder_viewer.py:339-356) with plain counters, and the JAX package's
jax.profiler capture with torch.profiler, written as a Chrome trace for
kernel-level work. The counters read the host clock: around GPU work they
measure device time only where the block ends in a synchronize.

`span(name, key)` marks a stage of the port's host loops (a frame's gray
conversion, dispatch, fetch; a chunk's dispatch; the prefetch thread's
read and its wait for a free chunk buffer).
Spans are recorded only while a torch.profiler records, from any thread:
torch.profiler keeps no `record_function` range of a thread it was not
started on, so the spans have their own store, read by `spans()`, and
`device_trace` writes them into its Chrome trace on the trace's clock.
Outside a profiler a span costs one flag read.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

#: the range `device_trace` opens to put the spans' clock onto the trace's
ANCHOR = "profiling.anchor"


class Timer:
    def __init__(self):
        self.total = 0.0
        self.count = 0

    @contextlib.contextmanager
    def __call__(self):
        t0 = time.perf_counter()
        yield
        self.total += time.perf_counter() - t0
        self.count += 1

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)


class FpsCounter:
    """Sliding-window FPS (the reference recomputes per frame from ns
    deltas; a short window is steadier)."""

    def __init__(self, window: int = 30):
        self.times = deque(maxlen=window)

    def tick(self) -> float:
        now = time.perf_counter()
        self.times.append(now)
        if len(self.times) < 2:
            return 0.0
        return (len(self.times) - 1) / (self.times[-1] - self.times[0])


class Span(NamedTuple):
    """One stage of a host loop. `key` names what it served: a frame's
    absolute index, a chunk's index, a function's name, or None. `thread`
    is the OS thread id, a trace's `tid`; times are
    time.perf_counter_ns()."""

    name: str
    key: int | str | None
    thread: int
    start_ns: int
    end_ns: int


# the spans recorded while a profiler ran, the oldest dropped first
_spans: deque = deque(maxlen=2**18)


class _Off:
    """The span of every call while no profiler records: it does
    nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _On:
    __slots__ = ("name", "key", "start_ns")

    def __init__(self, name: str, key):
        self.name = name
        self.key = key

    def __enter__(self):
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        _spans.append(Span(self.name, self.key, threading.get_native_id(), self.start_ns, end_ns))
        return False


def span(name: str, key=None):
    """A context manager that records its block as a `Span` while a
    torch.profiler records, on any thread; else one shared object that
    does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _On(name, key)


def spans() -> list[Span]:
    """A copy of the recorded spans, oldest first."""
    return list(_spans)


def clear_spans() -> None:
    _spans.clear()


@contextlib.contextmanager
def device_trace(out_dir: str):
    """torch.profiler over the block (host activity, and the GPU's where
    CUDA is available), written to out_dir/trace.json as a Chrome trace
    (chrome://tracing or Perfetto). The block's spans are added to it as
    "X" events of category "span" on their threads, moved onto the
    trace's clock by the `ANCHOR` range that opens the block. Yields the
    profiler, whose key_averages() sum the block's operators and
    kernels."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(ANCHOR):
            anchor_ns = time.perf_counter_ns()
        yield prof
        end_ns = time.perf_counter_ns()
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "trace.json")
    prof.export_chrome_trace(path)
    _add_spans(path, [s for s in spans() if anchor_ns <= s.start_ns <= end_ns], anchor_ns)


def _add_spans(path: str, block: list, anchor_ns: int) -> None:
    """Appends `block` to the Chrome trace at `path`, in the anchor's
    process: the clock read `anchor_ns` lands at the middle of the
    anchor range, which holds nothing else."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    anchor = next(e for e in events if e.get("ph") == "X" and e.get("name") == ANCHOR)
    at_us = float(anchor["ts"]) + 0.5 * float(anchor.get("dur", 0.0))
    for s in block:
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": anchor["pid"], "tid": s.thread,
                       "ts": at_us + (s.start_ns - anchor_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
                       "args": {"key": s.key}})
    with open(path, "w") as f:
        json.dump(data, f)
