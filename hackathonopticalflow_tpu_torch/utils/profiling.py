"""Timing / metrics utilities (port of
hackathonopticalflow_tpu/utils/profiling.py).

Replaces the reference's manual time.time_ns FPS arithmetic
(pathfinder_viewer.py:339-356) with plain counters, and the JAX package's
jax.profiler capture with torch.profiler, written as a Chrome trace for
kernel-level work. The counters read the host clock: around GPU work they
measure device time only where the block ends in a synchronize.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import torch


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


@contextlib.contextmanager
def device_trace(out_dir: str):
    """torch.profiler over the block (host activity, and the GPU's where
    CUDA is available), written to out_dir/trace.json as a Chrome trace
    (chrome://tracing or Perfetto). Yields the profiler, whose
    key_averages() sum the block's operators and kernels."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
