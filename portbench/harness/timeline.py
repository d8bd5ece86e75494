"""Reading a torch.profiler trace of the window: the device's busy
intervals (kernels, copies, sets), the host's CUDA API calls by thread,
and what the host was doing while the device idled.

The busy time is the UNION of the device's intervals, never their sum, so
copies that overlap kernels cannot push a share past 1.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json

import numpy as np

WINDOW_LABEL = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
API_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = API_CATS + ("cpu_op",)
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch")
#: calls that block the calling thread until device work is done
SYNC_CALLS = ("cudaStreamSynchronize", "cudaEventSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
              "cuStreamSynchronize", "cuEventSynchronize", "cuCtxSynchronize")


def percentile(values, q: float) -> float:
    """The q-th percentile of every value (linear interpolation, numpy's
    default), never of chunk medians."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def union(intervals) -> list[tuple[float, float]]:
    """Merged, sorted (start, end) intervals covering the same points."""
    out: list[list[float]] = []
    for a, b in sorted((float(a), float(b)) for a, b in intervals if b > a):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def clip_to(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if min(b, hi) > max(a, lo)]


def covered(intervals) -> float:
    """Length of the union of the intervals."""
    return sum(b - a for a, b in union(intervals))


@dataclasses.dataclass
class Event:
    name: str
    start: float  # microseconds, the trace's clock
    end: float
    tid: int


@dataclasses.dataclass
class Trace:
    """The window's events; times in microseconds on the trace's clock."""

    window: tuple[float, float]
    device: list[Event]  # kernels, copies, sets
    host: list[Event]  # CUDA API calls and aten ops, every thread

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> list[tuple[float, float]]:
        return union(clip_to([(e.start, e.end) for e in self.device], *self.window))

    def busy_us(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def main_tid(self) -> int | None:
        """The thread that launches the device work: the one with the most
        kernel and graph launches."""
        counts = collections.Counter(e.tid for e in self.host if e.name in LAUNCH_CALLS)
        return counts.most_common(1)[0][0] if counts else None

    def calls(self, names, tid: int | None = None) -> list[Event]:
        """The window's host events named one of `names` (on thread
        `tid`, or on any)."""
        lo, hi = self.window
        return [e for e in self.host if e.name in names and (tid is None or e.tid == tid)
                and e.start >= lo and e.start < hi]

    def device_by_name(self) -> collections.Counter:
        """Device microseconds inside the window by op name."""
        lo, hi = self.window
        out: collections.Counter = collections.Counter()
        for e in self.device:
            d = min(e.end, hi) - max(e.start, lo)
            if d > 0:
                out[e.name] += d
        return out

    def idle_by_host(self) -> collections.Counter:
        """Device-idle microseconds of the window by what the launching
        thread was doing: the innermost CUDA API call or aten op that
        covers each gap's midpoint, else "host Python (no CUDA call)"."""
        lo, hi = self.window
        tid = self.main_tid()
        gaps, t = [], lo
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if hi > t:
            gaps.append((t, hi))
        mine = sorted((e for e in self.host if e.tid == tid), key=lambda e: e.start)
        starts = [e.start for e in mine]
        out: collections.Counter = collections.Counter()
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid)
            label = "host Python (no CUDA call)"
            # the latest-starting event that still covers the midpoint
            for e in reversed(mine[max(0, i - 64):i]):
                if e.end >= mid:
                    label = e.name
                    break
            out[label] += b - a
        return out


def read_chrome_trace(path) -> Trace:
    """Parses torch.profiler's export_chrome_trace output. The window is
    the span of the `portbench.window` annotation."""
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    window = None
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat", "")
        start = float(e["ts"])
        end = start + float(e.get("dur", 0.0))
        name = e.get("name", "")
        if name == WINDOW_LABEL and cat == "user_annotation":
            if window is None or end - start > window[1] - window[0]:
                window = (start, end)
        elif cat in DEVICE_CATS:
            device.append(Event(name, start, end, int(e.get("tid", 0)) if str(e.get("tid", 0)).isdigit() else 0))
        elif cat in HOST_CATS:
            tid = e.get("tid", 0)
            host.append(Event(name, start, end, int(tid) if str(tid).lstrip("-").isdigit() else hash(tid)))
    if window is None:
        raise ValueError(f"no {WINDOW_LABEL!r} annotation in the trace")
    return Trace(window, device, host)
