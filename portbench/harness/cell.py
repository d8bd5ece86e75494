"""One run of one cell: set-up, the measured window, the check of what the
window produced against the reference, the metrics.

The order matters. Set-up makes the clips from the seed (on the device)
and warms the entry with one short call of itself, so that every graph
the window replays is captured and every kernel built before the clock
starts. The window runs the entry until its deadline; with tracing it is
profiled whole. Then the device's memory peak is read and the port's
state freed, and only then does the reference run, pair by pair, so that
neither its time nor its memory counts for the port.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch

from . import refs
from .clip import Opener, host_bgr, make_clip, stream_seed
from .spec import Cell, entry_module, metric_module, resolve_cell
from .timeline import WINDOW_LABEL, Trace, read_chrome_trace


@dataclasses.dataclass
class Stream:
    name: str
    seed: int
    gray: np.ndarray  # (N, H, W) uint8, host
    bgr: np.ndarray | None  # (N, H, W, 3) uint8, host; None where the entry takes gray frames

    @property
    def n(self) -> int:
        return self.gray.shape[0]


@dataclasses.dataclass
class Window:
    """What an entry's window did. `answers` reached the host inside it,
    of `attempted` due; `steps` lists the device's flow steps, each the
    (stream, previous frame, current frame) pairs it computed together,
    warm-up and padding steps included (the kernels' work is counted
    from them)."""

    t0: float
    t1: float
    answers: int
    attempted: int
    steps: list
    latencies_s: list | None = None
    data: dict = dataclasses.field(default_factory=dict)
    notes: dict = dataclasses.field(default_factory=dict)  # printed in the result line, never compared

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class Ctx:
    """What an entry sees: the cell, the device, the clips, the reader
    opener it hands to the port, and a dict for its own state."""

    cell: Cell
    seed: int
    device: torch.device
    control: bool
    streams: list
    opener: Opener
    clock: Callable[[], float] = time.perf_counter
    state: dict = dataclasses.field(default_factory=dict)
    _lk: dict = dataclasses.field(default_factory=dict)
    _fb: dict = dataclasses.field(default_factory=dict)

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def lk_pairs(self, stream: int, data_dtype=torch.float32) -> refs.LKPairs:
        key = (stream, data_dtype)
        if key not in self._lk:
            self._lk[key] = refs.LKPairs(self.cfg, self.streams[stream].bgr, self.device, data_dtype)
        return self._lk[key]

    def fb_pairs(self, stream: int) -> refs.FarnebackPairs:
        if stream not in self._fb:
            self._fb[stream] = refs.FarnebackPairs(self.cfg, self.streams[stream].gray, self.device)
        return self._fb[stream]


@dataclasses.dataclass
class Reading:
    """What a metric's reader sees once the window has closed."""

    ctx: Ctx
    win: Window
    trace: Trace | None
    setup_s: float


def make_streams(cell: Cell, seed: int, device: torch.device) -> list[Stream]:
    """Each stream's clip from its own seed, made on the device and moved
    to host memory once."""
    t = cell.traffic
    h, w = cell.config["height"], cell.config["width"]
    out = []
    for i in range(int(t.get("streams", 1))):
        s = stream_seed(seed, i)
        clip = make_clip(device, h, w, int(t["clip_frames"]), int(t["cell_px"]), s, float(t["zoom"]))
        gray = clip.cpu().numpy()
        bgr = host_bgr(clip) if t.get("bgr", True) else None
        out.append(Stream(f"stream{i}", s, gray, bgr))
        del clip
    return out


def _profile(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    return profile(activities=acts)


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             control: bool = False, t_start: float | None = None, cell: Cell | None = None) -> dict:
    """Runs the cell once; returns {"correct", "attempted", "failed",
    "metrics", "device", ["breakdown"], "checks"} (the result line's
    keys) and, under "_ctx" and "_window", what the run made."""
    clock = time.perf_counter
    t_start = clock() if t_start is None else t_start
    device = torch.device(device)
    cell = cell or resolve_cell(Path(root), workload)
    entry = entry_module(cell)

    def log(what: str) -> None:
        print(f"portbench: {what} at {clock() - t_start:.3f} s", file=sys.stderr, flush=True)

    streams = make_streams(cell, seed, device)
    log("clips made")
    ctx = Ctx(cell, int(seed), device, control, streams, Opener(), clock)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    entry.setup(ctx)
    ctx.sync()
    log("entry warmed")

    window_s = float(seconds)
    if trace:
        window_s = min(window_s, float(cell.traffic.get("trace_seconds", seconds)))
    prof = _profile(device) if trace else None
    if prof is not None:
        prof.start()
    t0 = clock()
    setup_s = t0 - t_start
    with torch.profiler.record_function(WINDOW_LABEL):
        win = entry.window(ctx, t0, t0 + window_s)
    log(f"window closed ({win.answers} answers)")
    parsed = None
    if prof is not None:
        prof.stop()
        log("profiler stopped")
        fd, path = tempfile.mkstemp(prefix="portbench-trace-", suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            log(f"trace written ({os.path.getsize(path)} bytes)")
            del prof
            parsed = read_chrome_trace(path)
        finally:
            os.unlink(path)
        log(f"trace read ({len(parsed.device)} device events)")

    dev_info: dict[str, Any] = {"platform": "gpu" if cuda else device.type, "count": cell.chips}
    if cuda:
        dev_info["kind"] = torch.cuda.get_device_name(device)
        dev_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device))
    release = getattr(entry, "release", None)
    if release is not None:
        release(ctx)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()

    numbers, failed = entry.check(ctx, win)
    log("checked")
    checks, correct = {}, True
    for name, value in numbers.items():
        if name not in cell.limits:
            raise KeyError(f"no limit for {name!r} in limits/{cell.name}.json")
        limit = float(cell.limits[name]["limit"])
        checks[name] = {"value": float(value), "limit": limit}
        correct = correct and bool(np.isfinite(value)) and float(value) <= limit

    reading = Reading(ctx, win, parsed, setup_s)
    metrics: dict[str, dict] = {}
    chosen = cell.per_layer if trace else cell.end_to_end
    for m in chosen:
        value = metric_module(cell, m["name"]).read(reading)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    log("metrics read")
    out: dict[str, Any] = {"correct": correct, "attempted": int(win.attempted), "failed": int(failed),
                           "metrics": metrics, "device": dev_info}
    if parsed is not None:
        busy_us = parsed.busy_us()
        if cuda:
            dev_info["busy_s"] = busy_us * 1e-6
            dev_info["window_s"] = parsed.window_us * 1e-6
        out["breakdown"] = {
            "device_ops": [[name[:120], us * 1e-6] for name, us in parsed.device_by_name().most_common(10)],
            "idle_gaps": [[name[:120], us * 1e-6] for name, us in parsed.idle_by_host().most_common(10)],
        }
    if win.notes:
        out["notes"] = win.notes
    out["checks"] = checks
    out["_ctx"], out["_window"] = ctx, win
    return out
