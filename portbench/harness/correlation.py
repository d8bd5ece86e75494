"""Which device ops each captured graph's launch ran, from the correlation
ids of a torch.profiler trace.

CUPTI gives every kernel, copy and set the correlation id of the host
call that launched it; the kernels of a replayed CUDA graph carry the id
of its `cudaGraphLaunch`. The harness's trace reader (timeline.py) keeps
no ids, so `install()` wraps the reader that run_cell calls: the Trace it
returns also carries `launches`, the window's graph launches and the
device ops of each. An entry whose readers need them installs it at its
set-up; without it `launches` is absent and those readers find nothing.
"""

from __future__ import annotations

import json
from typing import NamedTuple

from .timeline import API_CATS, DEVICE_CATS, clip_to, covered

GRAPH_LAUNCHES = ("cudaGraphLaunch", "cuGraphLaunch")


class Launches(NamedTuple):
    host: list  # (start, end, correlation id) of every graph launch, trace clock (us)
    device: dict  # correlation id -> [(start, end)] of the device ops it launched


def read_launches(path) -> Launches:
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    host, device = [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        corr = (e.get("args") or {}).get("correlation")
        if corr is None:
            continue
        start = float(e["ts"])
        end = start + float(e.get("dur", 0.0))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.setdefault(corr, []).append((start, end))
        elif cat in API_CATS and e.get("name") in GRAPH_LAUNCHES:
            host.append((start, end, corr))
    return Launches(host, device)


def install() -> None:
    """Wrap run_cell's trace reader once so that its Trace carries
    `launches`."""
    from . import cell

    if getattr(cell.read_chrome_trace, "keeps_launches", False):
        return
    base = cell.read_chrome_trace

    def read(path):
        trace = base(path)
        trace.launches = read_launches(path)
        return trace

    read.keeps_launches = True
    cell.read_chrome_trace = read


def graph_share_pct(trace, chosen) -> float | None:
    """The device time of the chosen graph launches of the window, the
    union of their ops, over the window's busy time, in %. `chosen` has a
    flag for each graph launch of the window in order: the caller knows
    the order of its steps, one launch each. None without launches, or
    where the window holds another number of them."""
    launches = getattr(trace, "launches", None)
    busy = trace.busy_us()
    if launches is None or busy <= 0:
        return None
    lo, hi = trace.window
    host = sorted(h for h in launches.host if lo <= h[0] < hi)
    if len(host) != len(chosen):
        return None
    ran = [iv for (_, _, corr), pick in zip(host, chosen) if pick for iv in launches.device.get(corr, ())]
    return 100.0 * covered(clip_to(ran, lo, hi)) / busy
