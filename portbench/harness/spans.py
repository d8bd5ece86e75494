"""The port's own spans (`hackathonopticalflow_tpu_torch/utils/profiling.py`:
stages of its host loops, recorded while a torch.profiler records) that
started inside the traced window, on the trace's clock, and the
arithmetic of the metric readers that read them (metrics/<name>.py).

run_cell reads the host clock (`win.t0`) right before it opens the
window's range, so a span's time ns (time.perf_counter_ns) maps onto the
trace as `trace.window[0] + (ns / 1e3 - win.t0 * 1e6)` microseconds, to
the few microseconds that opening the range takes. Each reader returns
None without a trace, and where the port records no such span (a port
without the recorder)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .timeline import clip_to, covered, union


class SpanEvent(NamedTuple):
    name: str
    key: object
    tid: int
    start: float  # microseconds, the trace's clock
    end: float


def window_spans(r, names) -> list[SpanEvent]:
    """The spans named one of `names` whose start lies in [win.t0,
    win.t1], on the trace's clock; [] without a trace or a recorder."""
    if r.trace is None:
        return []
    try:
        from hackathonopticalflow_tpu_torch.utils.profiling import spans
    except ImportError:
        return []
    lo, hi = r.win.t0 * 1e9, r.win.t1 * 1e9
    at = r.trace.window[0] - r.win.t0 * 1e6
    return [SpanEvent(s.name, s.key, s.thread, at + s.start_ns / 1e3, at + s.end_ns / 1e3)
            for s in spans() if s.name in names and lo <= s.start_ns <= hi]


def _by_key(found) -> dict:
    """{key: {name: [spans]}}."""
    out: dict = {}
    for s in found:
        out.setdefault(s.key, {}).setdefault(s.name, []).append(s)
    return out


def host_ms_per_key(r, names, anchor: str):
    """The median over the keys that have an `anchor` span of the summed
    durations of that key's spans named one of `names`, in ms."""
    keyed = _by_key(window_spans(r, set(names) | {anchor}))
    sums = [sum(s.end - s.start for n in names for s in of.get(n, ())) for of in keyed.values() if anchor in of]
    return 1e-3 * float(np.median(sums)) if sums else None


def held_ms(r, first: str, then: str):
    """The median over the keys that have both of the time from the end
    of a key's `first` span to the start of its `then` span, in ms."""
    keyed = _by_key(window_spans(r, {first, then}))
    gaps = [of[then][0].start - of[first][-1].end for of in keyed.values() if first in of and then in of]
    return 1e-3 * float(np.median(gaps)) if gaps else None


def union_pct(r, names):
    """The union of the spans named one of `names` over the traced
    window, in %."""
    found = window_spans(r, set(names))
    if not found or r.trace.window_us <= 0:
        return None
    inside = clip_to([(s.start, s.end) for s in found], *r.trace.window)
    return 100.0 * covered(inside) / r.trace.window_us


def idle_inside_pct(r, names):
    """The device's idle time of the traced window (the window less the
    union of its kernels, copies and sets) that falls inside the union of
    the spans named one of `names`, over the window, in %."""
    found = window_spans(r, set(names))
    if not found or r.trace.window_us <= 0:
        return None
    lo, hi = r.trace.window
    busy = r.trace.busy_intervals()
    idle_us = 0.0
    for a, b in union(clip_to([(s.start, s.end) for s in found], lo, hi)):
        idle_us += (b - a) - covered(clip_to(busy, a, b))
    return 100.0 * idle_us / r.trace.window_us
