"""The arithmetic the metric readers share (metrics/<name>.py): each
returns None where it finds nothing to read."""

from __future__ import annotations

from .timeline import LAUNCH_CALLS, SYNC_CALLS, clip_to, covered


def rate(r):
    """Answers that reached the host inside the window, over the whole
    window (host clock)."""
    return r.win.answers / r.win.seconds if r.win.seconds > 0 else None


def device_idle_pct(r):
    """1 minus the UNION of the device's kernels, copies and sets over the
    traced window, in % (a sum would count overlapping copies twice)."""
    if r.trace is None or not r.trace.device or r.trace.window_us <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_us() / r.trace.window_us)


def device_ms_per_answer(r):
    """Device busy time (the union) in the traced window per answer."""
    if r.trace is None or not r.trace.device or r.win.answers <= 0:
        return None
    return r.trace.busy_us() * 1e-3 / r.win.answers


def host_sync_wait_pct(r):
    """The share of the traced window, in %, that the thread launching the
    device work spends blocked in a synchronize, event-wait or synchronous
    copy call (the union of those calls)."""
    if r.trace is None or r.trace.window_us <= 0:
        return None
    tid = r.trace.main_tid()
    if tid is None:
        return None
    calls = r.trace.calls(SYNC_CALLS, tid)
    return 100.0 * covered(clip_to([(e.start, e.end) for e in calls], *r.trace.window)) / r.trace.window_us


def syncs_per_answer(r):
    """Those blocking calls of the launching thread per answer."""
    if r.trace is None or r.win.answers <= 0:
        return None
    tid = r.trace.main_tid()
    return None if tid is None else len(r.trace.calls(SYNC_CALLS, tid)) / r.win.answers


def launches_per_answer(r):
    """Kernel and graph launches of every thread per answer."""
    if r.trace is None or r.win.answers <= 0:
        return None
    n = len(r.trace.calls(LAUNCH_CALLS))
    return n / r.win.answers if n else None
