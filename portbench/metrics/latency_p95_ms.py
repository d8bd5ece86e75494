"""latency_p95_ms (ms): the 95th percentile of the same latencies as
latency_p50_ms, over every frame of the window (never of chunk medians)."""

from portbench.harness.timeline import percentile


def read(r):
    if not r.win.latencies_s:
        return None
    return 1e3 * percentile(r.win.latencies_s, 95.0)
