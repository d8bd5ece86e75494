"""latency_p50_ms (ms): the median over every frame of the window of the
time from the frame's due time on the camera's clock to the moment its
result is on the host."""

from portbench.harness.timeline import percentile


def read(r):
    if not r.win.latencies_s:
        return None
    return 1e3 * percentile(r.win.latencies_s, 50.0)
