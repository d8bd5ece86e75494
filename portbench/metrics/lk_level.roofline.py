"""lk_level.roofline (%): the LK level kernel's least time (bytes at the
HBM bandwidth or operations at the float32 / float64 peaks, the larger,
per launch) over the device time the trace gives its launches. The work
of every launch is counted for the pairs its step computed, from the
reference's per-level counts of live points and iterations on the same
pairs (harness/work.py)."""

from portbench.harness.work import lk_level_bound_s

KERNEL = "lk_level_kernel"


def read(r):
    if r.trace is None:
        return None
    lo, hi = r.trace.window
    ran_us = sum(e.end - e.start for e in r.trace.device if KERNEL in e.name and lo <= e.start < hi)
    if ran_us <= 0:
        return None
    return 100.0 * lk_level_bound_s(r) / (ran_us * 1e-6)
