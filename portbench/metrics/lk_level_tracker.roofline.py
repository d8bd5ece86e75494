"""lk_level_tracker.roofline (%): the LK level kernel's least time in the
tracker's geometry (bytes at the HBM bandwidth or operations at the
float32 / float64 peaks, the larger, per launch) over the device time the
trace gives its launches. A launch's work is the mean over the window's
steps, counted from the reference's replay where the check ran it and
else from the slots alive before the step, one iteration each
(harness/tracker_work.py)."""

from portbench.harness.tracker_work import lk_level_bound_per_launch_s

KERNEL = "lk_level_kernel"


def read(r):
    if r.trace is None:
        return None
    lo, hi = r.trace.window
    runs = [e for e in r.trace.device if KERNEL in e.name and lo <= e.start < hi]
    per_launch = lk_level_bound_per_launch_s(r) if runs else None
    if per_launch is None:
        return None
    return 100.0 * len(runs) * per_launch / (sum(e.end - e.start for e in runs) * 1e-6)
