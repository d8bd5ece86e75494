"""patch_bilinear.roofline (%): the window kernel's least time (bytes at
the HBM bandwidth or operations at the float32 peak, the larger, per
launch) over the device time the trace gives its launches. A tracker step
launches it eight times over every slot, work that does not depend on the
data: each launch counts as the mean of the eight
(harness/tracker_work.py)."""

from portbench.harness.tracker_work import patch_bound_per_launch_s

KERNEL = "patch_bilinear_kernel"


def read(r):
    if r.trace is None:
        return None
    lo, hi = r.trace.window
    runs = [e for e in r.trace.device if KERNEL in e.name and lo <= e.start < hi]
    if not runs:
        return None
    return 100.0 * len(runs) * patch_bound_per_launch_s(r.ctx.cfg) / (sum(e.end - e.start for e in runs) * 1e-6)
