"""warp_bilinear.roofline (%): the Farneback coefficient warp's least
time (bytes at the HBM bandwidth or operations at the float32 peak, the
larger, per launch) over the device time the trace gives its launches.
Each pair launches it `iterations` times at every level; the launches
are counted in the trace and their work taken as a pair's average."""

from portbench.harness.work import warp_bound_per_pair_s

KERNELS = ("warp_gather_kernel", "warp_slab_kernel")


def read(r):
    if r.trace is None:
        return None
    lo, hi = r.trace.window
    runs = [e for e in r.trace.device if any(k in e.name for k in KERNELS) and lo <= e.start < hi]
    if not runs:
        return None
    per_pair_s, launches_per_pair = warp_bound_per_pair_s(r.ctx.cfg)
    bound_s = len(runs) / launches_per_pair * per_pair_s
    return 100.0 * bound_s / (sum(e.end - e.start for e in runs) * 1e-6)
