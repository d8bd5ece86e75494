"""grid_templates.roofline (%): the grid template kernel's least time over
the device time the trace gives its launches. A launch cuts one level's
templates for every stream of its step, streams x grid points x 3 planes
x win_h x win_w float32, written once at the HBM bandwidth; that work does
not depend on the data. Output bytes only: the three level planes it
reads were written just before and may still be in L2, so an input term
could read past 100%."""

from portbench.harness.roofline import bound_s
from portbench.reference.lk_grid import measurement_grid

KERNEL = "grid_templates_kernel"


def bound_per_launch_s(cfg: dict, streams: int) -> float:
    """The least seconds of one launch: its templates written once."""
    lk = cfg["lk"]
    win_w, win_h = lk["win_size"]
    n = measurement_grid(cfg["height"], cfg["width"], lk["grid_step"]).shape[0]
    return bound_s(streams * n * 3 * win_h * win_w * 4)


def read(r):
    if r.trace is None:
        return None
    lo, hi = r.trace.window
    runs = [e for e in r.trace.device if KERNEL in e.name and lo <= e.start < hi]
    if not runs:
        return None
    per_launch = bound_per_launch_s(r.ctx.cfg, r.ctx.traffic["streams"])
    return 100.0 * len(runs) * per_launch / (sum(e.end - e.start for e in runs) * 1e-6)
