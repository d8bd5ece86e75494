"""prep_idle.fields (%): the device's idle time of the traced window that
falls inside the dense scan's per-chunk preparation (`dense.upload`, the
frames' copy to the device, and `dense.first_frame`, the first frame's
eager pyramid), over the window."""

from portbench.harness.spans import idle_inside_pct


def read(r):
    return idle_inside_pct(r, ("dense.upload", "dense.first_frame"))
