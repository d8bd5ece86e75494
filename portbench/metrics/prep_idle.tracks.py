"""prep_idle.tracks (%): the device's idle time of the traced window that
falls inside the tracker's per-chunk preparation (`tracker.upload`, the
frames' copy to the device, and `tracker.first_frame`, the first frame's
eager pyramid), over the window."""

from portbench.harness.spans import idle_inside_pct


def read(r):
    return idle_inside_pct(r, ("tracker.upload", "tracker.first_frame"))
