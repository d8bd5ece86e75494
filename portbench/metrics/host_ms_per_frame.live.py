"""host_ms_per_frame.live (ms): the median over the traced window's frames
of a frame's summed gray conversion, dispatch, fetch and present spans
(`pathfinder.frame.*`): the app's host work a frame, the camera wait
left out."""

from portbench.harness.spans import host_ms_per_key

NAMES = ("pathfinder.frame.gray", "pathfinder.frame.dispatch", "pathfinder.frame.fetch",
         "pathfinder.frame.present")


def read(r):
    return host_ms_per_key(r, NAMES, "pathfinder.frame.dispatch")
