"""result_held_ms.live (ms): the median over the traced window's frames of
the time from the end of a frame's dispatch (`pathfinder.frame.dispatch`)
to the start of its fetch (`pathfinder.frame.fetch`): how long a
dispatched frame's result waits for the app's loop to come back to it."""

from portbench.harness.spans import held_ms


def read(r):
    return held_ms(r, "pathfinder.frame.dispatch", "pathfinder.frame.fetch")
