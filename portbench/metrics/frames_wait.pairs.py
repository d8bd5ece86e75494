"""frames_wait.pairs (%): the union of the app's waits on the frame
prefetcher's queue (`prefetch.get`) over the traced window: the main loop
starved for frames."""

from portbench.harness.spans import union_pct


def read(r):
    return union_pct(r, ("prefetch.get",))
