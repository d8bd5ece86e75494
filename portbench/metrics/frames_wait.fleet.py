"""frames_wait.fleet (%): the union of run_batch's waits on its streams'
frame prefetchers (`prefetch.get`) over the traced window: the loop
starved for frames."""

from portbench.harness.spans import union_pct


def read(r):
    return union_pct(r, ("prefetch.get",))
