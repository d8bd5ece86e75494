"""prefetch_busy.pairs (%): the union of the prefetch thread's frame reads
and gray conversions (`prefetch.read`, `prefetch.gray`) over the traced
window: the prefetch thread's load."""

from portbench.harness.spans import union_pct


def read(r):
    return union_pct(r, ("prefetch.read", "prefetch.gray"))
