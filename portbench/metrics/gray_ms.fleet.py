"""gray_ms.fleet (ms): the median over the traced window of one frame's
gray conversion (`prefetch.gray`) by any of the fleet's prefetch
threads, which convert their streams' frames at the same time."""

import numpy as np

from portbench.harness.spans import window_spans


def read(r):
    found = window_spans(r, {"prefetch.gray"})
    return 1e-3 * float(np.median([s.end - s.start for s in found])) if found else None
