"""step_host_ms.fleet (ms): the median over the traced window's steps of a
step's summed fill, dispatch and unpack spans (`batch.step.*`, the wait
on its result left out), less the queue waits (`prefetch.get`) inside its
fill, which frames_wait.fleet reads: run_batch's own host work a step,
the hook's calls included."""

import numpy as np

from portbench.harness.spans import window_spans

NAMES = ("batch.step.fill", "batch.step.dispatch", "batch.step.unpack")


def read(r):
    found = window_spans(r, set(NAMES) | {"prefetch.get"})
    gets = sorted((s.start, s.end) for s in found if s.name == "prefetch.get")
    starts = np.array([g[0] for g in gets])
    ends = np.array([g[1] for g in gets])
    steps: dict = {}
    for s in found:
        if s.name in NAMES:
            steps.setdefault(s.key, []).append(s)
    sums = []
    for of in steps.values():
        if not any(s.name == "batch.step.dispatch" for s in of):
            continue
        total = 0.0
        for s in of:
            total += s.end - s.start
            if s.name == "batch.step.fill":
                lo, hi = np.searchsorted(starts, [s.start, s.end])
                total -= float(np.clip(np.minimum(ends[lo:hi], s.end) - starts[lo:hi], 0, None).sum())
        sums.append(total)
    return 1e-3 * float(np.median(sums)) if sums else None
