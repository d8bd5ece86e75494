"""detect_share.tracks (%): the share of the traced window's device busy
time spent in the ops of the captured graphs that the `tracker.step.detect`
steps launched (the steps that run Shi-Tomasi detection as well as
forward-backward LK), the ops found by the launches' correlation ids
(harness/correlation.py).

Each step span (`tracker.step.detect` or `.track`) launches one graph, so
the window's i-th step span is paired with its i-th graph launch, in
order. Matching by time would put a launch in the wrong step: the spans'
host clock, moved onto the trace's at the window's start, lands up to
about a millisecond off in a process's first traced window, more than the
0.1-0.3 ms from a step span's start to its graph launch."""

from portbench.harness.correlation import graph_share_pct
from portbench.harness.spans import window_spans


def read(r):
    found = sorted(window_spans(r, {"tracker.step.detect", "tracker.step.track"}), key=lambda s: s.start)
    if not found:
        return None
    return graph_share_pct(r.trace, [s.name == "tracker.step.detect" for s in found])
