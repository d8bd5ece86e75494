"""gray_ms.pairs (ms): the median over the traced window's frames of the
prefetch thread's gray conversion of a frame (`prefetch.gray`): the frame
stage's work a frame, which sets the review's pace when it exceeds the
device's time a pair."""

from portbench.harness.spans import host_ms_per_key

NAMES = ("prefetch.gray",)


def read(r):
    return host_ms_per_key(r, NAMES, "prefetch.gray")
