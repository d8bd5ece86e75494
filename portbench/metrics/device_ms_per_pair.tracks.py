"""device_ms_per_pair.tracks (ms): device busy time (the union) per tracked
pair in the traced window of the tracker cell."""

from portbench.harness.readers import device_ms_per_answer as read  # noqa: F401
