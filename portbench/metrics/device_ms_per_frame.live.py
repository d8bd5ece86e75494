"""device_ms_per_frame.live (ms): device busy time per frame whose result
reached the host in the traced window."""

from portbench.harness.readers import device_ms_per_answer as read  # noqa: F401
