"""device_ms_per_pair.pairs (ms): device busy time per pair in the traced
window."""

from portbench.harness.readers import device_ms_per_answer as read  # noqa: F401
