"""device_ms_per_field.fields (ms): device busy time per field in the traced
window."""

from portbench.harness.readers import device_ms_per_answer as read  # noqa: F401
