"""device_idle.fields (%): the device's idle share of the traced window of a
cell that reports fields_per_s."""

from portbench.harness.readers import device_idle_pct as read  # noqa: F401
