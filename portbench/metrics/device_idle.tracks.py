"""device_idle.tracks (%): the device's idle share of the traced window of
the tracker cell."""

from portbench.harness.readers import device_idle_pct as read  # noqa: F401
