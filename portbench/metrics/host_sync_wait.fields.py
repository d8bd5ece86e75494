"""host_sync_wait.fields (%): the launching thread's blocked share of the
traced window of a cell that reports fields_per_s."""

from portbench.harness.readers import host_sync_wait_pct as read  # noqa: F401
