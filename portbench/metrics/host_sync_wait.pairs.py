"""host_sync_wait.pairs (%): the launching thread's blocked share of the
traced window of a cell that reports pairs_per_s."""

from portbench.harness.readers import host_sync_wait_pct as read  # noqa: F401
