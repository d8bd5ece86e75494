"""pairs_per_s (pairs/s): the frame pairs whose results reached the host inside
the window, over the whole window, host clock."""

from portbench.harness.readers import rate as read  # noqa: F401
