"""fields_per_s (fields/s): the dense flow fields (one a frame pair) that the
device finished inside the window, over the whole window, host clock."""

from portbench.harness.readers import rate as read  # noqa: F401
