"""syncs_per_frame.live (syncs/frame): the stream, event, device and copy
synchronizations of the app's launching thread per frame in the traced
window."""

from portbench.harness.readers import syncs_per_answer as read  # noqa: F401
