"""launches_per_pair.pairs (launches/pair): kernel and graph launches per
pair in the traced window."""

from portbench.harness.readers import launches_per_answer as read  # noqa: F401
