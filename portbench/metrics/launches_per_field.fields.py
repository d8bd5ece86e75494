"""launches_per_field.fields (launches/field): kernel and graph launches per
field in the traced window."""

from portbench.harness.readers import launches_per_answer as read  # noqa: F401
