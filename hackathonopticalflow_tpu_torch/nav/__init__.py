"""Radial normalization and the robust mask (ports of
hackathonopticalflow_tpu/nav/)."""
