"""Radial normalization, the robust masks and danger values (ports of
hackathonopticalflow_tpu/nav/)."""
