"""Frame preparation, grid templates, the LK level kernel, pyramidal LK and
statistics (ports of hackathonopticalflow_tpu/ops/)."""
