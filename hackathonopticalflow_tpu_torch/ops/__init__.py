"""Frame preparation, grid templates, the LK level kernel, pyramidal LK,
statistics, dense image primitives, the coefficient warp kernel and
Farneback (ports of hackathonopticalflow_tpu/ops/)."""
