"""Frame preparation, grid templates, the window kernel, the rect gather
kernel, the LK level kernel, pyramidal LK, Shi-Tomasi corners, statistics,
color conversions, dense image primitives, the coefficient warp kernel and
Farneback (ports of hackathonopticalflow_tpu/ops/)."""
