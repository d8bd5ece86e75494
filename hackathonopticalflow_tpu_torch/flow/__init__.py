"""Grid LK flow (port of hackathonopticalflow_tpu/flow/lk_grid.py)."""
