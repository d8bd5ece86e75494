"""Grid LK flow and dense Farneback flow (ports of
hackathonopticalflow_tpu/flow/lk_grid.py and flow/dense.py)."""
