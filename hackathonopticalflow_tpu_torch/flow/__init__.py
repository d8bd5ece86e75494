"""Grid LK flow, dense Farneback flow and the trajectory tracker (ports of
hackathonopticalflow_tpu/flow/lk_grid.py, flow/dense.py and
flow/tracker.py)."""
