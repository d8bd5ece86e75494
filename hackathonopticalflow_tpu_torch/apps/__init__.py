"""Applications on the port (ports of hackathonopticalflow_tpu/apps/)."""
