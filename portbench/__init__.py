"""The benchmark of the PyTorch and CUDA port (`hackathonopticalflow_tpu_torch`).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>`
runs one cell of `BENCHMARK.json` once on the card it finds and prints one
JSON line. Everything a cell needs is found by name: its configuration in
`configs/<name>.json`, its traffic mix in `traffic/<name>.json` (which names
the entry module in `entries/<entry>.py`), its correctness limits in
`limits/<cell>.json`, and each per-layer metric's reader in
`metrics/<name>.py`. Nothing here imports `jax` or the JAX package.
"""
