#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the card of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It exits non-zero and prints no result
without CUDA or with fewer cards than the cell asks for, when a file the
cell needs is missing, or when jax or the JAX package is loaded. Else its
last standard output line is one JSON object: `correct`, `attempted`,
`failed`, `metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), `device`, with --trace 1 `breakdown`, and last
`checks`, each number the correctness check compared beside its limit;
the same numbers are the last lines of standard error.

Build and kernel caches stay at fixed paths inside the checkout
(build/), so only a checkout's first run builds. `--control` runs the
cell's correctness control in place of the port's answers (see PERF.md);
the benchmark's own runs never pass it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    """Caches at fixed paths inside the checkout; no library may pull
    in jax on its own; one process with few threads on a fixed set of
    CPUs. On the card's 8-CPU machine, a run free to move over every CPU
    with a CPU thread pool the size of the machine read its live latency
    with a run-to-run spread of 4.7% (median) and 18% (95th percentile);
    one pool thread and 4 CPUs read 1.1% and 4.3% (PERF.md §2)."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "nv_compute_cache")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) >= 6:
        # CPUs 0 and 1 are left to the system's own work
        os.sched_setaffinity(0, cpus[2:6])
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # the script's own directory would shadow top-level modules
    sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    _environment()

    from portbench.harness.guard import forbidden_loaded
    from portbench.harness.spec import resolve_cell

    cell = resolve_cell(ROOT, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); this machine has {n}",
              file=sys.stderr)
        return 2
    from portbench.harness.cell import run_cell

    out = run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace), device="cuda:0",
                   control=args.control, t_start=T_START, cell=cell)
    found = forbidden_loaded()
    if found:
        print(f"portbench: the process holds {found}; nothing here may load jax or the JAX package",
              file=sys.stderr)
        return 3
    out.pop("_ctx")
    out.pop("_window")
    for name, c in out["checks"].items():
        ok = c["value"] <= c["limit"]
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {'ok' if ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
