"""Tiny CPU versions of the benchmark's cells for its tests: the real
cell with its frames cut to 180x320 (LK) or 90x160 (Farneback), clips of
5 frames, chunks of 3 pairs, run through the port's plain versions on the
CPU. Importing this module puts the repository root on sys.path."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.harness.cell import run_cell  # noqa: E402
from portbench.harness.spec import load_benchmark, resolve_cell  # noqa: E402

SEED = 2**31 + 977  # past 32 signed bits, as a benchmark seed may be


def cells() -> list[str]:
    return [w["name"] for w in load_benchmark(ROOT)["workloads"]]


def tiny_cell(workload: str):
    cell = resolve_cell(ROOT, workload)
    cell.config = copy.deepcopy(cell.config)
    if "lk" in cell.config:
        cell.config.update(height=180, width=320)
    else:
        cell.config.update(height=90, width=160)
    cell.traffic = dict(cell.traffic, clip_frames=5)
    if "chunk" in cell.traffic:
        cell.traffic["chunk"] = 3
    return cell


def run_tiny(workload: str, seconds: float = 0.6, trace: bool = False, control: bool = False,
             seed: int = SEED) -> dict:
    """One run of the tiny cell on the CPU: the result line's keys, and
    the run's context and window under "_ctx" and "_window"."""
    return run_cell(ROOT, workload, seed, seconds, trace, device="cpu", control=control, cell=tiny_cell(workload))
