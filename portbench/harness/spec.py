"""BENCHMARK.json and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix. The
configuration's file is the one `configs` gives it; the traffic mix is
`traffic/<traffic>.json`, which names its entry module
`entries/<entry>.py`; the cell's correctness limits are
`limits/<cell>.json`; a per-layer metric is read by `metrics/<name>.py`.
A later cell, mix or metric is added by adding files and entries; no
file here needs an edit for it."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

BENCH_DIR = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # the cell's end-to-end metric entries
    per_layer: list  # the cell's per-layer metric entries
    bench_dir: Path


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _for_cell(metric: dict, cell: str, e2e_of_cell: set | None = None) -> bool:
    """Whether a metric is reported in `cell`: the cells its `workloads`
    list, or without the key, every cell (a per-layer metric: every cell
    that reports the end-to-end metric it moves)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if e2e_of_cell is None:
        return True
    return metric["moves"] in e2e_of_cell


def load_module(path: Path) -> ModuleType:
    """Imports the file at `path` as a module of its own; names with dots
    (`device_idle.pairs.py`) are welcome."""
    if not path.is_file():
        raise FileNotFoundError(path)
    mod_name = "portbench_file_" + re.sub(r"\W", "_", str(path.relative_to(path.parents[1])))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def resolve_cell(root: Path, workload: str, bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell `workload` of root/BENCHMARK.json with every file it needs
    read; raises KeyError or FileNotFoundError for a name that resolves to
    nothing."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config_entry = configs[w["config"]]
    with open(root / config_entry["file"]) as f:
        config = json.load(f)
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(bench_dir / "limits" / f"{workload}.json") as f:
        limits = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _for_cell(m, workload)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _for_cell(m, workload, e2e_names)]
    return Cell(workload, w["config"], w["traffic"], int(w["chips"]), config, traffic, limits, e2e, per_layer,
                bench_dir)


def entry_module(cell: Cell) -> ModuleType:
    return load_module(cell.bench_dir / "entries" / f"{cell.traffic['entry']}.py")


def metric_module(cell: Cell, name: str) -> ModuleType:
    return load_module(cell.bench_dir / "metrics" / f"{name}.py")
