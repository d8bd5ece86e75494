"""BENCHMARK.json: every name resolves to its file, the entries keep to
the contract's form, and a new cell, mix or metric needs files only."""

import json
import re

import pytest

import portbench_tiny
from portbench.harness.spec import BENCH_DIR, entry_module, load_benchmark, metric_module, resolve_cell

ROOT = portbench_tiny.ROOT
BENCH = load_benchmark(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    cell = resolve_cell(ROOT, workload)
    entry = entry_module(cell)
    for fn in ("setup", "window", "check"):
        assert callable(getattr(entry, fn))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, "every cell reports a per-layer metric"
    for m in cell.per_layer:
        assert m["moves"] in names
    for m in cell.end_to_end + cell.per_layer:
        assert callable(metric_module(cell, m["name"]).read)
    assert cell.limits and all("limit" in v for v in cell.limits.values())


def test_configurations_resolve_and_are_used():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        with open(ROOT / c["file"]) as f:
            assert json.load(f)["name"] == c["name"]


def test_entries_keep_to_the_contract_form():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"] and BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    every = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({e["name"] for e in every}) == len(every)
    for e in every:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert {w["chips"] for w in BENCH["workloads"]} == {1}


def test_a_new_cell_mix_and_metric_need_only_new_files(tmp_path):
    bench_dir = tmp_path / "bench"
    for sub in ("configs", "traffic", "entries", "limits", "metrics"):
        (bench_dir / sub).mkdir(parents=True)
    (bench_dir / "configs" / "toy.json").write_text(json.dumps({"name": "toy", "height": 8, "width": 8}))
    (bench_dir / "traffic" / "burst.json").write_text(json.dumps({"entry": "toy_entry", "clip_frames": 3}))
    (bench_dir / "entries" / "toy_entry.py").write_text(
        "def setup(ctx):\n    pass\n\ndef window(ctx, t0, deadline):\n    pass\n\n"
        "def check(ctx, win):\n    return {'gap': 0.0}, 0\n")
    (bench_dir / "limits" / "toy.burst.json").write_text(json.dumps({"gap": {"limit": 0}}))
    (bench_dir / "metrics" / "toy_rate.per.py").write_text("def read(r):\n    return 1.0\n")
    bench = {"command": [], "paths": [], "run_seconds": 10,
             "configs": [{"name": "toy", "file": "bench/configs/toy.json"}],
             "workloads": [{"name": "toy.burst", "config": "toy", "traffic": "burst", "chips": 1}],
             "end_to_end": [{"name": "toy_rate", "unit": "x/s", "moves": None, "workloads": ["toy.burst"]}],
             "per_layer": [{"name": "toy_rate.per", "unit": "%", "moves": "toy_rate"}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = resolve_cell(tmp_path, "toy.burst", bench_dir=bench_dir)
    assert cell.config["height"] == 8 and cell.traffic["clip_frames"] == 3
    assert entry_module(cell).check(None, None) == ({"gap": 0.0}, 0)
    assert [m["name"] for m in cell.per_layer] == ["toy_rate.per"]
    assert metric_module(cell, "toy_rate.per").read(None) == 1.0
    with pytest.raises(KeyError):
        resolve_cell(tmp_path, "toy.missing", bench_dir=bench_dir)
    assert BENCH_DIR == ROOT / "portbench"
