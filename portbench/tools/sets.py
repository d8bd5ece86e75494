#!/usr/bin/env python3
"""Runs cells of the benchmark several times, one process a run, one after
another, and keeps every result line: the way sets of runs are measured
for the bounds and seeds are read for the limits.

    python3 portbench/tools/sets.py --out <results>.jsonl \
        --run <workload>:<seed>:<seconds>:<trace>[:control] [--run ...] \
        [--set <workload>:<seconds>:<first seed>:<count>]

`--set` is `count` runs of one cell at seeds first, first + 1, ...; a run
with a trailing `:control` passes --control. Each run's result line (or
its exit code and the end of its output) goes to --out as one JSON
object, with the card's name and power limit; a summary of each run is
printed, and per cell and trace mode the median and the quartile spread
(statistics.quantiles, n=4, as a share of the median) of each metric.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def spread(values: list[float]) -> float:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else float("nan")


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--run", action="append", default=[])
    p.add_argument("--set", action="append", default=[])
    p.add_argument("--timeout", type=float, default=1200)
    args = p.parse_args()
    runs = [r.split(":") for r in args.run]
    for s in args.set:
        w, secs, first, count = s.split(":")
        runs += [[w, str(int(first) + i), secs, "0"] for i in range(int(count))]
    gpu = card()
    print(f"card: {gpu}", flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    groups = defaultdict(lambda: defaultdict(list))
    with out.open("a") as f:
        for r in runs:
            w, seed, secs, trace = r[:4]
            control = len(r) > 4 and r[4] == "control"
            cmd = [sys.executable, "portbench/run.py", "--workload", w, "--seed", seed, "--seconds", secs,
                   "--trace", trace] + (["--control"] if control else [])
            started = time.time()
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=args.timeout)
            took = time.perf_counter() - t0
            rec = {"workload": w, "seed": int(seed), "seconds": float(secs), "trace": int(trace),
                   "control": control, "rc": proc.returncode, "took_s": took, "card": gpu, "started": started}
            rec["stderr_log"] = [ln for ln in proc.stderr.splitlines() if ln.startswith("portbench:")][-12:]
            lines = proc.stdout.strip().splitlines()
            try:
                rec["result"] = json.loads(lines[-1])
            except (IndexError, json.JSONDecodeError):
                rec["stdout_tail"] = proc.stdout[-3000:]
                rec["stderr_tail"] = proc.stderr[-6000:]
            f.write(json.dumps(rec) + "\n")
            f.flush()
            res = rec.get("result")
            if res is None:
                print(f"{w} seed {seed} trace {trace}{' control' if control else ''}: rc {proc.returncode} "
                      f"after {took:.1f} s\n{proc.stderr[-4000:]}", flush=True)
                continue
            metrics = {k: v["value"] for k, v in res["metrics"].items()}
            checks = {k: v["value"] for k, v in res["checks"].items()}
            dev = {k: v for k, v in res["device"].items() if k not in ("platform", "kind")}
            print(f"{w} seed {seed} trace {trace}{' control' if control else ''}: rc {proc.returncode} took "
                  f"{took:.1f} s correct {res['correct']} attempted {res['attempted']} failed {res['failed']} "
                  f"metrics {metrics} checks {checks} device {dev} notes {res.get('notes')}", flush=True)
            print("  " + "; ".join(ln[len("portbench: "):] for ln in rec["stderr_log"]), flush=True)
            if "breakdown" in res:
                print(f"  breakdown {json.dumps(res['breakdown'])}", flush=True)
            if not control:
                for k, v in metrics.items():
                    groups[(w, trace)][k].append(v)
    for (w, trace), ms in groups.items():
        for k, vals in ms.items():
            if len(vals) >= 2:
                line = f"{w} trace {trace} {k}: n {len(vals)} median {statistics.median(vals)!r}"
                if len(vals) >= 3:
                    line += f" spread {spread(vals)!r}"
                print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
