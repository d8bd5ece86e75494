#!/usr/bin/env python3
"""Where the time goes in the port's sparse 1080p scan, on one CUDA GPU.

Run from the repository root:

    python3 profile_torch_scan.py [--pairs 8] [--out PATH]

Drives `lk_grid_flow_video` over `--pairs` pairs of chip_smoke.py's
synthetic zoom clip at the production params and prints:
- the GPU's name and power limit (nvidia-smi);
- the scan's wall time without the profiler (best of 3) and the device
  time that torch.profiler records over one more scan, so the device's
  busy share is device time / wall time;
- host API calls per pair (kernel launches, stream syncs, memcpys);
- device time by kind of kernel (lk_level, index/gather, elementwise, ...);
- stage times from CUDA events for one pair: prepare_frame, level_inputs
  and lk_level per level, pyr_lk_prepared, _post_lk.
The full profiler tables go to --out (default
build/profile_torch_scan.txt); the last line is the summary as one JSON
object.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import H, W, cuda_ms, make_clip
from hackathonopticalflow_tpu_torch.core import FilterParams, LKParams, NormalizeParams, measurement_grid
from hackathonopticalflow_tpu_torch.flow import lk_grid
from hackathonopticalflow_tpu_torch.ops import lk as lk_mod
from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level

KINDS = (
    ("lk_level", ("lk_level",)),
    ("index/gather", ("index", "gather")),
    ("sort", ("sort",)),
    ("elementwise", ("elementwise", "reduce")),
    ("memcpy/memset", ("memcpy", "memset")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=8)
    ap.add_argument("--out", type=Path, default=Path("build/profile_torch_scan.txt"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_scan: needs a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    params = LKParams(grid_step=30, compute_err=False)
    clip = make_clip(dev)[: args.pairs + 1]
    pts = torch.from_numpy(measurement_grid(H, W, params.grid_step)).to(dev)

    def scan():
        return lk_grid.lk_grid_flow_video(clip, pts, lk=params)

    scan()  # builds the kernel, warms the caching allocator
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scan()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_ms = min(walls) * 1e3

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        scan()
        torch.cuda.synchronize()
    events = prof.events()
    dev_us = collections.Counter()
    for e in events:
        if e.device_type == DeviceType.CUDA:
            dev_us[kind_of(e.name)] += e.time_range.elapsed_us()
    api = collections.Counter(
        e.name for e in events if e.device_type == DeviceType.CPU and e.name.startswith("cuda")
    )
    device_ms = sum(dev_us.values()) / 1e3
    launches = sum(n for name, n in api.items() if name.startswith("cudaLaunch"))

    # stage times on one pair (backward: template from frame 1, search in 0)
    grid_np = measurement_grid(H, W, params.grid_step)
    grid_xy = (np.unique(grid_np[:, 0]).astype(int), np.unique(grid_np[:, 1]).astype(int))
    cur = lk_mod.prepare_frame(clip[1], params)
    prev = lk_mod.prepare_frame(clip[0], params)
    stages = {"prepare_frame": cuda_ms(lambda: lk_mod.prepare_frame(clip[1], params), 10)}
    center = pts * (1.0 / (1 << params.max_level))
    status = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    for level in range(params.max_level, -1, -1):
        if level != params.max_level:
            center = center * 2.0
        stages[f"level_inputs L{level}"] = cuda_ms(
            lambda: lk_mod.level_inputs(cur, prev, grid_xy, center, level, params), 10
        )
        lvl_args, statics = lk_mod.level_inputs(cur, prev, grid_xy, center, level, params)
        stages[f"lk_level L{level}"] = cuda_ms(lambda: lk_level(*lvl_args, status, **statics), 10)
        tl, status = lk_level(*lvl_args, status, **statics)
        center = tl + lk_mod._halfwin(params, dev)
    res = lk_mod.pyr_lk_prepared(cur, prev, pts, params)
    stages["pyr_lk_prepared"] = cuda_ms(lambda: lk_mod.pyr_lk_prepared(cur, prev, pts, params), 10)
    stages["_post_lk"] = cuda_ms(
        lambda: lk_grid._post_lk(res, pts, H, W, NormalizeParams(), FilterParams()), 10
    )

    args.out.parent.mkdir(parents=True, exist_ok=True)
    with args.out.open("w") as f:
        f.write(f"{smi}\n")
        f.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
        f.write("\n")
        f.write(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=25))
    print(f"scan {args.pairs} pairs 1080p: wall {wall_ms:.2f} ms unprofiled (best of 3), "
          f"device {device_ms:.3f} ms profiled, busy share {device_ms / wall_ms:.3f}")
    print("host API calls per pair: "
          + ", ".join(f"{k} {v / args.pairs:.1f}" for k, v in api.most_common(6)))
    print("device time by kind (ms, share): " + ", ".join(
        f"{k} {v / 1e3:.3f} ({v / 1e3 / device_ms:.3f})" for k, v in dev_us.most_common()))
    print("stage times, one pair (ms, CUDA events, mean of 10): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items()))
    print(f"profiler tables: {args.out}")
    print(json.dumps({
        "gpu": smi, "pairs": args.pairs, "wall_ms": wall_ms, "device_ms": device_ms,
        "busy_share": device_ms / wall_ms, "launches_per_pair": launches / args.pairs,
        "api_calls": dict(api), "device_ms_by_kind": {k: v / 1e3 for k, v in dev_us.items()},
        "stage_ms": stages,
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
