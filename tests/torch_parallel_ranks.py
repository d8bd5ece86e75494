"""Rank bodies of the port's multi-rank tests (tests/test_torch_parallel.py,
tests/test_torch_parallel_ba.py, tests/test_torch_cuda.py).

parallel/mesh.py::run_on_mesh spawns the ranks, and a spawned rank imports
the function it runs by module path: so the bodies live here, in a module
that imports torch, numpy and the port and never jax (each body checks
that). Inputs are numpy arrays made by the test from a seed; each body
returns its rank's results, which the test compares in the parent with
the JAX package's shard_map functions on the virtual CPU mesh and with the
port's single-device functions."""

from __future__ import annotations

import sys
import time

import torch

from hackathonopticalflow_tpu_torch import parallel as par
from hackathonopticalflow_tpu_torch.apps.batch_runner import BatchRunnerConfig, run_batch
from hackathonopticalflow_tpu_torch.core import FarnebackParams, LKParams
from hackathonopticalflow_tpu_torch.nav.ba import BAState

HALO_ROWS = 4
HALO_MODES = ("edge", "reflect", "constant")
#: (levels, halo) of the tiled Farneback checks, tiled_farneback at the
#: first and tiled_farneback_multi at the second: derive_halo at 4 px of
#: motion, within the 64-row tiles of a 256-row frame on 4 ranks
TILED_LEVELS = ((1, 32), (2, 60))
GRID_LKS = {"production": LKParams(grid_step=30, compute_err=False), "exact": LKParams()}


def _no_jax() -> None:
    loaded = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "hackathonopticalflow_tpu"))
    if loaded:
        raise RuntimeError(f"a rank loaded jax or the JAX package: {loaded[:5]}")


def parallel_checks(dev: torch.device, inp: dict) -> dict:
    """Halo exchange in every mode and the three statistics on a (4,)
    'tile' mesh; tiled_farneback on it and tiled_farneback_multi on a
    (2, 2) mesh at TILED_LEVELS; stream_batched_grid_flow (in both
    GRID_LKS) and stream_batched_farneback on a (4,) 'stream' mesh (two
    streams a rank)."""
    _no_jax()
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    par.init_multihost("127.0.0.1:1", 4, 0)  # a default group exists: nothing to do
    tiles = par.make_mesh((4,), ("tile",), dev)
    out = {"tile_index": tiles.axis("tile").index, "local_streams": par.host_local_streams(list("abcdefghij"))}
    x = par.shard_rows(t(inp["halo_x"]), tiles, "tile")
    for mode in HALO_MODES:
        out[f"halo_{mode}"] = par.halo_exchange_rows(x, HALO_ROWS, tiles, "tile", mode)
    v = par.shard_rows(t(inp["stat_x"]), tiles, "tile")
    out["median"] = par.distributed_median(v, tiles, "tile")
    out["p99"] = par.distributed_percentile(v, 99.0, tiles, "tile")
    out["hist_q50"] = par.psum_histogram_quantile(v, 50.0, tiles, "tile", 0.0, 40.0)

    idx = torch.tensor([tiles.axis("tile").index])
    out["gathered"] = (par.all_gather(idx, tiles.axis("tile")), par.all_gather(idx, tiles.axis("tile"), tiled=False))

    a, b = (par.shard_rows(t(f), tiles, "tile") for f in inp["pair"])
    levels, halo = TILED_LEVELS[0]
    out["tiled"] = par.tiled_farneback(a, b, tiles, FarnebackParams(levels=levels), par.TileConfig(halo=halo))
    out["tiled_whole"] = par.gather_rows(out["tiled"], tiles, "tile")
    grid = par.stream_tile_mesh(2, 2, dev)
    levels, halo = TILED_LEVELS[-1]
    ab = [par.shard_rows(par.shard_rows(t(f), grid, "stream"), grid, "tile", 1) for f in inp["pairs"]]
    out["multi"] = par.tiled_farneback_multi(*ab, grid, FarnebackParams(levels=levels), par.TileConfig(halo=halo))
    out["multi_coords"] = (grid.axis("stream").index, grid.axis("tile").index)

    streams = par.make_mesh((4,), ("stream",), dev)
    prev, cur = (par.shard_rows(t(f), streams, "stream") for f in inp["streams"])
    for name, lk in GRID_LKS.items():
        out[f"grid_{name}"] = par.stream_batched_grid_flow(prev, cur, t(inp["pts"]), streams, lk=lk)
    out["dense_streams"] = par.stream_batched_farneback(prev, cur, streams, FarnebackParams(levels=1))
    return out


def ba_batch_checks(dev: torch.device, inp: dict) -> dict:
    """For each (name, iters, state) of inp["ba"]: "dist" runs
    distributed_bundle_adjust on a (4,) 'tile' mesh (a quarter of the
    landmarks a rank), "ring" ring_bundle_adjust on a (4,) 'win' mesh (a
    quarter of the keyframes a rank), in the state's dtype. Then, for each
    (streams, runs) of inp["batch"], run_batch over the in-memory streams
    (name -> (T, H, W) uint8) with each of the runs' BatchRunnerConfig
    fields in order (a checkpointed run, then its resume), the hook set:
    "calls" holds this rank's calls of each scenario."""
    _no_jax()
    axes = {"dist": ("tile", par.distributed_bundle_adjust, par.shard_landmarks),
            "ring": ("win", par.ring_bundle_adjust, par.shard_keyframes)}
    meshes = {name: par.make_mesh((4,), (axis,), dev) for name, (axis, _, _) in axes.items()}
    out = {"ba": []}
    for name, iters, arrs in inp["ba"]:
        axis, fn, shard = axes[name]
        mesh = meshes[name]
        st, stats = fn(shard(BAState(*map(torch.from_numpy, arrs)), mesh, axis), mesh, axis, iters=iters)
        out["ba"].append((st.rvecs, st.tvecs, st.points, stats))
    out["batch"], out["calls"] = [], []
    for streams, runs in inp["batch"]:
        calls = []
        out["batch"].append(batch_runs(dev, streams, runs, calls))
        out["calls"].append(calls)
    return out


def batch_runs(dev: torch.device | str, streams: dict, runs: list[dict], calls: list | None = None) -> list[dict]:
    """run_batch over the in-memory `streams` with each of `runs`'
    BatchRunnerConfig fields, in order, on `dev`. With `calls`, the hook
    is set and appends (run, stream, pair, the result's `good` sum) to
    it."""
    from chip_smoke import ClipReader

    out = []
    for j, kw in enumerate(runs):
        hook = None
        if calls is not None:
            def hook(stream, pair, res, j=j):
                calls.append((j, stream, pair, int(res.good.sum())))
        out.append(run_batch(BatchRunnerConfig(videos=list(streams), device=str(dev), on_result=hook,
                                               open_reader=lambda path: ClipReader(streams[path]), **kw)))
    return out


def cuda_checks(dev: torch.device, inp: dict) -> dict:
    """Halo exchange in every mode and stream_batched_grid_flow at the
    production LKParams on CUDA tensors over gloo (ranks sharing one GPU),
    with the kernel launches of the grid flow."""
    from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level

    _no_jax()
    n = inp["ranks"]
    tiles = par.make_mesh((n,), ("tile",), dev)
    x = par.shard_rows(torch.from_numpy(inp["halo_x"]), tiles, "tile")
    out = {f"halo_{m}": par.halo_exchange_rows(x, HALO_ROWS, tiles, "tile", m) for m in HALO_MODES}
    streams = par.make_mesh((n,), ("stream",), dev)
    prev, cur = (par.shard_rows(torch.from_numpy(f), streams, "stream") for f in inp["streams"])
    lk_level.launches = 0
    out["grid"] = par.stream_batched_grid_flow(prev, cur, torch.from_numpy(inp["pts"]), streams,
                                               lk=GRID_LKS["production"])
    torch.cuda.synchronize(dev)
    out["lk_level_launches"] = lk_level.launches
    return out


def failing(dev: torch.device, fail_rank: int) -> None:
    """Rank fail_rank raises at once; the others wait in a psum that rank
    never joins."""
    mesh = par.make_mesh((torch.distributed.get_world_size(),), ("x",), dev)
    if mesh.rank == fail_rank:
        raise ValueError(f"rank {fail_rank} fails on purpose")
    par.psum(torch.ones(1), mesh.axis("x"))


def sleeping(dev: torch.device, seconds: float) -> None:
    time.sleep(seconds)
