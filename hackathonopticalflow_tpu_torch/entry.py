"""The port's counterparts of the repository's __graft_entry__.py:

entry():            one single-device step of the flagship pipeline (grid
                    LK flow -> radial normalize -> robust filter -> danger
                    values and FOE, beside the dense Farneback field) with
                    example arguments at 720p.
dryrun_multichip(n): starts a world of n ranks (parallel/mesh.py::
                    run_on_mesh) and runs the five distributed paths once
                    at the JAX dry run's shapes: stream DP x row-tiled dense
                    flow with halo exchange, stream-batched grid LK, the
                    psum-histogram quantile, landmark-sharded BA and
                    ring-scheduled BA.
"""

from __future__ import annotations

import numpy as np
import torch

from .core import FarnebackParams, LKParams, measurement_grid
from .flow.dense import farneback_flow
from .flow.device import resolve_device
from .flow.lk_grid import lk_grid_flow
from .nav.ba import BAState, rodrigues
from .nav.danger import danger_values
from .nav.foe import estimate_foe
from .ops.lk_level import lk_level
from .ops.patch_bilinear import patch_bilinear
from .ops.warp_bilinear import warp_bilinear
from .parallel import (
    TileConfig,
    distributed_bundle_adjust,
    make_mesh,
    psum_histogram_quantile,
    ring_bundle_adjust,
    run_on_mesh,
    shard_keyframes,
    shard_landmarks,
    shard_rows,
    stream_batched_grid_flow,
    tiled_farneback_multi,
)
from .parallel.mesh import DEFAULT_TIMEOUT_S


def entry(device: torch.device | str = "cuda", h: int = 720, w: int = 1280):
    """(step, example_args): step(prev_gray, gray) on (h, w) float32 frames
    in [0, 255] returns a dict of the grid flow (JAX's default LKParams(),
    the exact path), its `good` mask, the danger values, the FOE and its
    residual, and the dense flow at FarnebackParams(); example_args are two
    seeded uniform-noise frames on `device` (the GPU unless "cpu")."""
    dev = resolve_device(device)
    pts = torch.from_numpy(measurement_grid(h, w, 30)).to(dev)

    def step(prev_gray: torch.Tensor, gray: torch.Tensor) -> dict:
        res = lk_grid_flow(prev_gray, gray, pts, device=dev)
        danger = danger_values(res.modulus)
        foe, foe_resid = estimate_foe(res.pts.to(torch.float32), res.flow.to(torch.float32), res.good)
        dense = farneback_flow(prev_gray, gray, FarnebackParams(), device=dev)
        return {
            "flow": res.flow,
            "good": res.good,
            "danger": danger,
            "foe": foe,
            "foe_resid": foe_resid,
            "dense_flow": dense,
        }

    rng = np.random.RandomState(0)
    prev = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(dev)
    cur = torch.from_numpy(rng.uniform(0, 255, (h, w)).astype(np.float32)).to(dev)
    return step, (prev, cur)


def dryrun_multichip(
    n_devices: int,
    device: torch.device | str = "cuda",
    backend: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> list[dict]:
    """Run the full distributed surface once on a world of n_devices ranks
    (run_on_mesh's device and backend: "nccl" puts a rank on each GPU,
    "gloo" on a CUDA device shares cuda:0, device="cpu" runs gloo on the
    CPU). The shapes of __graft_entry__.py::dryrun_multichip: a
    (stream, tile) mesh of 2 x n/2 for even n >= 4 (else 1 x n), 128-row
    tiles of 192 px, halo 32, FarnebackParams(levels=2, win_size=11,
    iterations=2), LKParams(win_size=(9, 9), max_level=1, max_iters=3) on
    a step-16 grid, the q99 histogram over the tile axis, and both BAs on
    a flat ("win",) mesh with 2n keyframes and 64n landmarks for 3
    iterations. Raises unless every result is finite and each BA's cost
    is at most 1.01 x its initial cost; returns each rank's sums, costs
    and kernel launches."""
    return run_on_mesh(_dryrun_rank, n_devices, (n_devices,), device=device, backend=backend, timeout_s=timeout_s)


def _dryrun_mesh(dev: torch.device, n_devices: int):
    """The dry run's (stream, tile) mesh: 2 x n/2 for even n >= 4, else
    1 x n."""
    if n_devices % 2 == 0 and n_devices >= 4:
        return make_mesh((2, n_devices // 2), ("stream", "tile"), dev)
    return make_mesh((1, n_devices), ("stream", "tile"), dev)


def _dryrun_flow(mesh, rng: np.random.RandomState) -> tuple:
    """The dry run's flow paths on this rank: tiled dense flow and
    stream-batched grid LK on 128-row tiles, and the q99 histogram of the
    dense magnitudes over the tile axis. Returns (dense, sparse, q99)."""
    n_streams, n_tiles = mesh.shape["stream"], mesh.shape["tile"]
    # 1 + 2: tiled dense flow and stream-batched sparse LK, 128-row tiles
    h, w, b = 128 * n_tiles, 192, n_streams * 2
    pts = torch.from_numpy(measurement_grid(h, w, 16))
    fb = FarnebackParams(levels=2, win_size=11, iterations=2)
    lk = LKParams(win_size=(9, 9), max_level=1, max_iters=3)
    tile = TileConfig(halo=32)
    prev = torch.from_numpy(rng.uniform(0, 255, (b, h, w)).astype(np.float32))
    cur = torch.from_numpy(rng.uniform(0, 255, (b, h, w)).astype(np.float32))
    prev_s, cur_s = shard_rows(prev, mesh, "stream"), shard_rows(cur, mesh, "stream")
    dense = tiled_farneback_multi(
        shard_rows(prev_s, mesh, "tile", 1), shard_rows(cur_s, mesh, "tile", 1), mesh, fb, tile
    )
    # the sparse flow shards only the streams: every tile of a stream
    # computes its streams' grid on the whole frames
    sparse = stream_batched_grid_flow(prev_s, cur_s, pts, mesh, lk=lk)
    # 5: the q99 of the dense magnitudes over the tile axis
    q99 = psum_histogram_quantile(torch.linalg.vector_norm(dense, dim=-1), 99.0, mesh, "tile", 0.0, 64.0)
    return dense, sparse, q99


def _dryrun_rank(dev: torch.device, n_devices: int) -> dict:
    """One rank of dryrun_multichip: every rank draws the same global
    arrays from the seed and takes its block."""
    mesh = _dryrun_mesh(dev, n_devices)
    flat = make_mesh((n_devices,), ("win",), dev)
    rng = np.random.RandomState(0)
    dense, sparse, q99 = _dryrun_flow(mesh, rng)
    out = {
        "dense_abs": float(dense.abs().sum()),
        "sparse_modulus": float(sparse.modulus.sum()),
        "good": int(sparse.good.sum()),
        "q99": float(q99),
    }
    if not all(np.isfinite(v) for v in out.values()):
        raise RuntimeError(f"multichip flow step produced non-finite output: {out}")

    # 3 + 4: windowed BA, landmark-sharded (psum Schur) and ring-scheduled
    m_kf, n_land = 2 * n_devices, 64 * n_devices
    cs = np.cumsum(rng.normal([0, 0, 0.3], 0.05, (m_kf, 3)), 0)
    angs = np.cumsum(rng.normal(0, 0.01, (m_kf, 3)), 0)
    x3 = rng.uniform([-3, -2, 4], [3, 2, 12], (n_land, 3))
    obs = np.zeros((m_kf, n_land, 2), np.float32)
    rvecs = np.zeros((m_kf, 3), np.float32)
    tvecs = np.zeros((m_kf, 3), np.float32)
    for k in range(m_kf):
        r = rodrigues(torch.tensor(angs[k], dtype=torch.float32)).numpy()
        pc = (r @ (x3 - cs[k]).T).T
        obs[k] = pc[:, :2] / pc[:, 2:3]
        rvecs[k] = angs[k]
        tvecs[k] = -(r @ cs[k])
    state = BAState(
        rvecs=torch.from_numpy(rvecs) + 0.01,
        tvecs=torch.from_numpy(tvecs) + 0.01,
        points=torch.tensor(x3, dtype=torch.float32) + 0.05,
        obs=torch.from_numpy(obs),
        mask=torch.ones((m_kf, n_land), dtype=torch.bool),
    )
    for name, fn, shard in (("ba_dist", distributed_bundle_adjust, shard_landmarks),
                            ("ba_ring", ring_bundle_adjust, shard_keyframes)):
        _, stats = fn(shard(state, flat, "win"), flat, "win", iters=3)
        cost, init = float(stats.cost), float(stats.initial_cost)
        if not np.isfinite(cost):
            raise RuntimeError(f"{name}: non-finite cost")
        if cost > init * 1.01:
            raise RuntimeError(f"{name}: cost {cost} above 1.01 x the initial {init}")
        out[f"{name}_cost"], out[f"{name}_initial_cost"] = cost, init
    # the kernels this rank launched (on a GPU; the plain versions run on
    # the CPU and count nothing)
    out["launches"] = {"lk_level": lk_level.launches, "patch_bilinear": patch_bilinear.launches,
                       "warp_bilinear": warp_bilinear.launches}
    return out
