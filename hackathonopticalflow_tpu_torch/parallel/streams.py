"""Stream data-parallelism: a batch of independent video streams sharded
over the 'stream' mesh axis (port of
hackathonopticalflow_tpu/parallel/streams.py; SURVEY.md §2.4, BASELINE.json
config 4).

Each rank runs its own block of streams as one stream-batched call on its
device (flow/lk_grid.py: one lk_level launch per level for all of the
rank's streams; ops/farneback.py: one warp_bilinear launch per update).
Per-stream state keeps the time axis sequential and no data crosses
between streams: the robust statistics are per stream.
"""

from __future__ import annotations

import torch

from ..core import FarnebackParams, FilterParams, LKParams, NormalizeParams
from ..flow.lk_grid import GridFlowResult, lk_grid_flow
from ..ops.farneback import farneback
from .mesh import Mesh


def stream_batched_grid_flow(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    pts: torch.Tensor,
    mesh: Mesh,
    lk: LKParams = LKParams(),
    norm: NormalizeParams = NormalizeParams(),
    filt: FilterParams = FilterParams(),
) -> GridFlowResult:
    """This rank's (B_local, H, W) frames of a (B, H, W) batch sharded over
    the stream axis (shard_rows on dim 0), and the shared (N, 2) grid ->
    their GridFlowResult, fields (B_local, N, ...), on the mesh's device.
    Each stream's row equals lk_grid_flow of that stream alone. No data
    crosses ranks: the mesh gives the device."""
    return lk_grid_flow(prev, nxt, pts, lk, norm, filt, device=mesh.device)


def stream_batched_farneback(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    mesh: Mesh,
    params: FarnebackParams = FarnebackParams(),
) -> torch.Tensor:
    """This rank's (B_local, H, W) frames, B sharded over the stream axis
    -> (B_local, H, W, 2) dense flow on the mesh's device."""
    return farneback(prev.to(mesh.device), nxt.to(mesh.device), params)
