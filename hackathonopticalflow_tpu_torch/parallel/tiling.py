"""Spatially tiled dense flow over a rank mesh (port of
hackathonopticalflow_tpu/parallel/tiling.py; SURVEY.md §5.7a).

Design: recompute-in-halo. Each rank owns a contiguous row block of the
frame; one halo exchange per frame extends the block with `halo` rows
from its neighbours, after which the whole Farneback pyramid
(ops/farneback.py, in any warp mode, its warp_bilinear kernel on the
slab-shaped planes) runs on the extended slab with no communication
inside the iterations. The core rows of each slab match the single-device
flow as long as `halo` covers the algorithm's receptive field
(derive_halo). Rows within `halo` of the true frame top and bottom differ
slightly: the slab's border handling and OpenCV's 5-px border band anchor
to the slab edges there.

Tile heights and the halo must be even, so each slab's pyramid grid
starts on an even row of the frame's (INTER_LINEAR's half-pixel centres
shift otherwise). A slab starts at row r H_tile - halo, so deeper levels
need not line up with the frame's, and in the "pallas" modes the slab
warp's (8, 128) tiles start at the slab's row 0: a clamped sample differs
from the single frame's, as in the JAX package's tiled path.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import FarnebackParams
from ..ops.farneback import farneback
from .halo import halo_exchange_rows
from .mesh import Mesh


def derive_halo(params: FarnebackParams = FarnebackParams(), max_displacement: float = 30.0) -> int:
    """Halo rows for the recompute-in-halo scheme to reproduce the
    single-device flow in every core row, from the receptive field at the
    coarsest level (whose pixels span 1/s_min full-resolution rows):

        (win//2 + poly_n + 2) / s_min + max_displacement

    with s_min = pyr_scale**levels, rounded up to an even count. At
    FarnebackParams() and 30 px: (7 + 5 + 2) / 0.125 + 30 = 142."""
    s_min = params.pyr_scale**params.levels
    rf = (params.win_size // 2 + params.poly_n + 2) / s_min + max_displacement
    return int(-(-rf // 2) * 2)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    axis: str = "tile"
    halo: int = 96

    @classmethod
    def for_params(
        cls,
        params: FarnebackParams = FarnebackParams(),
        max_displacement: float = 30.0,
        axis: str = "tile",
    ) -> "TileConfig":
        return cls(axis=axis, halo=derive_halo(params, max_displacement))


def _check(tile_rows: int, halo: int) -> None:
    if tile_rows % 2 or halo % 2:
        raise ValueError("tile height and halo must be even for pyramid alignment")


def _tiled(prev: torch.Tensor, nxt: torch.Tensor, mesh: Mesh, params: FarnebackParams, tile: TileConfig):
    """Rows on dim -2 of (..., H_tile, W) blocks: exchange, flow, crop."""
    _check(prev.shape[-2], tile.halo)

    def ext(x):
        x = x.to(mesh.device).movedim(-2, 0)
        return halo_exchange_rows(x, tile.halo, mesh, tile.axis, mode="edge").movedim(0, -2)

    flow = farneback(ext(prev), ext(nxt), params)
    return flow[..., tile.halo : -tile.halo, :, :]


def tiled_farneback(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    mesh: Mesh,
    params: FarnebackParams = FarnebackParams(),
    tile: TileConfig = TileConfig(),
) -> torch.Tensor:
    """Dense flow of this rank's row block (H_tile, W) of a frame pair
    row-sharded over mesh axis `tile.axis` (shard_rows on dim 0):
    (H_tile, W, 2) on the mesh's device. The frame height must divide
    by the tile count (shard_rows checks); tile height and halo must be
    even."""
    return _tiled(prev, nxt, mesh, params, tile)


def tiled_farneback_multi(
    prev: torch.Tensor,
    nxt: torch.Tensor,
    mesh: Mesh,
    params: FarnebackParams = FarnebackParams(),
    tile: TileConfig = TileConfig(),
) -> torch.Tensor:
    """Stream-batched and row-tiled dense flow: this rank's (B_local,
    H_tile, W) block of (B, H, W) frames sharded (stream, tile) over a 2-D
    mesh (the single-host multi-stream configuration, BASELINE.json
    config 4) -> (B_local, H_tile, W, 2). The rank's streams run as one
    batch; each row equals its own stream's call. Only the tile axis
    exchanges data, so the stream axis is the caller's split alone."""
    return _tiled(prev, nxt, mesh, params, tile)
