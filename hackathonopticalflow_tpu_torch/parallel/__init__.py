"""Rank meshes, stream data-parallelism, spatial tiling with halo
exchange, distributed bundle adjustment and robust statistics over
torch.distributed (port of hackathonopticalflow_tpu/parallel).

The SPMD contract. JAX runs these paths as one process over a device mesh
(shard_map hands each device its block). Here each rank is a process
(torch.distributed; started by torchrun or mesh.run_on_mesh), and every
function of this package is what the JAX function's shard_map body
computes:
- every rank of the mesh calls it, with its own block;
- it returns that rank's block (replicated results, such as BA poses or
  a quantile, come back equal on every rank);
- the caller splits global arrays into blocks (shard_rows, or
  ba_dist.shard_landmarks / ba_ring.shard_keyframes) and assembles them
  again (gather_rows).
The collectives of one mesh axis are in collectives.py; with gloo on CUDA
tensors they stage through the host there and nowhere else.

Imports are eager: nothing here must run before a runtime initializes
(the JAX package's lazy exports exist for jax.distributed.initialize).
"""

from .ba_dist import distributed_bundle_adjust, shard_landmarks
from .ba_ring import ring_bundle_adjust, shard_keyframes
from .collectives import all_gather, axis_index, axis_size, gather_rows, ppermute, psum, shard_rows
from .halo import halo_exchange_rows
from .mesh import Mesh, host_local_streams, init_multihost, make_mesh, rank_device, run_on_mesh, stream_tile_mesh
from .quantile import distributed_median, distributed_percentile, psum_histogram_quantile
from .streams import stream_batched_farneback, stream_batched_grid_flow
from .tiling import TileConfig, derive_halo, tiled_farneback, tiled_farneback_multi

__all__ = [
    "make_mesh",
    "stream_tile_mesh",
    "init_multihost",
    "host_local_streams",
    "halo_exchange_rows",
    "distributed_median",
    "distributed_percentile",
    "psum_histogram_quantile",
    "tiled_farneback",
    "tiled_farneback_multi",
    "TileConfig",
    "stream_batched_grid_flow",
    "stream_batched_farneback",
    "distributed_bundle_adjust",
    "ring_bundle_adjust",
    # the port's own: the mesh class and launcher, the collectives, the
    # SPMD helpers
    "Mesh",
    "rank_device",
    "run_on_mesh",
    "axis_size",
    "axis_index",
    "ppermute",
    "psum",
    "all_gather",
    "shard_rows",
    "gather_rows",
    "shard_landmarks",
    "shard_keyframes",
    "derive_halo",
]
