"""The collectives of one named mesh axis: the port's counterparts of the
`lax` collectives the JAX package calls inside shard_map (axis_size,
axis_index, ppermute, psum, all_gather), over that axis's process group.
Group positions are translated to global ranks with
dist.get_global_rank.

Two routes, chosen by the group's backend and the tensor's device, never
by a failure:
- NCCL, or gloo on CPU tensors: the tensors go to the collective as they
  are; ppermute is one dist.batch_isend_irecv.
- gloo on CUDA tensors (ranks sharing one GPU): gloo moves host memory
  only, so each tensor is staged through a pinned host buffer, the
  collective runs there and the result is copied back to the tensor's
  device. This is the only place the package stages through the host.

Also the two helpers of the SPMD contract (see parallel/__init__.py):
shard_rows splits a global array into this rank's block along one axis,
gather_rows assembles the blocks again on every rank.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .mesh import Mesh, MeshAxis


def axis_size(axis: MeshAxis) -> int:
    return axis.size


def axis_index(axis: MeshAxis) -> int:
    return axis.index


def _staged(x: torch.Tensor, axis: MeshAxis) -> bool:
    """True on the gloo route for CUDA tensors (staged through the host)."""
    return x.is_cuda and dist.get_backend(axis.group) == "gloo"


def _to_host(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    h.copy_(x)
    return h


def ppermute(x: torch.Tensor, perm: list[tuple[int, int]], axis: MeshAxis) -> torch.Tensor:
    """lax.ppermute: for each (src, dst) pair of axis positions, dst
    receives src's x; a position no pair sends to gets zeros. A pair (i, i)
    is a local copy."""
    me = axis.index
    x = x.contiguous()
    out = torch.zeros_like(x)
    staged = _staged(x, axis)
    send = _to_host(x) if staged else x
    recv = torch.zeros(x.shape, dtype=x.dtype, pin_memory=True) if staged else out
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, send, dist.get_global_rank(axis.group, dst), group=axis.group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(axis.group, src), group=axis.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        if staged and any(dst == me and src != me for src, dst in perm):
            out.copy_(recv)
    return out


def psum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """lax.psum: the sum of x over the axis, on every rank of it."""
    if _staged(x, axis):
        h = _to_host(x)
        dist.all_reduce(h, group=axis.group)
        return h.to(x.device)
    out = x.clone(memory_format=torch.contiguous_format)  # NCCL takes contiguous tensors only
    dist.all_reduce(out, group=axis.group)
    return out


def all_gather(x: torch.Tensor, axis: MeshAxis, tiled: bool = True) -> torch.Tensor:
    """lax.all_gather: every rank's x in axis order, concatenated along
    dim 0 (tiled) or stacked on a new leading dim."""
    src = _to_host(x) if _staged(x, axis) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    out = torch.cat(parts) if tiled else torch.stack(parts)
    return out.to(x.device)


def shard_rows(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """This rank's contiguous block of x along dim (as PartitionSpec places
    the axis on that dim), on the mesh's device. The length of dim must be
    divisible by the axis size."""
    ax = mesh.axis(axis)
    length = x.shape[dim]
    if length % ax.size:
        raise ValueError(f"size {length} of dim {dim} not divisible by the {ax.size} ranks of axis {axis!r}")
    block = length // ax.size
    return x.narrow(dim, ax.index * block, block).to(mesh.device)


def gather_rows(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The blocks of every rank of the axis, concatenated along dim in axis
    order (the global array), on every rank."""
    return all_gather(x.movedim(dim, 0), mesh.axis(axis)).movedim(0, dim)
