"""Rank meshes and the launcher of a world of ranks (port of
hackathonopticalflow_tpu/parallel/mesh.py).

JAX runs one process over all devices and `shard_map` hands each device
its block. PyTorch is multi-controller: one process per rank
(`torch.distributed`), each holding its own block, so a mesh here is this
rank's view of an n-dimensional grid of ranks: for each named axis, the
process group of the ranks that share every other coordinate. The axes
are the JAX package's:

- 'stream': independent video streams (frame t depends on t-1 within a
  stream, so time is sequential per stream);
- 'tile':   spatial row tiles of one frame (the halo-exchange domain);
- 'win':    keyframes of a bundle-adjustment window (ba_ring.py).

Ranks are ordered row-major over the mesh shape, as np.reshape orders
jax.devices() in the JAX package.

Where ranks run: a launcher (torchrun, or `run_on_mesh` below) starts
them. With NCCL each rank takes its own GPU (cuda:r on one host); with
gloo, ranks on a CUDA device share cuda:0 (one GPU serving several ranks,
as a test of the multi-rank paths on a one-GPU machine) and their
collectives stage through the host (collectives.py); on the CPU, gloo.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from ..flow.device import resolve_device

#: seconds a collective may wait before it raises (init_process_group's
#: timeout): a mismatched collective errors instead of hanging
DEFAULT_TIMEOUT_S = 300.0


class MeshAxis(NamedTuple):
    """One named axis of a mesh as this rank sees it."""

    name: str
    group: dist.ProcessGroup  # the ranks along this axis that share this rank's other coordinates
    index: int  # this rank's position along the axis (lax.axis_index)
    size: int  # lax.axis_size


class Mesh:
    """This rank's view of a (d0, d1, ...) grid of ranks with named axes.

    `shape` maps axis names to sizes (as jax.sharding.Mesh.shape does);
    `device` is where this rank computes. Built by make_mesh: every rank
    of the world builds the same mesh, because creating a process group
    is a collective over the world."""

    def __init__(self, shape: tuple[int, ...], axis_names: tuple[str, ...], device: torch.device):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {shape} and axis names {axis_names} differ in length")
        world, rank = dist.get_world_size(), dist.get_rank()
        n = int(np.prod(shape))
        if n != world:
            raise ValueError(f"mesh {shape} needs {n} ranks, the world has {world}")
        grid = np.arange(n).reshape(shape)
        self.shape = dict(zip(axis_names, shape))
        self.device = device
        self.rank = rank
        self._axes: dict[str, MeshAxis] = {}
        for a, name in enumerate(axis_names):
            # every rank creates every group of the axis, in the same order
            for ranks in np.moveaxis(grid, a, -1).reshape(-1, shape[a]):
                ranks = tuple(int(r) for r in ranks)
                group = dist.new_group(list(ranks))
                if rank in ranks:
                    self._axes[name] = MeshAxis(name, group, ranks.index(rank), len(ranks))

    def axis(self, name: str) -> MeshAxis:
        return self._axes[name]


def rank_device(device: torch.device | str = "cuda") -> torch.device:
    """The device this rank computes on: `device` as given, a CUDA device
    without an index being the current CUDA device (the launcher sets it:
    cuda:r under NCCL, cuda:0 for ranks sharing one GPU over gloo). Raises
    without CUDA unless device is "cpu"."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(shape: tuple[int, ...], axis_names: tuple[str, ...], device: torch.device | str = "cuda") -> Mesh:
    """A mesh over every rank of the initialized world (prod(shape) must
    equal the world size); its device is rank_device(device)."""
    return Mesh(tuple(shape), tuple(axis_names), rank_device(device))


def stream_tile_mesh(n_streams: int, n_tiles: int, device: torch.device | str = "cuda") -> Mesh:
    """('stream', 'tile') mesh: the standard layout for batched tiled flow."""
    return make_mesh((n_streams, n_tiles), ("stream", "tile"), device)


def init_multihost(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str = "nccl",
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> bool:
    """Join a world of ranks spread over hosts: init_process_group at
    tcp://<coordinator> ("host:port" of rank 0) as rank process_id of
    num_processes, or, without a coordinator, from torchrun's environment
    (env://: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT). Does nothing
    when a default group exists, or with neither (one process). Under
    NCCL the rank's GPU is set to LOCAL_RANK (0 if unset). Returns whether
    it started the world. Each process should then decode its own video
    subset (host_local_streams)."""
    if dist.is_initialized():
        return False
    if coordinator is not None:
        where = {"init_method": f"tcp://{coordinator}", "world_size": num_processes, "rank": process_id}
    elif all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")):
        where = {"init_method": "env://"}
    else:
        return False
    dist.init_process_group(backend, timeout=timedelta(seconds=timeout_s), **where)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    return True


def host_local_streams(paths: list[str]) -> list[str]:
    """Partition a video list across ranks (round-robin by rank); every
    path on one process."""
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    return [p for i, p in enumerate(paths) if i % world == rank]


def _rank_main(rank, n, device, backend, tmp, timeout_s):
    """One spawned rank: it reads its function and arguments from a file in
    tmp (through the spawn pipe, megabytes of arguments would make each
    start wait for the previous child to import torch), logs to stderr
    (stdout belongs to the launching process) and writes its result or
    traceback to a file in tmp. It computes with one CPU thread: the ranks
    share the host's cores, and more threads each oversubscribe them (a
    CPU world of 4 ranks ran its dry run 7x slower at torch's default)."""
    os.dup2(2, 1)
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "call.pkl"), "rb") as f:
        fn, args = pickle.load(f)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank if backend == "nccl" else 0)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend,
        init_method=f"file://{os.path.join(tmp, 'store')}",
        world_size=n,
        rank=rank,
        timeout=timedelta(seconds=timeout_s),
        device_id=dev if backend == "nccl" else None,
    )
    try:
        torch.save(fn(dev, *args), os.path.join(tmp, f"rank{rank}.pt"))
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_on_mesh(
    fn: Callable,
    n: int,
    args: tuple = (),
    *,
    device: torch.device | str = "cuda",
    backend: str | None = None,
    timeout_s: float = DEFAULT_TIMEOUT_S,
) -> list:
    """Start a world of n ranks, run fn(device, *args) on each and return
    their results in rank order.

    fn must be importable by name (a module-level function) and its result
    picklable; tensors come back on the CPU. The ranks are spawned
    processes that rendezvous through a file store in a fresh temporary
    directory (no TCP port is taken). backend: "nccl" puts rank r on
    cuda:r and needs n GPUs; "gloo" on a CUDA device puts every rank on
    cuda:0; device="cpu" needs "gloo". None means "nccl" on a CUDA device
    and "gloo" on the CPU.

    The world has timeout_s seconds: then every rank is killed and
    TimeoutError raised; a rank that fails has the others killed and its
    traceback raised as RuntimeError. A collective waits at most timeout_s
    before it raises."""
    import torch.multiprocessing as mp

    dev = torch.device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    if dev.type == "cpu" and backend != "gloo":
        raise ValueError(f"ranks on the CPU need backend='gloo', not {backend!r}")
    if dev.type == "cuda":
        resolve_device(dev)
        if backend == "nccl" and n > torch.cuda.device_count():
            raise ValueError(
                f"backend='nccl' puts each of the {n} ranks on its own GPU and this machine has "
                f"{torch.cuda.device_count()}; pass backend='gloo' to share one GPU between ranks"
            )
    tmp = tempfile.mkdtemp(prefix="run_on_mesh-")
    try:
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        ctx = mp.start_processes(
            _rank_main,
            args=(n, str(dev.type), backend, tmp, timeout_s),
            nprocs=n,
            join=False,
            start_method="spawn",
        )
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=0.1):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"run_on_mesh: {n} ranks of {fn.__name__} did not finish in {timeout_s} s")
        except BaseException as e:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            for p in ctx.processes:
                p.join()
            # the first rank to fail; the others may have failed after it
            # (a peer's closed connection)
            errs = sorted((os.path.join(tmp, f) for f in os.listdir(tmp) if f.endswith(".err")), key=os.path.getmtime)
            if errs and not isinstance(e, TimeoutError):
                with open(errs[0]) as f:
                    first = os.path.basename(errs[0])[:-4]
                    raise RuntimeError(f"run_on_mesh: {first} of {fn.__name__} failed first:\n{f.read()}") from e
            raise
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"), map_location="cpu", weights_only=False)
                for r in range(n)]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
