"""Captured CUDA graphs: the port's counterpart of `jax.jit` for the
fixed-shape device steps of its paths (a clip scan's step, a chunk, a
batch step, a per-pair flow).

`graphed(fn)` returns a callable that runs `fn` as a replayed
`torch.cuda.CUDAGraph` when its arguments hold a CUDA tensor:

- key: the shape and dtype of every tensor leaf of the arguments (tuples,
  lists, dicts and NamedTuples are walked) and the value of every other
  leaf (params dataclasses, flags; they must be hashable), as jit's
  static arguments, plus the graph's device: that of the first CUDA
  tensor leaf;
- the first call of a key allocates static input buffers on that device
  and copies the arguments in, runs `fn` once on a side stream (which
  builds the kernels and fills the per-device index caches of
  `ops/lk.py`, `ops/patch.py` and `ops/image.py`), then captures `fn` on
  the static buffers into a graph whose memory comes from one pool that
  every graph of the device shares; the graph keeps alive every tensor
  that an op of the capture read and did not make (a cached index
  tensor), since a replay reads the captured addresses;
- every call copies its arguments into the static buffers on the
  current stream (a host tensor, pinned, crosses without blocking the
  host), replays the graph there, and copies the outputs out: an output
  handed to a caller is never overwritten by a later replay.

A call whose tensors all lie on the CPU runs `fn` itself. A call made on
a thread that is warming up or capturing another graphed function runs
`fn` inline, into the outer graph, as a jitted function called inside
another is traced into it. A capture that fails raises; nothing falls
back to the eager form. `__wrapped__` is `fn`, the eager form, for
checks.

`fn` must be a function of its arguments: what it reads that can change
between calls is an argument; it does not modify its arguments; a host
tensor argument means the same to it on the graph's device; it reads no
device value on the host (a capture refuses a sync); a tensor made
before the call reaches a hand-written kernel only through a torch op
or as an argument (the kept-alive tensors are those that torch ops
read). The graphs share one
pool because calls on a device run one after another on its stream: a
graph's intermediates may share memory with another's, but inputs live
outside the pool and outputs are copied out right after each replay.
"""

from __future__ import annotations

import collections
import functools
import threading
import weakref
from typing import Any, Callable

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from .profiling import span

# per thread: how many graphed functions are warming up or capturing
_tracing = threading.local()
# every graphed function, for clear_caches() and launch_stats()
_registry: weakref.WeakSet = weakref.WeakSet()
# one graph memory pool (a torch.cuda.MemPool) per CUDA device index,
# shared by every graph
_pools: dict[int, Any] = {}
# kernel launches recorded by captures and run by replays since reset_stats()
_captured: collections.Counter = collections.Counter()
_replayed: collections.Counter = collections.Counter()

KERNELS = ("lk_level", "warp_bilinear", "patch_bilinear", "gather_rects", "grid_templates")


def _kernel_wrappers() -> tuple:
    """The kernels' wrappers, whose `launches` counters a capture reads."""
    from ..ops.gather_rects import gather_rects
    from ..ops.grid_templates import grid_templates
    from ..ops.lk_level import lk_level
    from ..ops.patch_bilinear import patch_bilinear
    from ..ops.warp_bilinear import warp_bilinear

    return lk_level, warp_bilinear, patch_bilinear, gather_rects, grid_templates


def _pool(device: torch.device):
    """The id of the device's graph pool. A MemPool object holds the pool,
    so that it outlives any one graph: a pool whose last graph is gone is
    not reused by the allocator."""
    if device.index not in _pools:
        _pools[device.index] = torch.cuda.MemPool()
    return _pools[device.index].id


def pool_bytes(device: torch.device | str = "cuda") -> int:
    """Bytes reserved by the shared graph pool of `device` (its segments
    in the caching allocator's snapshot)."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None else device.index
    pool = _pools.get(index)
    if pool is None:
        return 0
    return sum(
        s["total_size"]
        for s in torch.cuda.memory_snapshot()
        if s["device"] == index and tuple(s["segment_pool_id"]) == tuple(pool.id)
    )


class _ReadOutside(TorchDispatchMode):
    """During a capture: every CUDA tensor an op reads that no op of the
    capture made (an index cache's tensor, say). A graph replays the
    addresses it captured, so it keeps these alive: a cache entry evicted
    later must not free memory that a replay reads."""

    def __init__(self):
        super().__init__()
        self.made: set = set()
        self.read: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for x in pytree.tree_leaves((args, kwargs)):
            if isinstance(x, torch.Tensor) and x.is_cuda:
                ptr = x.untyped_storage().data_ptr()
                if ptr not in self.made:
                    self.read.setdefault(ptr, x)
        out = func(*args, **kwargs)
        for x in pytree.tree_leaves(out):
            if isinstance(x, torch.Tensor):
                self.made.add(x.untyped_storage().data_ptr())
        return out


class _Entry:
    """One captured graph: its static inputs and outputs, the tensors it
    reads from outside (kept alive with it) and the kernel launches its
    capture recorded."""

    def __init__(self, graph, static_in, static_out, out_spec, read, nodes):
        self.graph = graph
        self.static_in = static_in  # flat list: a tensor buffer or None per leaf
        self.static_out = static_out  # flat list of output leaves
        self.out_spec = out_spec
        self.read = read  # tensors the capture read and did not make
        self.nodes = nodes  # {kernel name: launches recorded}


class Graphed:
    """`fn` behind captured CUDA graphs, one per key (see the module's
    docstring)."""

    def __init__(self, fn: Callable):
        functools.update_wrapper(self, fn)
        self._fn = fn
        self._entries: dict = {}
        _registry.add(self)

    def clear(self) -> None:
        """Drop every captured graph of this function."""
        self._entries.clear()

    def __call__(self, *args, **kwargs):
        leaves, spec = pytree.tree_flatten((args, kwargs))
        device = next((x.device for x in leaves if isinstance(x, torch.Tensor) and x.is_cuda), None)
        if device is None or getattr(_tracing, "depth", 0):
            return self._fn(*args, **kwargs)
        key = (device, spec, tuple(
            (tuple(x.shape), x.dtype) if isinstance(x, torch.Tensor) else ("static", x) for x in leaves
        ))
        with torch.cuda.device(device):
            entry = self._entries.get(key)
            if entry is None:
                with span("graph.capture", self.__qualname__):
                    entry = self._capture(leaves, spec, device)
                self._entries[key] = entry
            else:
                for buf, x in zip(entry.static_in, leaves):
                    if buf is not None:
                        buf.copy_(x, non_blocking=True)
            entry.graph.replay()
            _replayed.update(entry.nodes)
            out = [x.clone() if isinstance(x, torch.Tensor) else x for x in entry.static_out]
        return pytree.tree_unflatten(out, entry.out_spec)

    def _capture(self, leaves: list, spec, device: torch.device) -> _Entry:
        static_in = [
            torch.empty(x.shape, dtype=x.dtype, device=device) if isinstance(x, torch.Tensor) else None
            for x in leaves
        ]
        for buf, x in zip(static_in, leaves):
            if buf is not None:
                buf.copy_(x, non_blocking=True)
        args, kwargs = pytree.tree_unflatten(
            [x if buf is None else buf for buf, x in zip(static_in, leaves)], spec
        )
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        wrappers = _kernel_wrappers()
        graph = torch.cuda.CUDAGraph()
        _tracing.depth = getattr(_tracing, "depth", 0) + 1
        try:
            with torch.cuda.stream(side):
                self._fn(*args, **kwargs)  # warm-up: kernel builds, index caches
                before = [w.launches for w in wrappers]
                graph.capture_begin(pool=_pool(device), capture_error_mode="thread_local")
                try:
                    with _ReadOutside() as reads:
                        out = self._fn(*args, **kwargs)
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the capture is invalid already; the first error is the one to raise
                    raise
                graph.capture_end()
                nodes = {name: w.launches - b for name, w, b in zip(KERNELS, wrappers, before)}
                _captured.update(nodes)
        finally:
            _tracing.depth -= 1
        current.wait_stream(side)
        static_out, out_spec = pytree.tree_flatten(out)
        return _Entry(graph, static_in, static_out, out_spec, list(reads.read.values()), nodes)


def graphed(fn: Callable) -> Graphed:
    """`fn` run as a captured CUDA graph per key on a CUDA device, and as
    itself on the CPU (see the module's docstring)."""
    return Graphed(fn)


def clear_caches() -> None:
    """Drop every captured graph of every graphed function and their pools
    (as jax.clear_caches): the next call of each key warms up and captures
    again, into a new pool; torch.cuda.empty_cache() then frees the old
    one."""
    for g in list(_registry):
        g.clear()
    _pools.clear()


def reset_stats() -> None:
    """Zero the counts that launch_stats() reads; zero the kernels'
    `launches` counters with them."""
    _captured.clear()
    _replayed.clear()
    for w in _kernel_wrappers():
        w.launches = 0


def launch_stats() -> dict:
    """{"captured": {kernel: launches that captures recorded}, "replayed":
    {kernel: launches that replays ran}} since reset_stats(). A kernel's
    wrapper counts a launch where it is called, eagerly or into a capture;
    the kernel's executions on the device are that count less "captured"
    plus "replayed"."""
    return {"captured": dict(_captured), "replayed": dict(_replayed)}
