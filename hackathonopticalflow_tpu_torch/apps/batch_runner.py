"""Multi-stream batched pipeline runner (port of
hackathonopticalflow_tpu/apps/batch_runner.py; BASELINE.json config 4,
"all repo flight videos processed concurrently").

B videos decode in lockstep (one background prefetcher each, which
converts each frame straight into its stream's row of a pinned (B, H, W)
uint8 batch), and one stream-batched grid-LK step
(`flow/lk_grid.py::lk_grid_flow_prepared`: LK -> radial normalize ->
robust filter, the statistics per stream) runs all streams with one
`lk_level` launch per level, as the JAX package's vmap of its Pallas
kernels adds a batch grid axis. A stream whose decode ends is masked out
while the batch keeps running: its row repeats its last frame and its
results are dropped (SURVEY.md §5.3).

A device runs all of its streams as one batch: the JAX package's
`lax.map` branch for several streams on a device exists for the TPU's
scoped-VMEM limit, which the GPU does not have, so there is one path.
With `n_devices` n > 1 the streams are sharded over the ranks of a
torch.distributed world (started by torchrun or
parallel/mesh.py::run_on_mesh): n shrinks until it divides the stream
count, rank r < n runs the r-th contiguous block of streams on its own
device (as P("stream") splits the batch in the JAX package), the ranks
past n idle, and every rank returns the same dict, the per-stream counts
gathered in stream order: equal to the one-device run's.

Frames come from `open_reader(video)`: cv2's `VideoReader` by default, or
any reader with height, width, seek(i) and read() (io/prefetch.py).

A step packs the B streams' results into one tensor, which crosses to
the host with one copy a step; the danger counts are read from it, and
`on_result` is handed every live pair's whole result.

Each step leaves spans (utils/profiling.py::span, recorded only under a
torch.profiler), keyed by its step index: `batch.step.fill` (the
prefetchers' frames taken, ended streams' rows copied from the batch
before; the last one finds every stream ended and dispatches nothing),
`batch.step.dispatch` (the graph, the result's copy, the event),
`batch.step.wait` (the wait on that event, on the GPU only) and
`batch.step.unpack` (the unpacked results, the counts and the hook's
calls), the last two one step late.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..core import FilterParams, LKParams, NormalizeParams, measurement_grid
from ..flow.device import resolve_device
from ..flow.lk_grid import (
    GridFlowResult,
    lk_grid_flow_prepared,
    lk_grid_flow_video,
    pack_grid_result,
    search_frame,
    unpack_grid_result,
)
from ..io.prefetch import FramePrefetcher
from ..io.video import VideoReader
from ..ops.lk import prepare_frame
from ..parallel.mesh import init_multihost, rank_device
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.graphs import graphed
from ..utils.logging import get_logger
from ..utils.profiling import span

log = get_logger("apps.batch_runner")

STAGED_CHUNK = 24  # frame pairs per chunk of run_batch_staged
#: run_batch's pinned (B, H, W) frame batches: one the device reads, one
#: waiting for dispatch, one the prefetchers fill
BATCH_SLOTS = 3
#: the reference clips, which the command line runs with --corpus or
#: without videos (the JAX package's runner globs the same)
CORPUS_GLOB = "/root/reference/videos/*.mp4"


@dataclasses.dataclass
class BatchRunnerConfig:
    videos: list[str]
    step: int = 30
    max_frames: int | None = None
    #: None or 1: every stream on one device; n > 1: streams sharded over
    #: the first n ranks of the running world (each rank calls run_batch)
    n_devices: int | None = None
    lk: LKParams = LKParams()
    norm: NormalizeParams = NormalizeParams()
    filt: FilterParams = FilterParams()
    #: checkpoint/resume for the streaming path: saves (step index,
    #: previous frame batch, alive mask) atomically every
    #: checkpoint_every steps; resumes from the file if present. The
    #: resumed per-stream output sequence equals an uninterrupted run's.
    #: With n_devices > 1 each rank keeps its own block's file
    #: (<root>.rank<r>of<n><ext>), all of them at the one-device run's
    #: step when a run ends; a resume needs the same n.
    checkpoint_path: str | None = None
    checkpoint_every: int = 24
    #: where the flow runs: the GPU unless "cpu" is asked for
    device: str = "cuda"
    #: opens a video: VideoReader (cv2) or any reader with its interface
    open_reader: Callable = VideoReader
    #: called as on_result(stream, pair, result) for every pair of every
    #: live stream, in step order and, within a step, in stream order:
    #: `stream` indexes `videos`, `pair` is the pair's index in its
    #: stream, counted from 1 (pair k joins frames k - 1 and k; a resumed
    #: run goes on from the checkpoint's pair: result `pair` is
    #: danger_counts[stream][pair - 1] of the uninterrupted run), `result`
    #: is a GridFlowResult of host numpy arrays, (N, ...) each, some of
    #: them views of a buffer that a later step overwrites: valid only
    #: during the call, so copy what is kept. An ended stream gets no more
    #: calls. With n_devices > 1 the rank that runs a stream calls it.
    on_result: Callable[[int, int, GridFlowResult], None] | None = None


def _device(cfg: BatchRunnerConfig) -> torch.device:
    if cfg.n_devices not in (None, 1):
        raise ValueError(f"n_devices={cfg.n_devices}: run_batch_staged runs every stream on one device")
    return resolve_device(cfg.device)


def _shards(cfg: BatchRunnerConfig) -> int:
    """The number of ranks the streams are sharded over: cfg.n_devices,
    at most the world's size, shrunk until it divides the stream count."""
    if not dist.is_initialized():
        raise ValueError(
            f"n_devices={cfg.n_devices} shards the streams over the ranks of a torch.distributed world: "
            "start them with torchrun (python -m hackathonopticalflow_tpu_torch.apps.batch_runner "
            "--n-devices N) or parallel.mesh.run_on_mesh; n_devices None or 1 runs every stream on one device"
        )
    world = dist.get_world_size()
    if cfg.n_devices > world:
        raise ValueError(f"n_devices={cfg.n_devices} but the world has {world} ranks")
    n = cfg.n_devices
    while len(cfg.videos) % n:
        n -= 1
    return n


def _checkpoint_step(path: str | None) -> int | None:
    """The step a checkpoint file records, None without one."""
    if not path or not os.path.exists(path):
        return None
    return int(load_checkpoint(path, {"n_steps": np.int64(0)})["n_steps"])


def run_batch(cfg: BatchRunnerConfig) -> dict:
    """Streams every video in lockstep through one stream-batched step per
    frame index; returns run metrics and each stream's per-pair danger
    counts (its `good` sums), and hands each pair's whole result to
    `cfg.on_result` where it is set.

    Frames cross through BATCH_SLOTS pinned (B, H, W) batches, which the
    prefetchers fill (stream i's frame into row i) and get back once the
    step that read the batch is consumed; the previous step's prepared
    pyramid stays on the device. A step (`_batch_step`: the frames'
    pyramid, the batched flow, the results packed) runs as one captured
    graph on the GPU, at the fixed B: ended streams stay in the batch,
    masked on the host. Each
    step's results, packed by `pack_grid_result` into one (B, 10 N)
    float32 tensor, come back with one non-blocking copy behind an event
    into one of two pinned slots, and are unpacked one step late, while
    the next step runs: the counts are their `good` sums, and each live
    pair goes to `cfg.on_result`. The first step is run once before the
    clock starts (kernel build, index caches, capture).

    With n_devices > 1 every rank of the world calls it: rank r < n runs
    its block of streams this way on its own device
    (rank_device(cfg.device)), and the blocks' results are gathered to
    every rank. The steps and the first step are the whole run's, the
    wall time the slowest block's. Each block's checkpoint file ends each
    run at the step where the one-device run's checkpoint would be, so a
    resume under the same n continues as the one-device run's does."""
    if cfg.n_devices in (None, 1):
        n = 1
        blocks = [_run_block(cfg, cfg.videos, resolve_device(cfg.device), cfg.checkpoint_path, 0)]
    else:
        n = _shards(cfg)
        rank = dist.get_rank()
        per = len(cfg.videos) // n
        ck = None
        if cfg.checkpoint_path and rank < n:
            root, ext = os.path.splitext(cfg.checkpoint_path)
            ck = f"{root}.rank{rank}of{n}{ext}"
        saved = [None] * dist.get_world_size()
        dist.all_gather_object(saved, _checkpoint_step(ck))
        if len(set(saved[:n])) > 1:
            raise ValueError(
                f"the blocks' checkpoints of {cfg.checkpoint_path} record different steps {saved[:n]} "
                "(a run was killed midway or a file is missing): they cannot resume one run"
            )
        block = last_prev = None
        if rank < n:
            block = _run_block(cfg, cfg.videos[rank * per : (rank + 1) * per], rank_device(cfg.device), ck,
                               rank * per)
            last_prev = block.pop("last_prev")
        blocks = [None] * dist.get_world_size()
        dist.all_gather_object(blocks, block)
        blocks = blocks[:n]
        if ck:
            # the one-device run's last checkpoint is at the run's last
            # periodic step S; a block that ended before S records there,
            # its streams all dead, so every block's file is that one
            done = max(blk["n_steps"] for blk in blocks) - block["n_steps0"]
            last = block["n_steps0"] + done // cfg.checkpoint_every * cfg.checkpoint_every
            if block["n_steps"] < last:
                save_checkpoint(ck, n_steps=np.int64(last), prev=last_prev, alive=np.zeros(per, bool))
    # the blocks share the step they started at and their first frame
    danger_counts = [c for blk in blocks for c in blk["danger_counts"]]
    wall = max(blk["wall_s"] for blk in blocks)
    total_frames = sum(len(d) for d in danger_counts)
    return {
        "streams": len(cfg.videos),
        "devices": n,
        "steps": max(blk["n_steps"] for blk in blocks) - blocks[0]["n_steps0"],
        "first_step": blocks[0]["start"],
        "total_frames": total_frames,
        "wall_s": wall,
        "aggregate_fps": total_frames / max(wall, 1e-9),
        "mean_danger_per_stream": [float(np.mean(d)) if d else 0.0 for d in danger_counts],
        "danger_counts": danger_counts,
    }


def _run_block(cfg: BatchRunnerConfig, videos: list, dev: torch.device, checkpoint_path: str | None,
               stream0: int) -> dict:
    """run_batch's loop over one device's block of streams, the first of
    them stream `stream0` of the run: their danger counts, the step
    counter at the start and at the end, the first frame decoded, the wall
    time and the last frame batch."""
    cuda = dev.type == "cuda"
    b = len(videos)
    hook = cfg.on_result

    # resume: restore (step index, previous frame batch, alive mask) and
    # pick each stream's decode up where the checkpoint left it
    # every stream's frame size, which the batch buffers take
    sizes = set()
    for v in videos:
        probe = cfg.open_reader(v)
        sizes.add((probe.height, probe.width))
        probe.release()
    if len(sizes) > 1:
        raise ValueError(f"streams must share resolution for batching, not {sorted(sizes)}")
    h, w = sizes.pop()
    resume = None
    if checkpoint_path and os.path.exists(checkpoint_path):
        resume = load_checkpoint(
            checkpoint_path,
            {
                "n_steps": np.int64(0),
                "prev": np.zeros((b, h, w), np.uint8),
                "alive": np.zeros((b,), bool),
            },
        )
        log.info("resuming at step %d", int(resume["n_steps"]))
    # Invariant (kept across any number of resumes): after each step,
    # `prev` holds frame index n_steps, and a checkpoint records exactly
    # that pair. A resume restarts the counter at the saved n_steps and
    # decodes from frame n_steps + 1.
    n_steps0 = 0 if resume is None else int(resume["n_steps"])
    start = 0 if resume is None else n_steps0 + 1  # first frame to decode
    remaining = None if cfg.max_frames is None else cfg.max_frames - start
    # Stream i's prefetcher converts each frame straight into row i of a
    # free batch; every prefetcher is handed the batches back in the same
    # order, so they fill the same batch for a step.
    frames_buf = [torch.empty((b, h, w), dtype=torch.uint8, pin_memory=cuda) for _ in range(BATCH_SLOTS)]
    prefetchers = [
        FramePrefetcher(v, start_frame=start, max_frames=remaining, open_reader=cfg.open_reader,
                        slots=[buf.numpy()[i : i + 1] for buf in frames_buf])
        for i, v in enumerate(videos)
    ]
    try:
        iters = [iter(p) for p in prefetchers]
        # (step index, batch) of the batches the device may still read,
        # handed back to the prefetchers once that step is consumed
        held = collections.deque()
        if resume is None:
            items = [next(it, None) for it in iters]
            if any(c is None for c in items):
                raise IOError("a stream has no first frame")
            slot = _shared_slot(items)
            held.append((n_steps0, slot))
            prev, first = frames_buf[slot].numpy(), frames_buf[slot]
            alive = np.ones(b, bool)
        else:
            prev = np.asarray(resume["prev"], np.uint8)
            first = torch.from_numpy(prev)
            if cuda:
                first = first.pin_memory()
            alive = np.array(resume["alive"], bool)
        grid = measurement_grid(h, w, cfg.step)
        pts = torch.from_numpy(grid).to(dev)
        pts_i = np.trunc(grid + 0.5).astype(np.int32)

        out_buf = [torch.empty((b, 10 * grid.shape[0]), dtype=torch.float32, pin_memory=cuda) for _ in range(2)]
        prev_planes = prepare_frame(first.to(dev, non_blocking=True), cfg.lk).img_p

        def step(prev_planes, frames):
            return _batch_step(prev_planes, frames, pts, cfg.lk, cfg.norm, cfg.filt)

        if cuda:  # build, cache and capture outside the clock
            step(prev_planes, first)
            torch.cuda.synchronize(dev)

        danger_counts: list[list[int]] = [[] for _ in range(b)]
        n_steps = n_steps0
        since_save = 0

        def consume(p):
            nonlocal since_save
            oslot, fslot, ready, alive_at, n_steps_at = p
            if ready is not None:
                with span("batch.step.wait", n_steps_at):
                    ready.synchronize()  # this step's output is in out_buf[oslot]
            with span("batch.step.unpack", n_steps_at):
                host = unpack_grid_result(out_buf[oslot].numpy(), pts_i)
                counts = host.good.sum(-1)
                for i in range(b):
                    if alive_at[i]:
                        danger_counts[i].append(int(counts[i]))
                        if hook is not None:
                            # a live stream's pair k is step k's
                            hook(stream0 + i, n_steps_at, GridFlowResult(*[a[i] for a in host]))
            since_save += 1
            if checkpoint_path and since_save >= cfg.checkpoint_every:
                save_checkpoint(
                    checkpoint_path,
                    n_steps=np.int64(n_steps_at),
                    prev=frames_buf[fslot].numpy().copy(),
                    alive=alive_at.copy(),
                )
                since_save = 0
            # the device has read every batch up to this step's; an ended
            # stream's row keeps its last frame, which no prefetcher
            # writes again
            while held and held[0][0] <= n_steps_at:
                _, done = held.popleft()
                for pre in prefetchers:
                    pre.release(done)

        # (result buffer, frame batch, ready event, alive mask, step
        # index) of the step whose output is still to be read
        pending = None
        t0 = time.time()
        while alive.any():
            key = n_steps + 1  # the step's index, its spans' key
            with span("batch.step.fill", key):
                items = [next(it, None) if alive[i] else None for i, it in enumerate(iters)]
                for i, c in enumerate(items):
                    if c is None and alive[i]:
                        alive[i] = False  # stream ended; keep the batch shape, mask its results
                        log.info("stream %d ended at step %d", i, n_steps)
                if alive.any():
                    slot = _shared_slot(items)
                    cur = frames_buf[slot].numpy()
                    for i in np.flatnonzero(~alive):
                        cur[i] = prev[i]
            if not alive.any():
                break
            with span("batch.step.dispatch", key):
                oslot = key % 2
                out, cur_planes = step(prev_planes, frames_buf[slot])
                out_buf[oslot].copy_(out, non_blocking=True)
                ready = None
                if cuda:
                    ready = torch.cuda.Event()
                    ready.record(torch.cuda.current_stream(dev))
            n_steps += 1
            held.append((n_steps, slot))
            last, pending = pending, (oslot, slot, ready, alive.copy(), n_steps)
            if last is not None:
                consume(last)
            prev_planes, prev = cur_planes, cur
        if pending is not None:
            consume(pending)
        wall = time.time() - t0
        last_prev = prev.copy()
    finally:
        for p in prefetchers:
            p.close()
    return {"danger_counts": danger_counts, "n_steps0": n_steps0, "n_steps": n_steps, "start": start,
            "wall_s": wall, "last_prev": last_prev}


def _shared_slot(items: list) -> int:
    """The frame batch the live streams' prefetchers filled for a step
    (`Chunk`s, None for an ended stream): the same for all of them."""
    slots = {c.slot for c in items if c is not None}
    if len(slots) != 1:
        raise RuntimeError(f"the streams' prefetchers filled different frame batches {sorted(slots)}")
    return slots.pop()


@graphed
def _batch_step(prev_planes: tuple, frames: torch.Tensor, pts: torch.Tensor, lk: LKParams, norm: NormalizeParams,
                filt: FilterParams):
    """One step of run_batch for its B streams: (their results packed by
    pack_grid_result, (B, 10 N) float32; the frames' padded image levels
    for the next step, all that the step reads of the previous frames:
    flow/lk_grid.py::search_frame). frames (B, H, W) uint8 cross from
    their pinned buffer straight into the captured graph's input on the
    GPU."""
    cur_prep = prepare_frame(frames.to(pts.device), lk)
    res = lk_grid_flow_prepared(search_frame(prev_planes), cur_prep, pts, lk, norm, filt)
    return pack_grid_result(res), cur_prep.img_p


def run_batch_staged(cfg: BatchRunnerConfig, reps: int = 3) -> dict:
    """The compute path without decode or per-step uploads: every stream's
    frames staged on the device once (uint8), then each stream scanned in
    chunks of STAGED_CHUNK pairs overlapping by one frame through
    `lk_grid_flow_video`, the tail chunk padded with its last frame and its
    padded pairs dropped. Streams run one after another, as in the JAX
    package. The per-stream counts equal run_batch's; they come back with
    one copy per pass. Steady-state time: best of `reps` passes after a
    first one (kernel build, index caches)."""
    dev = _device(cfg)
    frames = []
    for v in cfg.videos:
        pre = FramePrefetcher(v, max_frames=cfg.max_frames, open_reader=cfg.open_reader)
        try:
            frames.append(np.stack(list(pre)))
        finally:
            pre.close()
    h, w = frames[0].shape[1:]
    pts = torch.from_numpy(measurement_grid(h, w, cfg.step)).to(dev)
    dev_streams = [torch.from_numpy(f).to(dev) for f in frames]
    lengths = [max(f.shape[0] - 1, 0) for f in frames]

    def run_once() -> list[list[int]]:
        counts = []
        for f in dev_streams:
            t = f.shape[0]
            start = 0
            while start + 1 < t:
                stop = min(start + STAGED_CHUNK + 1, t)
                piece = f[start:stop]
                valid = piece.shape[0] - 1
                if valid < STAGED_CHUNK:
                    piece = torch.cat([piece, piece[-1:].expand(STAGED_CHUNK - valid, h, w)])
                res = lk_grid_flow_video(piece, pts, cfg.lk, cfg.norm, cfg.filt, device=dev)
                counts.append(res.good.sum(1)[:valid])
                start = stop - 1
        # one copy for the pass; a <2-frame stream has an empty sequence
        flat = torch.cat(counts).tolist() if counts else []
        offs = np.cumsum([0] + lengths)
        return [flat[offs[i] : offs[i + 1]] for i in range(len(lengths))]

    def timed() -> tuple[list[list[int]], float]:
        t0 = time.time()
        out = run_once()  # ends in a copy to the host
        return out, time.time() - t0

    counts, compile_s = timed()
    best = float("inf")
    for _ in range(reps):
        counts, secs = timed()
        best = min(best, secs)
    total_frames = sum(len(c) for c in counts)
    return {
        "streams": len(frames),
        "total_frames": total_frames,
        "wall_s": best,
        "compile_s": compile_s,
        "aggregate_fps": total_frames / max(best, 1e-9),
        "mean_danger_per_stream": [float(np.mean(c)) if c else 0.0 for c in counts],
        "danger_counts": counts,
    }


def main(argv: list[str] | None = None) -> None:
    import argparse
    import glob

    p = argparse.ArgumentParser(description="multi-stream batched pathfinder on PyTorch (GPU unless --device cpu)")
    p.add_argument("videos", nargs="*", help=f"clips to run; none: the reference clips ({CORPUS_GLOB})")
    p.add_argument("--corpus", action="store_true", help=f"run the reference clips ({CORPUS_GLOB})")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument(
        "--staged",
        action="store_true",
        help="compute-path mode: stage all frames on the device once and scan there (no per-step upload)",
    )
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--device", default="cuda")
    p.add_argument(
        "--n-devices",
        type=int,
        default=None,
        help="shard the streams over N ranks, each launched by torchrun --nproc-per-node N",
    )
    p.add_argument(
        "--backend",
        choices=("nccl", "gloo"),
        default=None,
        help="with --n-devices: nccl (a GPU per rank; the default on CUDA) or gloo (ranks sharing one GPU, or the CPU)",
    )
    args = p.parse_args(argv)
    videos = args.videos
    if args.corpus or not videos:
        videos = sorted(glob.glob(CORPUS_GLOB))
    if not videos:
        p.error(f"no videos given and none match {CORPUS_GLOB}")
    cfg = BatchRunnerConfig(
        videos=videos,
        max_frames=args.max_frames,
        n_devices=args.n_devices,
        checkpoint_path=args.checkpoint,
        # production path: the static-grid lanes kernels, all streams per launch
        lk=LKParams(grid_step=30, compute_err=False),
        device=args.device,
    )
    world = False
    if (args.n_devices or 1) > 1:  # the ranks torchrun started
        backend = args.backend or ("nccl" if torch.device(args.device).type == "cuda" else "gloo")
        world = init_multihost(backend=backend)
    rank = dist.get_rank() if dist.is_initialized() else 0
    try:
        stats = run_batch_staged(cfg) if args.staged else run_batch(cfg)
    finally:
        if world:
            dist.destroy_process_group()
    stats.pop("danger_counts", None)
    if rank == 0:
        print(stats)


if __name__ == "__main__":
    main()
