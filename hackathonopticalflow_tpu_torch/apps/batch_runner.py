"""Multi-stream batched pipeline runner (port of
hackathonopticalflow_tpu/apps/batch_runner.py; BASELINE.json config 4,
"all repo flight videos processed concurrently").

B videos decode in lockstep (one background prefetcher each), their frames
stack into one (B, H, W) uint8 batch, and one stream-batched grid-LK step
(`flow/lk_grid.py::lk_grid_flow_prepared`: LK -> radial normalize ->
robust filter, the statistics per stream) runs all streams with one
`lk_level` launch per level, as the JAX package's vmap of its Pallas
kernels adds a batch grid axis. A stream whose decode ends is masked out
while the batch keeps running: its slot repeats its last frame and its
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
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..core import FilterParams, LKParams, NormalizeParams, measurement_grid
from ..flow.device import resolve_device
from ..flow.lk_grid import lk_grid_flow_prepared, lk_grid_flow_video, search_frame
from ..io.prefetch import FramePrefetcher
from ..io.video import VideoReader
from ..ops.lk import prepare_frame
from ..parallel.mesh import init_multihost, rank_device
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from ..utils.graphs import graphed
from ..utils.logging import get_logger

log = get_logger("apps.batch_runner")

STAGED_CHUNK = 24  # frame pairs per chunk of run_batch_staged
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
    counts (its `good` sums).

    Frames cross through two pinned (B, H, W) buffers that alternate
    between steps; the previous step's prepared pyramid stays on the
    device. A step (`_batch_step`: the frames' pyramid, the batched flow,
    the counts) runs as one captured graph on the GPU, at the fixed B:
    ended streams stay in the batch, masked on the host. Each step's
    counts come back with one non-blocking copy behind an event and are
    read one step late, while the next step runs. The first step is run
    once before the clock starts (kernel build, index caches, capture).

    With n_devices > 1 every rank of the world calls it: rank r < n runs
    its block of streams this way on its own device
    (rank_device(cfg.device)), and the blocks' results are gathered to
    every rank. The steps and the first step are the whole run's, the
    wall time the slowest block's. Each block's checkpoint file ends each
    run at the step where the one-device run's checkpoint would be, so a
    resume under the same n continues as the one-device run's does."""
    if cfg.n_devices in (None, 1):
        n = 1
        blocks = [_run_block(cfg, cfg.videos, resolve_device(cfg.device), cfg.checkpoint_path)]
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
            block = _run_block(cfg, cfg.videos[rank * per : (rank + 1) * per], rank_device(cfg.device), ck)
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


def _run_block(cfg: BatchRunnerConfig, videos: list, dev: torch.device, checkpoint_path: str | None) -> dict:
    """run_batch's loop over one device's block of streams: their danger
    counts, the step counter at the start and at the end, the first frame
    decoded, the wall time and the last frame batch."""
    cuda = dev.type == "cuda"
    b = len(videos)

    # resume: restore (step index, previous frame batch, alive mask) and
    # pick each stream's decode up where the checkpoint left it
    resume = None
    if checkpoint_path and os.path.exists(checkpoint_path):
        probe = cfg.open_reader(videos[0])
        h0, w0 = probe.height, probe.width
        probe.release()
        resume = load_checkpoint(
            checkpoint_path,
            {
                "n_steps": np.int64(0),
                "prev": np.zeros((b, h0, w0), np.uint8),
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
    prefetchers = [
        FramePrefetcher(v, start_frame=start, max_frames=remaining, open_reader=cfg.open_reader)
        for v in videos
    ]
    try:
        iters = [iter(p) for p in prefetchers]
        if resume is None:
            first = [next(it, None) for it in iters]
            if any(f is None for f in first):
                raise IOError("a stream has no first frame")
            if any(f.shape != first[0].shape for f in first):
                raise ValueError("streams must share resolution for batching")
            first = np.stack(first)
            alive = np.ones(b, bool)
        else:
            first = np.asarray(resume["prev"], np.uint8)
            alive = np.array(resume["alive"], bool)
        h, w = first.shape[1:]
        pts = torch.from_numpy(measurement_grid(h, w, cfg.step)).to(dev)

        frames_buf = [torch.empty((b, h, w), dtype=torch.uint8, pin_memory=cuda) for _ in range(2)]
        counts_buf = [torch.empty((b,), dtype=torch.int32, pin_memory=cuda) for _ in range(2)]
        frames_buf[0].numpy()[:] = first
        prev_planes = prepare_frame(frames_buf[0].to(dev, non_blocking=True), cfg.lk).img_p

        def step(prev_planes, frames):
            return _batch_step(prev_planes, frames, pts, cfg.lk, cfg.norm, cfg.filt)

        if cuda:  # build, cache and capture outside the clock
            step(prev_planes, frames_buf[0])
            torch.cuda.synchronize(dev)

        danger_counts: list[list[int]] = [[] for _ in range(b)]
        n_steps = n_steps0
        since_save = 0

        def consume(p):
            nonlocal since_save
            slot, ready, alive_at, n_steps_at = p
            if ready is not None:
                ready.synchronize()  # this step's counts are in counts_buf[slot]
            counts = counts_buf[slot].numpy()
            for i in range(b):
                if alive_at[i]:
                    danger_counts[i].append(int(counts[i]))
            since_save += 1
            if checkpoint_path and since_save >= cfg.checkpoint_every:
                save_checkpoint(
                    checkpoint_path,
                    n_steps=np.int64(n_steps_at),
                    prev=frames_buf[slot].numpy().copy(),
                    alive=alive_at.copy(),
                )
                since_save = 0

        # (buffer slot, ready event, alive mask, step index) of the step
        # whose counts are still to be read
        pending = None
        slot = 0  # the buffer that holds the previous frame batch
        t0 = time.time()
        while alive.any():
            # this buffer's last copies (two steps back) were waited for
            # when that step was consumed
            nslot = 1 - slot
            cur, prev = frames_buf[nslot].numpy(), frames_buf[slot].numpy()
            for i, it in enumerate(iters):
                nxt = next(it, None) if alive[i] else None
                if nxt is None:
                    if alive[i]:
                        alive[i] = False  # stream ended; keep the batch shape, mask its results
                        log.info("stream %d ended at step %d", i, n_steps)
                    cur[i] = prev[i]
                else:
                    cur[i] = nxt
            if not alive.any():
                break
            counts, cur_planes = step(prev_planes, frames_buf[nslot])
            counts_buf[nslot].copy_(counts, non_blocking=True)
            ready = None
            if cuda:
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(dev))
            n_steps += 1
            last, pending = pending, (nslot, ready, alive.copy(), n_steps)
            if last is not None:
                consume(last)
            prev_planes, slot = cur_planes, nslot
        if pending is not None:
            consume(pending)
        wall = time.time() - t0
        last_prev = frames_buf[slot].numpy().copy()
    finally:
        for p in prefetchers:
            p.close()
    return {"danger_counts": danger_counts, "n_steps0": n_steps0, "n_steps": n_steps, "start": start,
            "wall_s": wall, "last_prev": last_prev}


@graphed
def _batch_step(prev_planes: tuple, frames: torch.Tensor, pts: torch.Tensor, lk: LKParams, norm: NormalizeParams,
                filt: FilterParams):
    """One step of run_batch for its B streams: (each stream's danger
    count (B,) int32, the frames' padded image levels for the next step,
    all that the step reads of the previous frames: flow/lk_grid.py::
    search_frame). frames (B, H, W) uint8 cross from their pinned buffer
    straight into the captured graph's input on the GPU."""
    cur_prep = prepare_frame(frames.to(pts.device), lk)
    res = lk_grid_flow_prepared(search_frame(prev_planes), cur_prep, pts, lk, norm, filt)
    return res.good.sum(-1, dtype=torch.int32), cur_prep.img_p


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
