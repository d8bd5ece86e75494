"""Entry: the dense scan, `flow/dense.py::farneback_flow_video`, on
consecutive chunks of the traffic's `chunk` pairs (chunk + 1 frames,
overlapping by one), one stream as fast as it goes (a closed loop).

Each chunk's frames are handed over as a host (chunk + 1, H, W) u8 array
(the loop repeats its chunks, so set-up lays each distinct one out once,
as a decoder would have filled its buffer) and its flows are left on the
device, as a caller that keeps working on
them would. The window ends when the device has finished the last chunk.
A sample of `keep_chunks` chunks, drawn from the seed uniformly over the
window (a reservoir, so at most that many chunks' flows are held at
once), keeps its flows for the check, which compares them with the
reference's, pair by pair. With `control`, the port's own lower-precision
path stands in: warp_mode "packed", the coefficient planes 0-3 rounded to
bf16 before the warp.
"""

from __future__ import annotations

import numpy as np

from portbench.harness.cell import Window
from portbench.harness.clip import loop_index
from portbench.harness.port import farneback_params


def _chunk(gray: np.ndarray, pos: int, chunk: int) -> np.ndarray:
    return gray[[loop_index(pos + j, gray.shape[0]) for j in range(chunk + 1)]]


def setup(ctx) -> None:
    import torch
    from hackathonopticalflow_tpu_torch.flow.dense import farneback_flow_video

    params = farneback_params(ctx.cfg, **({"warp_mode": "packed"} if ctx.control else {}))
    chunk = int(ctx.traffic["chunk"])
    gray = ctx.streams[0].gray
    period = 2 * (gray.shape[0] - 1)
    chunks = {(c * chunk) % period: torch.from_numpy(_chunk(gray, c * chunk, chunk)) for c in range(period)}
    farneback_flow_video(chunks[0], params, device=ctx.device)
    ctx.state.update(params=params, chunks=chunks, period=period)


def window(ctx, t0: float, deadline: float) -> Window:
    from hackathonopticalflow_tpu_torch.flow.dense import farneback_flow_video

    s = ctx.streams[0]
    chunk = int(ctx.traffic["chunk"])
    keep = int(ctx.traffic["keep_chunks"])
    rng = np.random.default_rng([ctx.seed, 0x5CA7])
    params, chunks, period = ctx.state["params"], ctx.state["chunks"], ctx.state["period"]
    kept, pos, n_chunks = [], 0, 0
    while ctx.clock() < deadline:
        flows = farneback_flow_video(chunks[pos % period], params, device=ctx.device)
        if n_chunks < keep:
            kept.append((pos, flows))
        else:
            j = int(rng.integers(0, n_chunks + 1))
            if j < keep:
                kept[j] = (pos, flows)
        pos += chunk
        n_chunks += 1
    ctx.sync()
    t1 = ctx.clock()
    steps = [[(0, loop_index(k - 1, s.n), loop_index(k, s.n))] for k in range(1, pos + 1)]
    return Window(t0, t1, answers=pos, attempted=pos, steps=steps, data={"kept": kept})


def release(ctx) -> None:
    ctx.state.clear()


def check(ctx, win: Window) -> tuple[dict, int]:
    """flow_max_px: the largest gap between a kept flow and the
    reference's, over every pixel of every kept pair; failed: the kept
    pairs whose gap passes the limit."""
    import torch

    s = ctx.streams[0]
    chunk = int(ctx.traffic["chunk"])
    ref = ctx.fb_pairs(0)
    limit = float(ctx.cell.limits["flow_max_px"]["limit"])
    worst, failed = 0.0, 0
    for pos, flows in win.data["kept"]:
        for j in range(chunk):
            want = ref.flow(loop_index(pos + j, s.n), loop_index(pos + j + 1, s.n))
            if j >= flows.shape[0] or flows[j].shape != want.shape:
                gap = float("inf")
            else:
                gap = float(torch.nan_to_num((flows[j] - want).abs(), nan=float("inf")).max())
            worst = max(worst, gap)
            failed += gap > limit
    return {"flow_max_px": worst}, failed
