"""Entry: the trajectory tracker, `flow/tracker.py::track_video` at the
configuration's TrackerParams, on consecutive chunks of the traffic's
`chunk` pairs (chunk + 1 frames, overlapping by one), one stream as fast
as it goes (a closed loop), the tracker state carried from chunk to chunk
through `state=`.

Set-up lays out each distinct chunk's frames once as a host (chunk + 1,
H, W) u8 tensor in pinned memory (the loop repeats its chunks, as a
decoder would have filled its buffer; the pathfinder app's `run_batched`
fills pinned chunks too: from pageable memory the upload's copy through
CUDA's pageable staging buffer swung the rate from run to run, 545-596
pairs/s on one seed against 652-709 pinned, on an H100 80GB HBM3;
PERF.md §6). It seeds the table with one step of the first frame against
itself, as the JAX package's callers do, and runs the first chunk, which
captures both of the step's graphs (with detection and without). On the
card it then runs the same loop as the window for the traffic's
`warm_seconds`: after the graphs are captured, an H100 80GB HBM3 ran
every step of the same graph 12% slower (1.09-1.10 ms a tracking step
against 0.96-0.98) for the first 2-25 s of sustained load, with its SM
clock read at 1980 MHz throughout, and a 30-s window that caught a
varying part of that spread its rate over 640-720 pairs/s (PERF.md §6).
The window goes on from where the warm-up ended. Each chunk's history
(heads, alive, length) is copied to the host; a pair counts once its
history is there, and the window ends when the last chunk's is.

A reservoir drawn from the seed keeps `keep_chunks` chunks for the check.
Whether a chunk is kept is drawn before it runs, so that only kept chunks
pay for a clone of the state they start from; the check replays each from
that state through the reference and compares every step
(harness/tracker_check.py). With `control`, the reference with its LK
image data in bf16 stands in for the port's answers.
"""

from __future__ import annotations

import numpy as np

from portbench.harness import tracker_check
from portbench.harness.cell import Window
from portbench.harness.clip import loop_index


def setup(ctx) -> None:
    import torch
    from hackathonopticalflow_tpu_torch.flow.tracker import init_tracker, track_step, track_video
    from portbench.harness.correlation import install

    install()
    params = tracker_check.tracker_params(ctx.cfg)
    chunk = int(ctx.traffic["chunk"])
    gray = ctx.streams[0].gray
    period = 2 * (gray.shape[0] - 1)
    starts = {(c * chunk) % period for c in range(period)}
    chunks = {p: torch.from_numpy(tracker_check.chunk_frames(gray, p, chunk)) for p in starts}
    if ctx.device.type == "cuda":
        chunks = {p: c.pin_memory() for p, c in chunks.items()}
    f0 = torch.from_numpy(gray[0])
    state = track_step(init_tracker(params, ctx.device), f0, f0, params, device=ctx.device)
    state, _ = track_video(chunks[0], params, state, device=ctx.device)
    pos, warm_until = chunk, ctx.clock()
    if ctx.device.type == "cuda":
        warm_until += float(ctx.traffic["warm_seconds"])
    while ctx.clock() < warm_until:
        state, history = track_video(chunks[pos % period], params, state, device=ctx.device)
        for x in history:
            x.cpu()
        pos += chunk
    ctx.state.update(params=params, chunks=chunks, period=period, state=state, pos=pos,
                     start_alive=state.alive.cpu().numpy(), warm_chunks=(pos - chunk) // chunk)


def window(ctx, t0: float, deadline: float) -> Window:
    from hackathonopticalflow_tpu_torch.flow.tracker import track_video

    s = ctx.streams[0]
    st = ctx.state
    chunk = int(ctx.traffic["chunk"])
    keep = int(ctx.traffic["keep_chunks"])
    rng = np.random.default_rng([ctx.seed, 0x7AC5])
    params, chunks, period = st["params"], st["chunks"], st["period"]
    state, pos = st["state"], st["pos"]
    fetched, kept, slots, arrivals = [], {}, [], []
    while ctx.clock() < deadline:
        i = len(fetched)
        j = i if i < keep else int(rng.integers(0, i + 1))
        snap = tracker_check.snapshot(state) if j < keep else None
        state, (heads, alive, length) = track_video(chunks[pos % period], params, state, device=ctx.device)
        heads, alive, length = heads.cpu().numpy(), alive.cpu().numpy(), length.cpu().numpy()
        arrivals.append(ctx.clock())
        fetched.append(tracker_check.Chunk(pos, alive, length))
        if snap is not None:
            if j < len(slots):
                del kept[slots[j]]
                slots[j] = i
            else:
                slots.append(i)
            kept[i] = (snap, heads)
        pos += chunk
    t1 = ctx.clock()
    pairs = len(fetched) * chunk
    first = st["pos"]
    steps = [[(0, loop_index(k - 1, s.n), loop_index(k, s.n))] for k in range(first + 1, first + pairs + 1)]
    win = Window(t0, t1, answers=pairs, attempted=pairs, steps=steps,
                 data={"chunks": fetched, "kept": kept, "start_alive": st["start_alive"]})
    win.notes = tracker_check.counters(win)
    win.notes["warm_chunks"] = st["warm_chunks"]
    gaps = np.diff([t0, *arrivals])
    if len(gaps):
        win.notes.update(chunk_ms_median=1e3 * float(np.median(gaps)), chunk_ms_max=1e3 * float(gaps.max()))
    return win


def release(ctx) -> None:
    ctx.state.clear()


def check(ctx, win: Window) -> tuple[dict, int]:
    return tracker_check.compare(ctx, win)
