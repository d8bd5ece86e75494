"""Entry: the pathfinder app's review path,
`apps/pathfinder.py::PathfinderApp.run_batched(chunk, render=True)`, on
one stream read as fast as it goes (a closed loop).

The app's own pipeline is under test: its prefetch thread's gray
conversion, the pinned chunk buffers, one captured graph a chunk, one
packed fetch a chunk behind an event, the unpacking. `run_batched` hands
each pair's host result only to `render_frame` (with render off it keeps
nothing but the danger counts, which the median / P99 mask holds at
N/2 - N/100 of the grid's N points whatever the flow), so the harness's
subclass overrides `render_frame` to keep a copy of the result and
returns the frame undrawn. Every pair's eight arrays are compared with
the reference's. The traffic's `chunk` is the app's chunk size; set-up
runs `warmup_chunks` chunks through the same call.
"""

from __future__ import annotations

import numpy as np

from portbench.harness import grid_check
from portbench.harness.cell import Window
from portbench.harness.clip import LoopReader, loop_index, pair_at
from portbench.harness.port import grid_params


def setup(ctx) -> None:
    from hackathonopticalflow_tpu_torch.apps.pathfinder import PathfinderApp, PathfinderConfig

    class KeepingApp(PathfinderApp):
        def render_frame(self, img, res, fps=None):
            self.stamps.append(ctx.clock())
            self.results.append(grid_check.host_arrays(res))
            return img

    s = ctx.streams[0]
    lk, norm, filt = grid_params(ctx.cfg)
    chunk = int(ctx.traffic["chunk"])
    ctx.opener.readers[s.name] = LoopReader(s.bgr, limit=1)
    app = KeepingApp(PathfinderConfig(video=s.name, step=lk.grid_step, lk=lk, norm=norm, filt=filt,
                                      device=str(ctx.device)), open_reader=ctx.opener)
    app.stamps, app.results = [], []
    ctx.opener.readers[s.name] = LoopReader(s.bgr, limit=chunk * int(ctx.traffic["warmup_chunks"]) + 1)
    app.run_batched(chunk=chunk, render=True)
    ctx.state["app"] = app


def window(ctx, t0: float, deadline: float) -> Window:
    s = ctx.streams[0]
    app = ctx.state["app"]
    app.stamps, app.results = [], []
    chunk = int(ctx.traffic["chunk"])
    reader = LoopReader(s.bgr, deadline=deadline, clock=ctx.clock)
    ctx.opener.readers[s.name] = reader
    app.run_batched(chunk=chunk, render=True)
    t1 = ctx.clock()
    pairs = max(reader.pos - 1, 0)
    steps = [[(0, *pair_at(k, s.n))] for k in range(1, pairs + 1)]
    # the tail chunk is padded with its last frame: (last, last) pairs
    last = loop_index(pairs, s.n)
    steps += [[(0, last, last)]] * (-pairs % chunk)
    return Window(t0, t1, answers=len(app.results), attempted=pairs, steps=steps, data={"results": app.results},
                  notes=_pace(app.stamps[::chunk], t0, t1))


def _pace(arrivals: list, t0: float, t1: float) -> dict:
    """How evenly the chunks' results arrived: the first one's wait (the
    pipeline's fill) and, after it, the median and the longest interval
    between two chunks' arrivals, the time the intervals took beyond the
    median (`slow_s`), and of that what the intervals over twice the
    median took (`stall_s`: the host standing still; the app keeps one
    chunk, about 58 ms, ahead of the device)."""
    gaps = np.diff(np.asarray([*arrivals, t1]))
    if len(gaps) < 3:
        return {}
    med = float(np.median(gaps))
    return {"first_ms": 1e3 * (arrivals[0] - t0), "chunk_ms_median": 1e3 * med,
            "chunk_ms_max": 1e3 * float(gaps.max()), "slow_s": float(np.sum(np.maximum(gaps - med, 0.0))),
            "stall_s": float(np.sum(gaps[gaps > 2 * med] - med))}


def release(ctx) -> None:
    ctx.state.clear()


def check(ctx, win: Window) -> tuple[dict, int]:
    return grid_check.compare(ctx, win.data["results"], win.attempted)
