"""Entry: the fleet review, `apps/batch_runner.py::run_batch`, on the
traffic's streams (the configuration's flights) in lockstep, each read as
fast as the batched step goes (a closed loop).

The runner's own pipeline is under test: one frame prefetcher a stream
and its gray conversion, the pinned (B, H, W) frame batch, one
stream-batched grid-LK graph a step, one packed copy a step behind an
event, the unpacking and the per-result hook `BatchRunnerConfig.on_result`,
which the entry sets to keep a copy of every live pair's eight arrays and
stamp it. Every pair of every stream is compared with the reference run
on that stream alone. Set-up runs `warmup_steps` steps through the same
call on the card (one on the CPU, where nothing is built or captured).

`steps` lists every step the device ran in the window, each stream's
pair in it: run_batch's first step (the first frames against
themselves, replayed before its own clock, on the card only), then one a
frame index; a stream that has ended repeats its last frame, (last,
last), until every stream has.
"""

from __future__ import annotations

import numpy as np

from portbench.harness import grid_check
from portbench.harness.cell import Window
from portbench.harness.clip import LoopReader, loop_index, pair_at
from portbench.harness.port import grid_params


def setup(ctx) -> None:
    from hackathonopticalflow_tpu_torch.apps.batch_runner import BatchRunnerConfig, run_batch

    streams = int(ctx.traffic["streams"])
    if streams != int(ctx.cfg["streams"]):
        raise ValueError(f"the traffic runs {streams} streams; the configuration {ctx.cfg['name']} "
                         f"states {ctx.cfg['streams']}")
    lk, norm, filt = grid_params(ctx.cfg)
    kept = {"results": [[] for _ in ctx.streams], "stamps": []}

    def keep(stream, pair, res):
        kept["stamps"].append(ctx.clock())
        kept["results"][stream].append(grid_check.host_arrays(res))

    cfg = BatchRunnerConfig(videos=[s.name for s in ctx.streams], step=lk.grid_step, lk=lk, norm=norm, filt=filt,
                            device=str(ctx.device), open_reader=ctx.opener, on_result=keep)
    warm = int(ctx.traffic["warmup_steps"]) if ctx.device.type == "cuda" else 1
    for s in ctx.streams:
        ctx.opener.readers[s.name] = LoopReader(s.bgr, limit=warm + 1)
    run_batch(cfg)
    ctx.state.update(cfg=cfg, kept=kept, run_batch=run_batch)


def window(ctx, t0: float, deadline: float) -> Window:
    kept = ctx.state["kept"]
    kept["results"] = [[] for _ in ctx.streams]
    kept["stamps"] = []
    readers = []
    for s in ctx.streams:
        readers.append(LoopReader(s.bgr, deadline=deadline, clock=ctx.clock))
        ctx.opener.readers[s.name] = readers[-1]
    stats = ctx.state["run_batch"](ctx.state["cfg"])
    t1 = ctx.clock()
    pairs = [max(r.pos - 1, 0) for r in readers]
    steps = [[(i, 0, 0) for i in range(len(ctx.streams))]] if ctx.device.type == "cuda" else []
    for k in range(1, max(pairs) + 1):
        steps.append([(i, *pair_at(k, s.n)) if k <= pairs[i] else (i, *(2 * [loop_index(pairs[i], s.n)]))
                      for i, s in enumerate(ctx.streams)])
    answers = sum(len(r) for r in kept["results"])
    notes = {"steps": stats["steps"], "pairs_by_stream": pairs}
    if kept["stamps"]:
        # the pipeline's fill, the longest the host went without a result,
        # and the rate in each quarter of the window
        stamps = np.asarray(kept["stamps"])
        gaps = np.diff(np.concatenate([[t0], stamps, [t1]]))
        quarter = (t1 - t0) / 4
        counts = np.bincount(np.minimum(((stamps - t0) // quarter).astype(int), 3), minlength=4)
        notes.update(first_ms=1e3 * gaps[0], gap_ms_max=1e3 * gaps[1:].max(),
                     pairs_per_s_by_quarter=(counts / quarter).tolist())
    return Window(t0, t1, answers=answers, attempted=sum(pairs), steps=steps,
                  data={"results": kept["results"], "pairs": pairs}, notes=notes)


def release(ctx) -> None:
    ctx.state.clear()


def check(ctx, win: Window) -> tuple[dict, int]:
    """grid_check.compare on each stream, against the reference on that
    stream alone: bad pairs summed over the streams, each float array's
    largest gap over them all. Each stream's bad pairs go into the notes."""
    total = {"bad_pairs": 0, "raw_next_pts_max_px": 0.0, "modulus_max": 0.0, "ang_max_rad": 0.0}
    by_stream = []
    for i, (got, due) in enumerate(zip(win.data["results"], win.data["pairs"])):
        numbers, bad = grid_check.compare(ctx, got, due, stream=i)
        by_stream.append(bad)
        for name, value in numbers.items():
            total[name] = total[name] + value if name == "bad_pairs" else max(total[name], value)
    win.notes["bad_pairs_by_stream"] = by_stream
    return total, sum(by_stream)
