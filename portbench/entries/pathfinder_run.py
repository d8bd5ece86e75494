"""Entry: the pathfinder app's live path,
`apps/pathfinder.py::PathfinderApp.run(headless=True, render=True)`, fed
by a camera: an open loop that releases frame i at t0 + i / fps (the
traffic's `fps`) whatever the app is doing.

`run` hands each frame's host result to `render_frame` and has no other
hook, so the harness's subclass overrides `render_frame` to stamp the time
and keep the result, and returns the frame undrawn (the drawing is not
what pilots run here: there is no cv2). The app's own fetch of all eight
GridFlowResult arrays still runs. A frame's latency runs from its due time
on the camera's clock to the stamp, when its result is on the host. Every
frame's eight arrays are compared with the reference's.
"""

from __future__ import annotations

import numpy as np

from portbench.harness import grid_check
from portbench.harness.cell import Window
from portbench.harness.clip import LoopReader, PacedReader, pair_at
from portbench.harness.port import grid_params


def setup(ctx) -> None:
    from hackathonopticalflow_tpu_torch.apps.pathfinder import PathfinderApp, PathfinderConfig

    class StampedApp(PathfinderApp):
        def render_frame(self, img, res, fps=None):
            self.stamps.append(ctx.clock())
            self.results.append(grid_check.host_arrays(res))
            return img

    s = ctx.streams[0]
    lk, norm, filt = grid_params(ctx.cfg)
    ctx.opener.readers[s.name] = LoopReader(s.bgr, limit=int(ctx.traffic["warmup_frames"]))
    app = StampedApp(PathfinderConfig(video=s.name, step=lk.grid_step, lk=lk, norm=norm, filt=filt,
                                      device=str(ctx.device)), open_reader=ctx.opener)
    app.stamps, app.results = [], []
    app.run(headless=True, render=True)
    ctx.state["app"] = app


def window(ctx, t0: float, deadline: float) -> Window:
    s = ctx.streams[0]
    app = ctx.state["app"]
    app.stamps, app.results = [], []
    reader = PacedReader(s.bgr, t0, float(ctx.traffic["fps"]), deadline, clock=ctx.clock)
    app.reader = reader
    app.run(headless=True, render=True)
    t1 = ctx.clock()
    # the k-th result is frame k + 1's (frame 0 opens the first pair)
    lat = [stamp - reader.due[k + 1] for k, stamp in enumerate(app.stamps)]
    lateness = np.asarray(reader.released) - np.asarray(reader.due)
    frames = max(reader.pos - 1, 0)
    # host work of an iteration: from frame k + 2's release to frame k + 1's result
    work = np.asarray(app.stamps[:-1]) - np.asarray(reader.released[2:len(app.stamps) + 1])
    return Window(t0, t1, answers=len(app.results), attempted=frames,
                  steps=[[(0, *pair_at(k, s.n))] for k in range(1, frames + 1)], latencies_s=lat,
                  data={"results": app.results},
                  notes={"frame_read_late_max_ms": 1e3 * float(lateness.max()) if len(lateness) else 0.0,
                         "iteration_ms_p50_p95_max": [1e3 * float(np.percentile(work, q)) for q in (50, 95, 100)]
                         if len(work) else None})


def release(ctx) -> None:
    ctx.state.clear()


def check(ctx, win: Window) -> tuple[dict, int]:
    return grid_check.compare(ctx, win.data["results"], win.attempted)
