"""`correct` at tiny sizes on the CPU, through the port's plain versions:
a sound run passes; the control (the reference in bf16 for the grid
flow, the port's "packed" warp for Farneback) fails; and each fault a
cell can have, planted in the port underneath the timed path, fails:
a step that returns its state unchanged, half of a batch left out and
the rest's answers repeated, an answer altered where it is produced.
The cells have no exchange between chips."""

import pytest
import torch

import portbench_tiny
from hackathonopticalflow_tpu_torch.apps import pathfinder
from hackathonopticalflow_tpu_torch.flow import dense, lk_grid
from portbench.reference.lk_grid import LKGridReference

CELLS = portbench_tiny.cells()


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    out = portbench_tiny.run_tiny(workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 3
    assert out["attempted"] == out["_window"].answers
    assert list(out)[-3] == "checks" and set(out["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    out = portbench_tiny.run_tiny(workload, control=True)
    assert not out["correct"], out["checks"]


def _unchanged_state(monkeypatch, workload):
    """The clip step hands back the previous frame's state: every pair is
    computed against a stale frame."""
    mod = dense if "farneback" in workload else lk_grid
    orig = mod._video_step

    def stale(prev, *args, **kwargs):
        out, _ = orig(prev, *args, **kwargs)
        return out, prev

    monkeypatch.setattr(mod, "_video_step", stale)
    if workload.endswith("live60"):
        orig_frame = pathfinder.PathfinderApp.compute_frame
        first = {}

        def no_advance(self, prev_gray, gray):
            first.setdefault("prev", prev_gray)
            return orig_frame(self, first["prev"], gray)

        monkeypatch.setattr(pathfinder.PathfinderApp, "compute_frame", no_advance)


def _half_batch(monkeypatch, workload):
    """A chunk computes its first half of pairs and repeats their answers
    for the rest."""
    def halve(orig):
        def half(frames, *args, **kwargs):
            t = frames.shape[0] - 1
            out = orig(frames[: t // 2 + 1], *args, **kwargs)
            idx = torch.arange(t) % (t // 2)
            if isinstance(out, torch.Tensor):
                return out[idx]
            return type(out)(*(f[idx] for f in out))
        return half

    if "farneback" in workload:
        monkeypatch.setattr(dense, "farneback_flow_video", halve(dense.farneback_flow_video))
    else:
        monkeypatch.setattr(pathfinder, "lk_grid_flow_video", halve(pathfinder.lk_grid_flow_video))


def _altered_answer(monkeypatch, workload):
    """One answer altered where it is produced: one point's `good` flipped,
    or one flow value moved by 1e-3 px."""
    if "farneback" in workload:
        orig = dense._video_step

        def nudged(prev, frame, params):
            flow, cur = orig(prev, frame, params)
            flow = flow.clone()
            flow[0, 0, 0] += 1e-3
            return flow, cur

        monkeypatch.setattr(dense, "_video_step", nudged)
    else:
        orig = lk_grid._post_lk

        def flipped(*args, **kwargs):
            res = orig(*args, **kwargs)
            good = res.good.clone()
            good[..., 0] = ~good[..., 0]
            return res._replace(good=good)

        monkeypatch.setattr(lk_grid, "_post_lk", flipped)


FAULTS = [(w, f) for w in CELLS for f in ("unchanged_state", "half_batch", "altered_answer")
          if not (f == "half_batch" and w.endswith("live60"))]  # live60 runs one pair at a time


@pytest.mark.parametrize("workload,fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, workload, fault):
    {"unchanged_state": _unchanged_state, "half_batch": _half_batch, "altered_answer": _altered_answer}[fault](
        monkeypatch, workload)
    out = portbench_tiny.run_tiny(workload)
    assert not out["correct"], out["checks"]


def test_the_reference_is_the_ports_plain_path():
    """The frozen reference and the port's plain path agree bit for bit
    on every output (at a size where the plain path runs here)."""
    from hackathonopticalflow_tpu_torch.core import FilterParams, LKParams, NormalizeParams, measurement_grid
    from hackathonopticalflow_tpu_torch.core import FarnebackParams
    from portbench.harness.clip import make_clip
    from portbench.reference.farneback import FarnebackReference

    cfg = portbench_tiny.tiny_cell("pathfinder-1080p.review").config
    clip = make_clip("cpu", cfg["height"], cfg["width"], 2, 6, 11, 1.02)
    ref = LKGridReference(cfg, "cpu")
    want = ref.pair(ref.prepare(clip[0]), ref.prepare(clip[1]))
    lk = LKParams(**{**cfg["lk"], "win_size": tuple(cfg["lk"]["win_size"])})
    pts = torch.from_numpy(measurement_grid(cfg["height"], cfg["width"], lk.grid_step))
    got = lk_grid.lk_grid_flow(clip[0], clip[1], pts, lk, NormalizeParams(), FilterParams(), device="cpu")
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f

    fcfg = portbench_tiny.tiny_cell("farneback-720p.scan").config
    fclip = make_clip("cpu", fcfg["height"], fcfg["width"], 2, 2, 12, 1.02)
    fref = FarnebackReference(fcfg, "cpu")
    fwant = fref.pair(fref.prepare(fclip[0]), fref.prepare(fclip[1]))
    fgot = dense.farneback_flow(fclip[0], fclip[1], FarnebackParams(**fcfg["farneback"]), device="cpu")
    assert torch.equal(fgot, fwant)
