"""The benchmark's tracker cell on the CPU, through the port's plain
versions: the configuration builds the port's default TrackerParams; the
plain reference (portbench/reference/tracker.py) equals the port's
`track_video(device="cpu")` bit for bit over chains long enough that the
table fills and its trajectories roll, whatever step the detections fall
on; a tiny run of the cell's entry reads 0; and a history shifted by one
step, one detection skipped and the control each read bad."""

import copy
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from hackathonopticalflow_tpu_torch.core import TrackerParams
from hackathonopticalflow_tpu_torch.flow import tracker
from portbench.harness.cell import run_cell
from portbench.harness.clip import make_clip
from portbench.harness.spec import resolve_cell
from portbench.harness.tracker_check import tracker_params
from portbench.reference.tracker import State, TrackerReference

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CELL = "tracker-1080p.tracks"
SEED = 2**31 + 977  # past 32 signed bits, as a benchmark seed may be


def _small_config(h=120, w=160, max_tracks=32, trajectory_len=6):
    cfg = copy.deepcopy(resolve_cell(ROOT, CELL).config)
    cfg.update(height=h, width=w)
    cfg["tracker"].update(max_tracks=max_tracks, trajectory_len=trajectory_len)
    return cfg


def test_the_configuration_builds_the_ports_default_tracker():
    assert tracker_params(resolve_cell(ROOT, CELL).config) == TrackerParams()


@pytest.mark.parametrize("phase", [1, 3, 4])
def test_the_reference_is_the_ports_plain_tracker(phase):
    """12 frames at 120x160 into a 32-slot table of 6-point tracks: the
    seeding step, then 11 steps starting at frame index `phase`, so that
    the detections fall on other steps; every step's history and the
    final table are identical."""
    cfg = _small_config()
    params = tracker_params(cfg)
    clip = make_clip("cpu", cfg["height"], cfg["width"], 12, 6, 1234 + phase, 1.02)
    ref = TrackerReference(cfg, "cpu")
    seeded = tracker.track_step(tracker.init_tracker(params, "cpu"), clip[0], clip[0], params, device="cpu")
    want_seed = ref.seed(clip[0])
    for got, want in zip(seeded[:3], want_seed[:3]):
        assert torch.equal(got, want)
    start = seeded._replace(frame_idx=phase)
    got_state, got_hist = tracker.track_video(clip, params, start, device="cpu")
    want_state, want_hist = ref.run(State(*start), clip)
    for name, got, want in zip(("heads", "alive", "length"), got_hist, want_hist):
        assert torch.equal(got, want), name
    for got, want in zip(got_state[:3], want_state[:3]):
        assert torch.equal(got, want)
    assert got_state.frame_idx == want_state.frame_idx == phase + 11
    alive, length = got_hist[1], got_hist[2]
    assert int(alive.sum(-1).max()) == 32, "the table fills"
    assert int((alive & (length == 6)).sum()) > 32, "trajectories reach capacity and roll"


def _tiny_cell():
    cell = resolve_cell(ROOT, CELL)
    cell.config = _small_config(max_tracks=256, trajectory_len=40)
    cell.traffic = dict(cell.traffic, clip_frames=5, chunk=3)
    return cell


def _run(control=False):
    return run_cell(ROOT, CELL, SEED, 0.4, False, device="cpu", control=control, cell=_tiny_cell())


def test_a_tiny_run_of_the_cell_reads_zero():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["checks"] == {"bad_steps": {"value": 0.0, "limit": 0.0}, "heads_max_px": {"value": 0.0, "limit": 0.0}}
    win = out["_window"]
    assert out["failed"] == 0 and out["attempted"] == win.answers == 3 * len(win.data["chunks"])
    assert set(out["metrics"]) == {"pairs_per_s", "setup_s"}
    assert win.notes["births"] > 0 and win.notes["live_tracks_min"] >= 20
    assert len(win.data["ref_stats"]) == 3 * len(win.data["kept"]) and len(win.data["ref_stats"][(0, 0)]) == 6


def _shifted_history(monkeypatch):
    """track_video's history one step late: the first step's row twice."""
    orig = tracker.track_video

    def shifted(*args, **kwargs):
        state, hist = orig(*args, **kwargs)
        return state, tuple(torch.cat([h[:1], h[:-1]]) for h in hist)

    monkeypatch.setattr(tracker, "track_video", shifted)


def _skipped_detection(monkeypatch):
    """The first detecting step of the window (set-up's chunk of 3 steps
    from frame index 1 has none) runs without its detection."""
    orig = tracker._frame_graph
    skipped = []

    def skip(traj, length, alive, prev, frame, params, detect):
        if detect and not skipped:
            skipped.append(True)
            detect = False
        return orig(traj, length, alive, prev, frame, params, detect)

    monkeypatch.setattr(tracker, "_frame_graph", skip)


@pytest.mark.parametrize("fault", ["shifted_history", "skipped_detection", "control"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    if fault == "shifted_history":
        _shifted_history(monkeypatch)
    elif fault == "skipped_detection":
        _skipped_detection(monkeypatch)
    out = _run(control=fault == "control")
    assert not out["correct"], out["checks"]
    assert out["checks"]["bad_steps"]["value"] > 0 and out["checks"]["heads_max_px"]["value"] > 0


def test_the_tracker_reference_and_entry_load_no_jax():
    """The reference loads nothing of the port; the entry and the check
    load the port only when they run."""
    probe = ("import sys, json\n"
             "import portbench.reference.tracker, portbench.harness.tracker_check\n"
             "import portbench.harness.tracker_work, portbench.harness.correlation\n"
             "from portbench.harness.spec import load_module, BENCH_DIR\n"
             "load_module(BENCH_DIR / 'entries' / 'tracker_scan.py')\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not names & {"jax", "jaxlib", "flax", "hackathonopticalflow_tpu", "hackathonopticalflow_tpu_torch"}
