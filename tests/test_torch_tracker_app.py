"""The port's tracker app against the JAX package's, on the 128x192 clip
that tests/test_apps.py writes with cv2 (both apps decode the same file),
at its narrow TrackerParams, the port on the CPU:

- 10 frames: final track count, pose count and pose frames identical,
  final heads within 0.05 px;
- each pose equal to estimate_relative_pose of the step's heads from the
  port's track_video over the same frames, and the final count to its.
  The poses are not held to JAX's: the clip is one plane sliding sideways,
  for which the 8-point estimate has a family of solutions, and at its 21
  px focal length the app's inlier gate (1e-5, 0.07 px) is within reach of
  the 1e-3 px by which the two trackers' heads differ; JAX's and the
  port's estimate_relative_pose are held to each other on well-posed
  scenes in tests/test_torch_pose_ba.py;
- a checkpointed run of 5 frames and its resume equal the full run;
- the same frames through an in-memory reader, and rendered to an mp4;
- device="cuda" without CUDA raises.
"""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402

from chip_smoke import ClipReader  # noqa: E402
from hackathonopticalflow_tpu.apps import tracker_app as japp  # noqa: E402
from hackathonopticalflow_tpu.apps.tracker_app import TrackerApp as JApp  # noqa: E402
from hackathonopticalflow_tpu.apps.tracker_app import TrackerAppConfig as JConfig  # noqa: E402
from hackathonopticalflow_tpu.core import config as jconfig  # noqa: E402
from hackathonopticalflow_tpu_torch import convert  # noqa: E402
from hackathonopticalflow_tpu_torch.apps import tracker_app as tapp  # noqa: E402
from hackathonopticalflow_tpu_torch.flow.tracker import _heads, init_tracker, track_step, track_video  # noqa: E402
from hackathonopticalflow_tpu_torch.io.prefetch import to_gray  # noqa: E402
from hackathonopticalflow_tpu_torch.nav.camera import Pinhole  # noqa: E402
from hackathonopticalflow_tpu_torch.nav.pose import estimate_relative_pose  # noqa: E402

torch.set_num_threads(1)

FRAMES = 10
JPARAMS = jconfig.TrackerParams(
    lk=jconfig.LKParams(win_size=(15, 15)),
    max_tracks=32,
    features=jconfig.FeatureParams(max_corners=16, quality_level=0.05, max_candidates=128),
)


def _make_clip(path: str, n: int = 11, h: int = 128, w: int = 192) -> None:
    """tests/test_apps.py's clip: a blurred noise texture sliding 1 px a
    frame down and right."""
    rng = np.random.RandomState(0)
    base = rng.uniform(40, 220, (h + 16, w + 16)).astype(np.uint8)
    base = cv2.GaussianBlur(base, (5, 5), 1.5)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (w, h))
    assert vw.isOpened()
    for t in range(n):
        g = base[4 + t : 4 + t + h, 4 + t : 4 + t + w]
        vw.write(cv2.cvtColor(g, cv2.COLOR_GRAY2BGR))
    vw.release()


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    _make_clip(path)
    return path


def _cfg(video, **kw):
    return tapp.TrackerAppConfig(video=video, params=convert.tracker_params(JPARAMS), device="cpu", **kw)


@pytest.fixture(scope="module")
def port_full(clip):
    return tapp.TrackerApp(_cfg(clip, max_frames=FRAMES)).run(headless=True)


def test_matches_jax(clip, port_full, monkeypatch):
    # the JAX app's eager pose, compiled once (its poses are only counted)
    monkeypatch.setattr(japp, "estimate_relative_pose", jax.jit(japp.estimate_relative_pose))
    want = JApp(JConfig(video=clip, params=JPARAMS, max_frames=FRAMES)).run(headless=True)
    got = port_full
    assert got["frames"] == want["frames"] == FRAMES and got["frames_this_run"] == FRAMES
    assert got["final_tracks"] == want["final_tracks"] > 0
    assert np.abs(got["final_heads"] - want["final_heads"]).max() <= 0.05
    assert [p["frame"] for p in got["poses"]] == [p["frame"] for p in want["poses"]] == list(range(1, FRAMES))


def test_poses_follow_the_tracks(clip, port_full):
    reader = tapp.VideoReader(clip)
    grays = torch.from_numpy(np.stack([to_gray(reader.read()) for _ in range(FRAMES)]))
    params = convert.tracker_params(JPARAMS)
    s0 = track_step(init_tracker(params, device="cpu"), grays[0], grays[0], params, device="cpu")
    state, (heads, alive, _) = track_video(grays, params, s0, device="cpu")
    heads = torch.cat([_heads(s0)[None], heads])
    alive = torch.cat([s0.alive[None], alive])
    assert port_full["final_tracks"] == int(state.alive.sum())
    cam = Pinhole.from_fov(192, 128, 155.0)
    for p in port_full["poses"]:
        n = p["frame"]
        want = estimate_relative_pose(cam.normalize(heads[n - 1]), cam.normalize(heads[n]), alive[n] & alive[n - 1])
        assert np.array_equal(p["R"], want.R.numpy()) and np.array_equal(p["t"], want.t.numpy())
        assert p["inliers"] == int(want.n_inliers)


def test_checkpoint_resume(clip, port_full, tmp_path):
    ck = str(tmp_path / "tr.ckpt.npz")
    part1 = tapp.TrackerApp(_cfg(clip, max_frames=5, checkpoint_path=ck, checkpoint_every=2)).run(headless=True)
    assert part1["frames"] == 5
    part2 = tapp.TrackerApp(_cfg(clip, max_frames=FRAMES, checkpoint_path=ck, checkpoint_every=2)).run(headless=True)
    assert part2["frames"] == FRAMES and part2["frames_this_run"] == FRAMES - 4  # resumed after frame 4
    assert part2["final_tracks"] == port_full["final_tracks"]
    assert np.array_equal(part2["final_heads"], port_full["final_heads"])
    assert len(part2["poses"]) == len(port_full["poses"])
    for a, b in zip(part2["poses"], port_full["poses"]):
        assert a["frame"] == b["frame"] and a["inliers"] == b["inliers"]
        assert np.array_equal(a["R"], b["R"]) and np.array_equal(a["t"], b["t"])


def test_reader_seam_and_render(clip, port_full, tmp_path):
    """The decoded frames through an in-memory reader give the same run,
    and a rendered run writes every frame (with cv2)."""
    reader = tapp.VideoReader(clip)
    bgr = np.stack([reader.read() for _ in range(FRAMES)])
    mem = tapp.TrackerApp(_cfg("clip", max_frames=FRAMES), open_reader=lambda path: ClipReader(bgr)).run()
    assert mem["final_tracks"] == port_full["final_tracks"]
    assert np.array_equal(mem["final_heads"], port_full["final_heads"])
    out = str(tmp_path / "out.mp4")
    stats = tapp.TrackerApp(_cfg(clip, max_frames=4, estimate_pose=False)).run(headless=True, out_path=out)
    assert stats["frames"] == 4 and stats["poses"] == []
    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    assert n == 4


def test_cuda_device_without_cuda_raises(clip):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tapp.TrackerApp(tapp.TrackerAppConfig(video=clip))
