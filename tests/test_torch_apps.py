"""The port's pathfinder app against the JAX package's, on one small
cv2-written mp4 (both apps decode the same file), with LKParams() (the
exact path) in both and the port on the CPU:

- per-pair danger counts within 2% of the grid's points of JAX's (the
  exact path agrees to 1e-3 px, which can flip borderline points);
- the port's `run`, `run_batched(chunk=3)` and `lk_grid_flow_video`'s
  `good` sums agree exactly, and so does a checkpointed run of 6 pairs
  plus its resume;
- `run` presents each frame before it reads the next, and the arrays it
  renders equal `compute_frame`'s;
- headless rendering without cv2, and the errors where cv2 or CUDA is
  missing.
"""

from unittest import mock

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from chip_smoke import ClipReader  # noqa: E402
from hackathonopticalflow_tpu.apps.pathfinder import PathfinderApp as JApp  # noqa: E402
from hackathonopticalflow_tpu.apps.pathfinder import PathfinderConfig as JConfig  # noqa: E402
from hackathonopticalflow_tpu_torch.apps import pathfinder as tpf  # noqa: E402
from hackathonopticalflow_tpu_torch.core import LKParams, measurement_grid  # noqa: E402
from hackathonopticalflow_tpu_torch.flow.lk_grid import lk_grid_flow_video  # noqa: E402
from hackathonopticalflow_tpu_torch.viz import draw as tdraw  # noqa: E402

torch.set_num_threads(1)

H, W, PAIRS, CHUNK = 180, 320, 12, 3


def _make_clip(path: str, n: int = PAIRS + 2, h: int = H, w: int = W) -> None:
    """Blurred noise textures as tests/test_apps.py writes them (the grid
    has 60 points): a static one whose right 40% is replaced by a second
    texture drifting right by 0-3 px a frame. The static points' flow is
    0, the median too, so each pair's count follows the mover's step (0
    where it rests): a pair out of place shows."""
    rng = np.random.RandomState(7)
    pad = 3 * n + 8
    base = cv2.GaussianBlur(rng.uniform(40, 220, (h + pad, w + pad)).astype(np.uint8), (5, 5), 1.5)
    mover = cv2.GaussianBlur(rng.uniform(40, 220, (h + pad, w + pad)).astype(np.uint8), (5, 5), 1.5)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (w, h))
    assert vw.isOpened()
    cut = int(w * 0.6) // 16 * 16
    x = 4
    for _ in range(n):
        f = base[4 : 4 + h, 4 : 4 + w].copy()
        f[:, cut:] = mover[4 : 4 + h, x + cut : x + w]
        vw.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
        x += int(rng.randint(0, 4))
    vw.release()


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    _make_clip(path)
    return path


@pytest.fixture(scope="module")
def jax_counts(clip):
    stats = JApp(JConfig(video=clip, max_frames=PAIRS)).run_batched(chunk=CHUNK, render=False)
    assert stats["frames"] == PAIRS
    return stats["danger_counts"]


def _cfg(clip, **kw):
    return tpf.PathfinderConfig(video=clip, lk=LKParams(), device="cpu", **kw)


@pytest.fixture(scope="module")
def port_batched(clip):
    return tpf.PathfinderApp(_cfg(clip, max_frames=PAIRS)).run_batched(chunk=CHUNK, render=False)


def test_danger_counts_match_jax(port_batched, jax_counts):
    n_pts = measurement_grid(H, W, 30).shape[0]
    assert n_pts == 60
    got = port_batched["danger_counts"]
    assert len(got) == len(jax_counts) == PAIRS
    assert max(abs(a - b) for a, b in zip(got, jax_counts)) <= 0.02 * n_pts
    assert len(set(got[6:])) > 1  # the resumed pairs differ from each other


def test_run_batched_run_and_scan_agree(clip, port_batched):
    """One-pair loop, chunked pipeline (full chunks and the padded tail of
    the last) and the clip scan give the same per-pair counts."""
    serial = tpf.PathfinderApp(_cfg(clip, max_frames=PAIRS)).run(headless=True, render=False)
    assert serial["danger_counts"] == port_batched["danger_counts"]
    assert serial["frames"] == port_batched["frames"] == PAIRS
    assert serial["first_pair_frame"] == port_batched["first_pair_frame"] == 1
    reader = tpf.VideoReader(clip)
    grays = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in reader.frames(count=PAIRS + 1)])
    res = lk_grid_flow_video(torch.from_numpy(grays), torch.from_numpy(measurement_grid(H, W, 30)),
                             LKParams(), device="cpu")
    assert res.good.sum(1).tolist() == port_batched["danger_counts"]
    # the same frames through an in-memory reader
    mem = tpf.PathfinderApp(_cfg("clip", max_frames=PAIRS), open_reader=lambda path: ClipReader(grays))
    assert mem.run_batched(chunk=5)["danger_counts"] == port_batched["danger_counts"]
    for key in ("wall_s", "compute_s", "fps", "compute_fps", "mean_danger_points"):
        assert key in serial and key in port_batched


def test_checkpoint_resume(clip, port_batched, tmp_path):
    """A run stopped after 6 pairs resumes from its checkpoint to the same
    counts as the uninterrupted run."""
    ck = str(tmp_path / "pf.ckpt.npz")
    part1 = tpf.PathfinderApp(_cfg(clip, max_frames=6, checkpoint_path=ck, checkpoint_every=3)).run_batched(
        chunk=CHUNK)
    assert part1["frames"] == 6
    part2 = tpf.PathfinderApp(_cfg(clip, max_frames=PAIRS, checkpoint_path=ck, checkpoint_every=3)).run_batched(
        chunk=CHUNK)
    assert part2["first_pair_frame"] == 7 and part2["frames"] == 6
    assert part1["danger_counts"] + part2["danger_counts"] == port_batched["danger_counts"]


def test_run_presents_each_frame_before_it_reads_the_next(clip, port_batched):
    """`run` reads frame k + 1 only after frame k is rendered; the arrays it
    renders equal `compute_frame`'s on the same pair, in dtype and value,
    and its counts equal `run_batched`'s."""
    reader = tpf.VideoReader(clip)
    grays = np.stack([cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in reader.frames(count=PAIRS + 1)])
    log = []

    class LoggedReader(ClipReader):
        def read(self):
            log.append(("read", self.pos))
            return super().read()

    class LoggedApp(tpf.PathfinderApp):
        def render_frame(self, img, res, fps=None):
            log.append(("render", len(self.rendered) + 1))
            self.rendered.append({f: np.array(getattr(res, f)) for f in res._fields})
            return img

    app = LoggedApp(_cfg("clip", max_frames=PAIRS), open_reader=lambda path: LoggedReader(grays))
    app.rendered = []
    stats = app.run(headless=True, render=True)
    assert stats["frames"] == len(app.rendered) == PAIRS
    assert stats["danger_counts"] == port_batched["danger_counts"]
    # frame 0 opens the first pair; frame k is read, then pair k rendered
    assert log == [("read", 0)] + [e for k in range(1, PAIRS + 1) for e in (("read", k), ("render", k))]
    for k, got in enumerate(app.rendered, start=1):
        want = app.compute_frame(grays[k - 1], grays[k])
        assert got["pts"].dtype == np.int32
        for f in want._fields:
            w = want._asdict()[f].numpy()
            assert got[f].dtype == w.dtype and np.array_equal(got[f], w), (k, f)


@pytest.mark.parametrize("have_cv2", [True, False])
def test_render_headless(clip, have_cv2):
    """Composited frames with lamps, with cv2 and through the numpy
    rasterizer."""
    app = tpf.PathfinderApp(_cfg(clip, max_frames=2))
    frame = app.reader.read()
    res = app.compute_frame(cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY),
                            cv2.cvtColor(app.reader.read(), cv2.COLOR_BGR2GRAY))
    with mock.patch.object(tdraw, "HAVE_CV2", have_cv2):
        out = app.render_frame(frame, res, fps=12.5)
    assert out.shape == (H, W, 3) and out.dtype == np.uint8
    assert (out != frame).any()
    if not have_cv2:
        with mock.patch.object(tpf, "HAVE_CV2", False), mock.patch.object(tdraw, "HAVE_CV2", False):
            stats = app.run(headless=True, render=True)
            assert stats["frames"] == 2
            with pytest.raises(RuntimeError, match="cv2"):
                app.run(headless=True, out_path="out.mp4")
            with pytest.raises(RuntimeError, match="cv2"):
                app.run(headless=False)


def test_renders_mp4(clip, tmp_path):
    out = str(tmp_path / "out.mp4")
    stats = tpf.PathfinderApp(_cfg(clip, max_frames=4)).run_batched(chunk=2, out_path=out, render=True)
    assert stats["frames"] == 4
    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    assert n == 4


def test_cuda_device_without_cuda_raises(clip):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpf.PathfinderApp(tpf.PathfinderConfig(video=clip))
