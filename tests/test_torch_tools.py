"""The port's small host and op modules against the JAX package's on the
same seeded inputs: histogram256 and kmeans (ops/stats.py),
conv2d_single (ops/image.py), io/tools.py, io/prefetch.py::batch_frames,
viz/plotter.py, utils/profiling.py, and entry.py against the JAX
components __graft_entry__.py::entry calls."""

import importlib
import time
from unittest import mock

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from hackathonopticalflow_tpu.core import FarnebackParams as JFarnebackParams  # noqa: E402
from hackathonopticalflow_tpu.core import measurement_grid  # noqa: E402
from hackathonopticalflow_tpu.flow import lk_grid as jgrid  # noqa: E402
from hackathonopticalflow_tpu.io import prefetch as jprefetch  # noqa: E402
from hackathonopticalflow_tpu.io import tools as jtools  # noqa: E402
from hackathonopticalflow_tpu.nav.danger import danger_values as j_danger_values  # noqa: E402
from hackathonopticalflow_tpu.nav.foe import estimate_foe as j_estimate_foe  # noqa: E402
from hackathonopticalflow_tpu.ops import image as jimage  # noqa: E402
from hackathonopticalflow_tpu.ops import stats as jstats  # noqa: E402
from hackathonopticalflow_tpu.viz.plotter import Plotter as JPlotter  # noqa: E402
from hackathonopticalflow_tpu_torch.entry import entry  # noqa: E402
from hackathonopticalflow_tpu_torch.io import native_lib  # noqa: E402
from hackathonopticalflow_tpu_torch.io import prefetch as tprefetch  # noqa: E402
from hackathonopticalflow_tpu_torch.io import tools as ttools  # noqa: E402
from hackathonopticalflow_tpu_torch.ops import image as timage  # noqa: E402
from hackathonopticalflow_tpu_torch.ops import stats as tstats  # noqa: E402
from hackathonopticalflow_tpu_torch.utils.profiling import FpsCounter, Timer  # noqa: E402
from hackathonopticalflow_tpu_torch.viz.plotter import Plotter, draw_plot  # noqa: E402
from test_torch_prepare import smooth_texture  # noqa: E402

# the JAX package's ops/__init__ re-exports a function named farneback
jfb = importlib.import_module("hackathonopticalflow_tpu.ops.farneback")

torch.set_num_threads(1)


def _bgr(seed, h=60, w=80):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.fixture(scope="module")
def mp4(tmp_path_factory):
    """A 6-frame 96x160 cv2-written mp4 of a drifting smooth texture."""
    path = str(tmp_path_factory.mktemp("mp4") / "clip.mp4")
    sm = np.clip(np.floor(smooth_texture(4, 140, 200) + 0.5), 0, 255).astype(np.uint8)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (160, 96))
    assert vw.isOpened()
    for t in range(6):
        vw.write(cv2.cvtColor(sm[10 + t : 106 + t, 10 + 2 * t : 170 + 2 * t], cv2.COLOR_GRAY2BGR))
    vw.release()
    return path


@pytest.mark.parametrize("kind", ["u8", "float"])
def test_histogram256_matches_jax(kind):
    rng = np.random.RandomState(1)
    x = rng.randint(0, 256, (37, 53)).astype(np.uint8) if kind == "u8" else rng.uniform(-20, 300, (4, 37, 53)).astype(np.float32)
    got = tstats.histogram256(torch.from_numpy(x))
    want = np.asarray(jstats.histogram256(jnp.asarray(x)))
    assert got.dtype == torch.int32 and got.shape == (256,)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["2d", "1d", "init", "empty"])
def test_kmeans_matches_jax(case):
    rng = np.random.RandomState(2)
    x = np.concatenate([rng.normal(c, 0.3, (50, 3)) for c in (0.0, 2.0, 5.0, 9.0)]).astype(np.float32)
    init = None
    if case == "1d":
        x = x[:, 0].copy()
    elif case == "init":
        init = x[[0, 60, 120, 180]] + 0.5
    elif case == "empty":  # a centre far from every sample keeps its place
        init = np.array([[0, 0, 0], [5, 5, 5], [9, 9, 9], [100, 100, 100]], np.float32)
    tinit = None if init is None else torch.from_numpy(init)
    jinit = None if init is None else jnp.asarray(init)
    comp, labels, centers = tstats.kmeans(torch.from_numpy(x), 4, 10, tinit)
    jcomp, jlabels, jcenters = jstats.kmeans(jnp.asarray(x), 4, 10, jinit)
    assert np.array_equal(labels.numpy(), np.asarray(jlabels))
    np.testing.assert_allclose(centers.numpy(), np.asarray(jcenters), atol=1e-5)
    np.testing.assert_allclose(float(comp), float(jcomp), rtol=1e-5)
    if case == "empty":
        assert np.array_equal(centers.numpy()[3], init[3])


@pytest.mark.parametrize("shape", [(40, 50), (2, 3, 40, 50)])
def test_conv2d_single_matches_jax(shape):
    rng = np.random.RandomState(3)
    img = rng.uniform(0, 255, shape).astype(np.float32)
    k = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    got = timage.conv2d_single(torch.from_numpy(img), torch.from_numpy(k))
    want = np.asarray(jimage.conv2d_single(jnp.asarray(img), jnp.asarray(k)))
    assert got.shape == want.shape == shape[:-2] + (36, 48)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("case", [("gray", 40, True), ("bgr", 40, True), ("bgr", 30, True), ("bgr", 70, True),
                                  ("gray", 100, False)])
def test_resize_image_matches_jax(case):
    kind, des_w, area = case
    img = _bgr(4)
    if kind == "gray":
        img = img[..., 0].copy()
    got = ttools.resize_image(img, des_w, area=area)
    want = jtools.resize_image(img, des_w, area=area)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    # float64 (port) and float32 (JAX) coverage sums of a non-integer
    # shrink round alike but where the value lies within float32 noise of
    # a half level (24 of 10,920 values at width 70); the rest is exact
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    if des_w != 70:
        assert np.array_equal(got, want)
    assert np.mean(got == want) >= 0.99


def test_compare_blur_threshold_matches_jax():
    img = cv2.GaussianBlur(_bgr(5, 90, 120), (7, 7), 2.0)
    got, want = ttools.compare_blur_threshold(img), jtools.compare_blur_threshold(img)
    assert sorted(got) == sorted(want) == ["blur3", "blur7", "raw"]
    for k in got:
        assert got[k].dtype == np.uint8
        assert np.array_equal(got[k], want[k]), k


def test_channel_histograms_match_jax():
    img = _bgr(6)
    got, want = ttools.channel_histograms(img), jtools.channel_histograms(img)
    for c in "hsv":
        assert np.array_equal(got["hists"][c], want["hists"][c]), c
    assert np.array_equal(got["hue_view"], want["hue_view"])


def test_frame_queue_matches_jax():
    got, want = ttools.FrameQueue(3), jtools.FrameQueue(3)
    for i in range(7):
        frame = np.full((2, 2), i, np.uint8)
        got.push(frame, i)
        want.push(frame, i)
        assert len(got) == len(want)
        assert [j for _, j in got] == [j for _, j in want]
        assert [j for _, j in got.latest(2)] == [j for _, j in want.latest(2)]


def test_export_raw_gray_read_back_by_native_ring(mp4, tmp_path):
    if not native_lib.available():
        pytest.skip("the native library does not build here")
    got_path, want_path = str(tmp_path / "port.raw"), str(tmp_path / "jax.raw")
    n, h, w = ttools.export_raw_gray(mp4, got_path, max_frames=4)
    assert (n, h, w) == jtools.export_raw_gray(mp4, want_path, max_frames=4) == (4, 96, 160)
    with open(got_path, "rb") as f, open(want_path, "rb") as g:
        assert f.read() == g.read()
    frames = ttools.grab_frames(mp4, range(4), gray=False)
    with native_lib.RawFrameRing(got_path, (h, w), 2) as ring:
        for t in range(4):
            assert np.array_equal(ring.next(), tprefetch.to_gray(frames[t]))
        assert ring.next() is None


@pytest.mark.parametrize("resize_hw", [None, (48, 80)])
def test_batch_frames_matches_jax(mp4, resize_hw):
    got = tprefetch.batch_frames(mp4, 1, 4, resize_hw, device="cpu")
    want = np.asarray(jprefetch.batch_frames(mp4, 1, 4, resize_hw))
    assert got.dtype == torch.uint8 and got.shape == want.shape == (4,) + (resize_hw or (96, 160))
    assert np.array_equal(got.numpy(), want)
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tprefetch.batch_frames(mp4, 0, 2)


def test_plotter_render_matches_jax():
    got, want = Plotter(160, 120), JPlotter(160, 120)
    vals = np.sin(np.arange(40) / 5.0) * 3.0
    for v in vals:
        got.plot(v, "a")
        want.plot(v, "a")
    assert np.array_equal(got.render("a"), want.render("a"))
    assert np.array_equal(got.render("empty"), want.render("empty"))
    from hackathonopticalflow_tpu.viz.plotter import draw_plot as j_draw_plot

    assert np.array_equal(draw_plot(list(vals[:20])), j_draw_plot(list(vals[:20])))


def test_timer_and_fps_counter():
    timer = Timer()
    for _ in range(3):
        with timer():
            time.sleep(0.01)
    assert timer.count == 3 and 0.009 <= timer.mean < 0.5
    fps = FpsCounter(window=4)
    assert fps.tick() == 0.0
    rates = []
    for _ in range(6):
        time.sleep(0.01)
        rates.append(fps.tick())
    assert len(fps.times) == 4 and all(0 < r <= 110 for r in rates)


def test_entry_matches_jax_components():
    """entry(device="cpu") at 144x256: its example arguments run; on a
    drifting smooth pair its grid flow, danger values and FOE agree with
    JAX's lk_grid_flow, danger_values and estimate_foe, and its dense flow
    with JAX's farneback (the bar of tests/test_torch_farneback.py)."""
    h, w = 144, 256
    step, (prev, cur) = entry(device="cpu", h=h, w=w)
    assert prev.shape == cur.shape == (h, w) and prev.device.type == "cpu"
    out = step(prev, cur)
    assert out["dense_flow"].shape == (h, w, 2)
    assert all(bool(torch.isfinite(v.float()).all()) for v in out.values())

    sm = smooth_texture(12, h + 40, w + 40)
    a = np.clip(np.floor(sm[20 : 20 + h, 20 : 20 + w] + 0.5), 0, 255).astype(np.float32)
    b = np.clip(np.floor(sm[21 : 21 + h, 22 : 22 + w] + 0.5), 0, 255).astype(np.float32)
    got = step(torch.from_numpy(a), torch.from_numpy(b))
    pts = jnp.asarray(measurement_grid(h, w, 30))

    @jax.jit
    def jstep(x, y):
        res = jgrid.lk_grid_flow(x, y, pts)
        foe, resid = j_estimate_foe(res.pts.astype(jnp.float32), res.flow.astype(jnp.float32), res.good)
        return res, j_danger_values(res.modulus), foe, resid, jfb.farneback(x, y, JFarnebackParams())

    res, danger, foe, resid, dense = jstep(jnp.asarray(a), jnp.asarray(b))
    assert np.mean(got["good"].numpy() == np.asarray(res.good)) >= 0.95
    assert np.mean(np.all(got["flow"].numpy() == np.asarray(res.flow), -1)) >= 0.95
    np.testing.assert_allclose(got["danger"].numpy(), np.asarray(danger), rtol=1e-3)
    if np.array_equal(got["good"].numpy(), np.asarray(res.good)):
        np.testing.assert_allclose(got["foe"].numpy(), np.asarray(foe), rtol=1e-3, atol=1e-2)
    epe = np.linalg.norm(got["dense_flow"].numpy() - np.asarray(dense), axis=-1)
    assert epe.mean() <= 1e-3 and epe.max() <= 0.05, (epe.mean(), epe.max())
