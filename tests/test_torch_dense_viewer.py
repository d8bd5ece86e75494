"""The port's dense viewer against the JAX package's, on one small
cv2-written mp4 of tests/test_torch_farneback.py's 144x256 zoom-and-drift
clip (both apps decode the same file), the port on the CPU:

- each pair's dense flow within _epe_ok of the JAX app's, and equal to the
  port's farneback_flow; its sparse `good` set within 2% of the grid's
  points of the JAX app's (the exact path agrees to 1e-3 px, which can
  flip borderline points), and equal to the port's lk_grid_flow;
- render_mode's 9 views against JAX's (cv2's conversions);
- contour_layer identical, threshold_binary identical;
- headless rendering without cv2, and the errors where cv2 or CUDA is
  missing.
"""

from unittest import mock

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax.numpy as jnp  # noqa: E402

from chip_smoke import ClipReader  # noqa: E402
from hackathonopticalflow_tpu.apps import dense_viewer as jdv  # noqa: E402
from hackathonopticalflow_tpu.ops.image import threshold_binary as j_threshold_binary  # noqa: E402
from hackathonopticalflow_tpu_torch.apps import dense_viewer as tdv  # noqa: E402
from hackathonopticalflow_tpu_torch.apps import pathfinder as tpf  # noqa: E402
from hackathonopticalflow_tpu_torch.core import LKParams, measurement_grid  # noqa: E402
from hackathonopticalflow_tpu_torch.flow.dense import farneback_flow  # noqa: E402
from hackathonopticalflow_tpu_torch.flow.lk_grid import lk_grid_flow  # noqa: E402
from hackathonopticalflow_tpu_torch.ops.image import threshold_binary  # noqa: E402
from hackathonopticalflow_tpu_torch.viz import draw as tdraw  # noqa: E402
from test_torch_farneback import H, W, _clip, _epe_ok  # noqa: E402

torch.set_num_threads(1)

PAIRS = 3
LAYERS = dict(add_flow=True, add_hsv=True, show_contours=True)


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip.mp4")
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (W, H))
    assert vw.isOpened()
    for f in _clip(PAIRS + 1):
        vw.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
    vw.release()
    return path


@pytest.fixture(scope="module")
def jax_run(clip):
    """The JAX app's run with the dense, HSV and contour layers on; each
    pair's dense flow and sparse result, recorded around its own jitted
    functions."""
    app = jdv.DenseViewerApp(jdv.DenseViewerConfig(video=clip, max_frames=PAIRS, **LAYERS))
    flows, sparse = [], []
    dense_fn, sparse_fn = app._dense_fn, app._sparse_fn

    def dense(*a):
        flows.append(np.asarray(dense_fn(*a)))
        return flows[-1]

    def sparse_rec(*a):
        sparse.append(sparse_fn(*a))
        return sparse[-1]

    app._dense_fn, app._sparse_fn = dense, sparse_rec
    stats = app.run(headless=True)
    assert stats["frames"] == PAIRS
    return flows, sparse


def _cfg(clip, **kw):
    return tdv.DenseViewerConfig(video=clip, device="cpu", **{**LAYERS, **kw})


@pytest.fixture(scope="module")
def port_run(clip):
    pairs = []
    stats = tdv.DenseViewerApp(_cfg(clip, max_frames=PAIRS)).run(
        headless=True, on_pair=lambda *a: pairs.append(a))
    assert stats["frames"] == len(pairs) == PAIRS
    return pairs


def _grays(clip):
    reader = tpf.VideoReader(clip)
    return [cv2.cvtColor(f, cv2.COLOR_BGR2GRAY) for f in reader.frames(count=PAIRS + 1)]


def test_dense_flow_matches_jax_and_farneback_flow(clip, jax_run, port_run):
    grays = _grays(clip)
    for t, (flow, _, _, _) in enumerate(port_run):
        assert flow.shape == (H, W, 2)
        _epe_ok(flow.numpy(), jax_run[0][t])
        want = farneback_flow(torch.from_numpy(grays[t]), torch.from_numpy(grays[t + 1]), device="cpu")
        assert torch.equal(flow, want)


def test_sparse_good_matches_jax_and_lk_grid_flow(clip, jax_run, port_run):
    grays = _grays(clip)
    pts = torch.from_numpy(measurement_grid(H, W, 30))
    n_pts = pts.shape[0]
    for t, (_, sres, _, _) in enumerate(port_run):
        jgood = np.asarray(jax_run[1][t].good)
        assert (sres.good.numpy() != jgood).sum() <= 0.02 * n_pts
        want = lk_grid_flow(torch.from_numpy(grays[t]), torch.from_numpy(grays[t + 1]), pts, LKParams(),
                            filt=tdv.PROTO_FILTER, device="cpu")
        for name in ("good", "next_pts", "flow"):
            assert torch.equal(getattr(sres, name), getattr(want, name))
    assert any(int(s.good.sum()) > 0 for _, s, _, _ in port_run)


def test_frames_and_contours_rendered(port_run):
    for _, _, out, contours in port_run:
        assert out.shape == (H, W, 3) and out.dtype == np.uint8
        assert contours.shape == (H, W, 3) and (contours > 0).any()


@pytest.mark.parametrize("mode", range(9))
def test_render_mode_matches_jax(mode):
    """Exact but for the HSV views: ops/color.bgr2hsv is the JAX package's
    float formula (bit for bit with its ops/color.py), while JAX's viewer
    calls cv2's integer-table conversion; the two differ by one level of
    rounding, and a hue that rounds up to 180 is cv2's 0 (hue is cyclic)."""
    rng = np.random.RandomState(mode)
    img = rng.randint(0, 256, (40, 56, 3)).astype(np.uint8)
    img[:4] = np.array([[0, 0, 0], [255, 255, 255], [0, 0, 255], [7, 7, 7]], np.uint8)[:, None]
    got, name = tdv.render_mode(img, mode)
    want, jname = jdv.render_mode(img, mode)
    assert name == jname and got.shape == want.shape and got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    if mode in (5, 6, 7):
        hue = {5: [0], 6: [0, 1, 2], 7: []}[mode]
        d[..., hue] = np.minimum(d[..., hue], 180 - d[..., hue])
        assert d.max() <= 1
    else:
        assert d.max() == 0


def test_contour_layer_identical(clip):
    gray = _grays(clip)[1]
    got = tdv.contour_layer(gray)
    assert np.array_equal(got, jdv.contour_layer(gray))
    assert (got == 255).all(-1).any()  # long contours drawn
    for div, length in ((40, 60), (90, 300)):
        assert np.array_equal(tdv.contour_layer(gray, div, length), jdv.contour_layer(gray, div, length))


def test_threshold_binary_matches_jax():
    img = np.random.RandomState(3).uniform(0, 255, (30, 41)).astype(np.float32)
    img[0, :4] = [63.0, 126.0, 0.0, 255.0]
    for thresh, maxval in ((63.0, 255.0), (126.0, 1.0), (0.0, 255.0), (255.0, 9.0)):
        got = threshold_binary(torch.from_numpy(img), thresh, maxval).numpy()
        want = np.asarray(j_threshold_binary(jnp.asarray(img), thresh, maxval))
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_headless_without_cv2(clip):
    """A clip from memory, every layer on, rendered by the numpy rasterizer
    and ops/color; writing an mp4 and the interactive windows need cv2."""
    frames = np.stack(_grays(clip))
    mk = lambda: tdv.DenseViewerApp(_cfg("memory", max_frames=2), open_reader=lambda path: ClipReader(frames))
    outs = []
    with mock.patch.object(tpf, "HAVE_CV2", False), mock.patch.object(tdraw, "HAVE_CV2", False):
        stats = mk().run(headless=True, on_pair=lambda *a: outs.append(a))
        assert stats["frames"] == 2
        for flow, sres, out, contours in outs:
            assert out.shape == (H, W, 3) and out.dtype == np.uint8
            assert (contours > 0).any() and torch.isfinite(flow).all()
        with pytest.raises(RuntimeError, match="cv2"):
            mk().run(headless=True, out_path="out.mp4")
        with pytest.raises(RuntimeError, match="cv2"):
            mk().run(headless=False)


def test_renders_mp4(clip, tmp_path):
    out = str(tmp_path / "out.mp4")
    stats = tdv.DenseViewerApp(_cfg(clip, max_frames=2, show_contours=False)).run(out_path=out)
    assert stats["frames"] == 2
    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    assert n == 2


def test_cuda_device_without_cuda_raises(clip):
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="CUDA"):
            tdv.DenseViewerApp(tdv.DenseViewerConfig(video=clip))
