"""The port's color conversions and drawing layers against the JAX
package's: uint8 results bit for bit, with cv2 and with the numpy
rasterizer that stands in for it (HAVE_CV2 patched to False in both
packages)."""

from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hackathonopticalflow_tpu.ops import color as jcolor
from hackathonopticalflow_tpu.viz import draw as jdraw
from hackathonopticalflow_tpu.viz import layers as jlayers
from hackathonopticalflow_tpu_torch.ops import color as tcolor
from hackathonopticalflow_tpu_torch.viz import draw as tdraw
from hackathonopticalflow_tpu_torch.viz import layers as tlayers

torch.set_num_threads(1)


def _bgr(seed, h=48, w=64):
    """Random u8 BGR with gray, black, white and single-channel pixels in
    the first rows (every hue branch and the zero-saturation cases)."""
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
    img[0, :8] = [[0, 0, 0], [255, 255, 255], [7, 7, 7], [255, 0, 0], [0, 255, 0], [0, 0, 255], [9, 9, 200], [200, 9, 9]]
    return img


@pytest.mark.parametrize("seed", [0, 1])
def test_bgr2gray_u8_bit_exact(seed):
    img = _bgr(seed)
    got = tcolor.bgr2gray(torch.from_numpy(img)).numpy()
    assert got.dtype == np.uint8
    assert np.array_equal(got, np.asarray(jcolor.bgr2gray(jnp.asarray(img))))


def test_bgr2gray_float_matches_jax():
    img = _bgr(2).astype(np.float32) / 3.0
    got = tcolor.bgr2gray(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, np.asarray(jcolor.bgr2gray(jnp.asarray(img))), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_bgr2hsv_u8_bit_exact(seed):
    img = _bgr(seed)
    got = tcolor.bgr2hsv(torch.from_numpy(img)).numpy()
    assert np.array_equal(got, np.asarray(jcolor.bgr2hsv(jnp.asarray(img))))


@pytest.mark.parametrize("seed", [0, 1])
def test_hsv2bgr_u8_bit_exact(seed):
    """Every hue of [0, 180) with random saturations and values."""
    rng = np.random.RandomState(seed)
    hsv = rng.randint(0, 256, (48, 64, 3)).astype(np.uint8)
    hsv[..., 0] = rng.randint(0, 180, (48, 64))
    hsv[0, :180 // 4] = np.stack([np.arange(0, 180, 4), np.full(45, 255), np.full(45, 200)], -1)
    got = tcolor.hsv2bgr(torch.from_numpy(hsv)).numpy()
    assert np.array_equal(got, np.asarray(jcolor.hsv2bgr(jnp.asarray(hsv))))


def test_gray2bgr_and_saturating_add_bit_exact():
    a, b = _bgr(3), _bgr(4)
    assert np.array_equal(tcolor.gray2bgr(torch.from_numpy(a[..., 0])).numpy(),
                          np.asarray(jcolor.gray2bgr(jnp.asarray(a[..., 0]))))
    assert np.array_equal(tcolor.saturating_add(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                          np.asarray(jcolor.saturating_add(jnp.asarray(a), jnp.asarray(b))))


def _flow(seed, h=120, w=200, step=30):
    """Grid points, rounded endpoints and a good mask as the app hands
    them to the layers, some endpoints past the frame."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[15:h:step, 10:w:step]
    pts = np.stack([xs.ravel(), ys.ravel()], -1).astype(np.int32)
    nxt = (pts + rng.uniform(-25, 25, pts.shape)).astype(np.int32)
    good = rng.rand(pts.shape[0]) < 0.6
    return pts, nxt, good


@pytest.fixture(params=[True, False], ids=["cv2", "numpy"])
def have_cv2(request):
    with mock.patch.object(jdraw, "HAVE_CV2", request.param), mock.patch.object(tdraw, "HAVE_CV2", request.param):
        yield request.param


@pytest.mark.parametrize("draw_bad", [True, False])
def test_draw_grid_vectors_identical(have_cv2, draw_bad):
    pts, nxt, good = _flow(5)
    got = tlayers.draw_grid_vectors((120, 200), pts, nxt, good, draw_bad)
    assert np.array_equal(got, jlayers.draw_grid_vectors((120, 200), pts, nxt, good, draw_bad))


def test_draw_sparse_lamps_identical(have_cv2):
    pts, nxt, good = _flow(6)
    got = tlayers.draw_sparse_lamps((120, 200), (nxt - pts)[good], pts[good])
    assert got.any()
    assert np.array_equal(got, jlayers.draw_sparse_lamps((120, 200), (nxt - pts)[good], pts[good]))


def test_draw_grid_and_add_layers_identical(have_cv2):
    kw = dict(colored_cross=True, viewing_angle_rect=True, cross=True, grid=True, blinds=True)
    got = tlayers.draw_grid((270, 480), 20, **kw)
    assert np.array_equal(got, jlayers.draw_grid((270, 480), 20, **kw))
    pts, nxt, good = _flow(7, 270, 480)
    frame = _bgr(8, 270, 480)
    layers = [frame, got, tlayers.draw_grid_vectors((270, 480), pts, nxt, good)]
    assert np.array_equal(tdraw.add_layers(*layers), jdraw.add_layers(*layers))


def test_draw_hsv_identical():
    rng = np.random.RandomState(9)
    flow = rng.uniform(-40, 40, (40, 60, 2)).astype(np.float32)
    assert np.array_equal(tlayers.draw_hsv(flow), jlayers.draw_hsv(flow))
