"""PyTorch port vs the JAX package: Sobel derivatives and Shi-Tomasi corner
detection (ops/deriv.py, ops/features.py).

Sobel's integer taps make the derivatives of u8 images exact in float32,
so they are held identical. The min-eigenvalue map is held to rtol 1e-5
(the same float32 ops; the bar leaves room for XLA's CPU fusion). Corners
are held IDENTICAL (pts, valid, count): the detector's candidate order
(value descending, then index ascending) and its greedy pass are exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hackathonopticalflow_tpu.core.config import FeatureParams
from hackathonopticalflow_tpu.ops import deriv as jderiv
from hackathonopticalflow_tpu.ops import features as jfeat
from hackathonopticalflow_tpu_torch import convert
from hackathonopticalflow_tpu_torch.ops import deriv as tderiv
from hackathonopticalflow_tpu_torch.ops import features as tfeat
from test_torch_prepare import smooth_texture

torch.set_num_threads(1)

H, W = 144, 256
PARAMS = FeatureParams(max_candidates=256)


def _texture(seed=2):
    # smooth_texture's x passes trim 8 columns
    return np.clip(np.floor(smooth_texture(seed, H, W + 8) + 0.5), 0, 255).astype(np.uint8)


def _plateau():
    """A tiled 16x16 patch: every tile repeats the same eigenvalues, so
    equal-valued candidates tie and their index order decides."""
    tile = np.clip(np.floor(smooth_texture(4, 16, 24) * 1.5 - 60 + 0.5), 0, 255)
    return np.tile(tile, (H // 16, W // 16)).astype(np.uint8)


def _few():
    """A flat frame with three bright squares: fewer than max_corners."""
    img = np.full((H, W), 40, np.uint8)
    for y, x in ((30, 40), (80, 150), (100, 60)):
        img[y : y + 12, x : x + 12] = 220
    return img


def _mask():
    """255 with a zeroed band and zeroed discs, as the tracker's mask."""
    m = np.full((H, W), 255, np.uint8)
    m[:, 100:140] = 0
    yy, xx = np.mgrid[0:H, 0:W]
    for cy, cx in ((40, 50), (90, 200)):
        m[(yy - cy) ** 2 + (xx - cx) ** 2 <= 25] = 0
    return m


CASES = {
    "texture": (_texture, None),
    "plateau": (_plateau, None),
    "mask": (_texture, _mask),
    "few": (_few, None),
}


def test_sobel_deriv_matches_jax():
    img = _texture().astype(np.float32)
    want = jderiv.sobel_deriv(jnp.asarray(img))
    got = tderiv.sobel_deriv(torch.from_numpy(img))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("name", ["texture", "plateau"])
def test_min_eig_map_matches_jax(name):
    img = CASES[name][0]().astype(np.float32)
    want = np.asarray(jfeat.min_eig_map(jnp.asarray(img)))
    got = tfeat.min_eig_map(torch.from_numpy(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_good_features_matches_jax(name):
    make_img, make_mask = CASES[name]
    img = make_img().astype(np.float32)
    mask = None if make_mask is None else make_mask()
    want = jfeat.good_features_to_track(
        jnp.asarray(img), PARAMS, mask=None if mask is None else jnp.asarray(mask)
    )
    got = tfeat.good_features_to_track(
        torch.from_numpy(img), convert.feature_params(PARAMS),
        mask=None if mask is None else torch.from_numpy(mask),
    )
    assert np.array_equal(got.pts.numpy(), np.asarray(want.pts))
    assert np.array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.count.dtype == torch.int32 and int(got.count) == int(want.count)
    count = int(got.count)
    if name == "few":
        assert 0 < count < PARAMS.max_corners
    else:
        assert count == PARAMS.max_corners
    if mask is not None:
        pts = got.pts.numpy()[: count].astype(int)
        assert (mask[pts[:, 1], pts[:, 0]] != 0).all()


def test_plateau_has_ties():
    """The plateau case does exercise ties among the taken corners."""
    img = _plateau().astype(np.float32)
    eig = tfeat.min_eig_map(torch.from_numpy(img)).numpy()
    got = tfeat.good_features_to_track(torch.from_numpy(img), convert.feature_params(PARAMS))
    pts = got.pts.numpy()[: int(got.count)].astype(int)
    vals = eig[pts[:, 1], pts[:, 0]]
    assert len(np.unique(vals)) < len(vals)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_equals_sequential_pass(seed):
    """The detector's max_corners-round selection equals the literal
    one-candidate-at-a-time greedy pass (JAX ops/features.py:89-103)."""
    rng = np.random.RandomState(seed)
    k, max_c, min_d2 = 200, 12, 100.0
    cxy = np.floor(rng.uniform(0, 60, (k, 2))).astype(np.float32)
    ok = rng.uniform(size=k) < 0.8
    sel = np.zeros((max_c, 2), np.float32)
    valid = np.zeros(max_c, bool)
    count = 0
    for i in range(k):
        far = all(((sel[j] - cxy[i]) ** 2).sum() >= min_d2 for j in range(max_c) if valid[j])
        if ok[i] and far and count < max_c:
            sel[count], valid[count] = cxy[i], True
            count += 1
    got_sel, got_valid = tfeat._select(torch.from_numpy(cxy), torch.from_numpy(ok), max_c, min_d2)
    assert np.array_equal(got_sel.numpy(), sel)
    assert np.array_equal(got_valid.numpy(), valid)
