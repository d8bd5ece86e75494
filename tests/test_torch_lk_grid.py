"""PyTorch port vs the JAX package: post-LK stages and the clip scan.

The JAX side (lk_grid_flow_video on 3 frames, Pallas in interpret mode)
runs once per module."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hackathonopticalflow_tpu.core import FilterParams, LKParams, NormalizeParams, measurement_grid
from hackathonopticalflow_tpu.flow import lk_grid as jgrid
from hackathonopticalflow_tpu.nav.filter import robust_mask as j_robust_mask
from hackathonopticalflow_tpu.ops.lk import LKResult as JLKResult
from hackathonopticalflow_tpu_torch import convert
from hackathonopticalflow_tpu_torch import core as tcore
from hackathonopticalflow_tpu_torch.flow import lk_grid as tgrid
from hackathonopticalflow_tpu_torch.nav.filter import robust_mask
from hackathonopticalflow_tpu_torch.ops.stats import median, percentile
from test_torch_prepare import smooth_texture

torch.set_num_threads(1)

PARAMS = LKParams(grid_step=30, use_pallas=True, compute_err=False)
TPARAMS = tcore.LKParams(grid_step=30, compute_err=False)
H, W = 270, 480


def _clip():
    """3 u8 frames drifting by (+2, +1) px per frame over a texture."""
    sm = smooth_texture(8, H + 40, W + 40)
    sm = np.clip(np.floor(sm + 0.5), 0, 255).astype(np.uint8)
    return np.stack([sm[10 + t : 10 + t + H, 10 + 2 * t : 10 + 2 * t + W] for t in range(3)])


@pytest.fixture(scope="module")
def jax_video():
    frames = _clip()
    pts = measurement_grid(H, W, PARAMS.grid_step)
    res = jgrid.lk_grid_flow_video(jnp.asarray(frames), jnp.asarray(pts), lk=PARAMS)
    return frames, pts, {k: np.asarray(v) for k, v in res._asdict().items()}


def _int_field_agrees(got, ref, unrounded):
    """Equal, except where the unrounded value lies within 1e-4 of a
    half-integer (float32 ULPs of atan2/cos/sin decide the rounding)."""
    near_half = np.abs(np.abs(unrounded - np.floor(unrounded)) - 0.5) < 1e-4
    return np.all((got == ref) | near_half)


def test_post_lk_matches_jax(jax_video):
    frames, pts, ref = jax_video
    raw = ref["raw_next_pts"][0]
    status = ref["status"][0]
    norm, filt = NormalizeParams(), FilterParams()
    jres = JLKResult(next_pts=jnp.asarray(raw), status=jnp.asarray(status),
                     err=jnp.zeros(len(pts), jnp.float32))
    want = jgrid._post_lk(jres, jnp.asarray(pts), H, W, norm, filt)
    got = tgrid._post_lk(
        convert.lk_result(jres), torch.from_numpy(pts), H, W,
        tcore.NormalizeParams(), tcore.FilterParams(),
    )
    want = {k: np.asarray(v) for k, v in want._asdict().items()}
    got = {k: v.numpy() for k, v in got._asdict().items()}
    assert np.array_equal(got["raw_next_pts"], want["raw_next_pts"])
    assert np.array_equal(got["status"], want["status"])
    assert np.array_equal(got["good"], want["good"])
    assert np.array_equal(got["pts"], want["pts"])
    np.testing.assert_allclose(got["modulus"], want["modulus"], rtol=1e-5)
    np.testing.assert_allclose(got["ang"], want["ang"], rtol=1e-5, atol=1e-6)
    # endpoints before rounding, from the port's own modulus/angle
    m, a = got["modulus"], got["ang"]
    end = pts + np.stack([m * np.cos(a), m * np.sin(a)], -1) + 0.5
    assert _int_field_agrees(got["next_pts"], want["next_pts"], end)
    assert _int_field_agrees(got["flow"], want["flow"], end)


def test_video_matches_jax(jax_video):
    frames, pts, ref = jax_video
    got = tgrid.lk_grid_flow_video(torch.from_numpy(frames), torch.from_numpy(pts), lk=TPARAMS, device="cpu")
    assert got.raw_next_pts.shape == (2, len(pts), 2)
    assert np.array_equal(got.status.numpy(), ref["status"])
    assert np.abs(got.raw_next_pts.numpy() - ref["raw_next_pts"]).max() < 0.05
    assert np.mean(got.good.numpy() == ref["good"]) >= 0.98
    # sanity: the drift is tracked (frame t shows frame t-1 moved by
    # (-2, -1), so the backward flow is (+2, +1))
    assert np.abs(np.median(ref["raw_next_pts"] - pts, axis=(0, 1)) - [2, 1]).max() < 0.1


def test_lk_grid_flow_equals_video_step():
    frames = _clip()
    pts = torch.from_numpy(measurement_grid(H, W, PARAMS.grid_step))
    video = tgrid.lk_grid_flow_video(torch.from_numpy(frames[:2]), pts, lk=TPARAMS, device="cpu")
    pair = tgrid.lk_grid_flow(
        torch.from_numpy(frames[0]), torch.from_numpy(frames[1]), pts, lk=TPARAMS, device="cpu"
    )
    for name, v in pair._asdict().items():
        assert torch.equal(v, getattr(video, name)[0]), name


def test_pack_unpack_roundtrip():
    frames = _clip()
    pts = torch.from_numpy(measurement_grid(H, W, PARAMS.grid_step))
    res = tgrid.lk_grid_flow_video(torch.from_numpy(frames), pts, lk=TPARAMS, device="cpu")
    packed = tgrid.pack_grid_result(res)
    assert packed.shape == (2, 10 * len(pts))
    back = tgrid.unpack_grid_result(packed.numpy(), res.pts[0].numpy())
    for name, v in res._asdict().items():
        assert np.array_equal(getattr(back, name), v.numpy()), name


@pytest.mark.parametrize("n", [7, 144, 2304])
def test_median_percentile_match_numpy(n):
    x = np.random.RandomState(n).gamma(2.0, 3.0, n).astype(np.float32)
    t = torch.from_numpy(x)
    assert float(median(t)) == np.float32(np.median(x))
    assert float(median(t)) == float(jnp.median(jnp.asarray(x)))
    for q in (99.0, 50.0, 10.0):
        got = float(percentile(t, q))
        np.testing.assert_allclose(got, np.percentile(x.astype(np.float64), q), rtol=1e-7)
        np.testing.assert_allclose(got, float(jnp.percentile(jnp.asarray(x), q)), rtol=1e-6)


@pytest.mark.parametrize("filt", [{}, dict(median_factor=1.2, upper_percentile=None)])
def test_robust_mask_matches_jax(filt):
    x = np.random.RandomState(1).gamma(2.0, 3.0, 2304).astype(np.float32)
    got = robust_mask(torch.from_numpy(x), tcore.FilterParams(**filt)).numpy()
    assert np.array_equal(got, np.asarray(j_robust_mask(jnp.asarray(x), FilterParams(**filt))))
