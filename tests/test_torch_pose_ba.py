"""The port's camera, FOE, metrics, relative pose and bundle adjustment
against the JAX package's, on seeded synthetic scenes (copies of the
scene functions of tests/test_pose_ba.py):

- rodrigues / so3_log within 1e-6; Pinhole, estimate_foe, endpoint_error,
  ate_umeyama within 1e-5 relative;
- estimate_relative_pose on the exact and the noisy-with-outliers two-view
  scenes, with JAX's RANSAC draws (nav/pose.py::_gumbel replaced by
  jax.random.gumbel of the same key): identical inlier masks and counts, R
  and t within 1e-4;
- bundle_adjust on a 4-keyframe, 48-landmark window, with and without the
  Huber loss: poses and points within 1e-4 relative, costs within 1e-4
  relative;
- the batched forms (a leading window dimension) equal to one window at a
  time.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hackathonopticalflow_tpu.nav import ba as jba
from hackathonopticalflow_tpu.nav import camera as jcam
from hackathonopticalflow_tpu.nav import foe as jfoe
from hackathonopticalflow_tpu.nav import metrics as jmetrics
from hackathonopticalflow_tpu.nav import pose as jpose
from hackathonopticalflow_tpu_torch import convert
from hackathonopticalflow_tpu_torch.nav import ba as tba
from hackathonopticalflow_tpu_torch.nav import camera as tcam
from hackathonopticalflow_tpu_torch.nav import foe as tfoe
from hackathonopticalflow_tpu_torch.nav import metrics as tmetrics
from hackathonopticalflow_tpu_torch.nav import pose as tpose

torch.set_num_threads(1)


def jax_gumbel(seed, shape, device):
    """JAX's draw for PRNGKey(seed): the noise jax.random.categorical adds."""
    return torch.from_numpy(np.array(jax.random.gumbel(jax.random.PRNGKey(seed), shape))).to(device)


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(tpose, "_gumbel", jax_gumbel)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-12))


def _rot(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.asarray(jba.rodrigues(jnp.asarray(axis * angle, jnp.float32)))


def _synthetic_two_view(n=100, noise=0.0, seed=0):
    rng = np.random.RandomState(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 12, n)], -1)
    R = _rot([0.1, 0.9, 0.2], 0.08)
    t = np.array([0.3, -0.1, 0.5])
    t = t / np.linalg.norm(t)
    p0 = X[:, :2] / X[:, 2:3]
    X1 = X @ R.T + t
    p1 = X1[:, :2] / X1[:, 2:3]
    p0 = p0 + rng.normal(0, noise, p0.shape)
    p1 = p1 + rng.normal(0, noise, p1.shape)
    return p0.astype(np.float32), p1.astype(np.float32), R, t, X


def _noisy_with_outliers():
    p0, p1, *_ = _synthetic_two_view(n=200, noise=5e-4, seed=1)
    rng = np.random.RandomState(2)
    bad = rng.choice(200, 40, replace=False)
    p1 = p1.copy()
    p1[bad] += rng.uniform(-0.5, 0.5, (40, 2)).astype(np.float32)
    return p0, p1


def _synthetic_ba(m=4, l=48, noise=2e-3, pose_err=0.03, pt_err=0.15, seed=0, step_scale=1.0):
    """Ground-truth window + perturbed initialization, as numpy
    (rvecs, tvecs, points, obs, mask)."""
    rng = np.random.RandomState(seed)
    X = np.stack([rng.uniform(-2, 2, l), rng.uniform(-1.5, 1.5, l), rng.uniform(4, 12, l)], -1)
    rvecs, tvecs, obs = [], [], []
    for k in range(m):
        w = np.array([0.02, 0.15, 0.01]) * k * step_scale
        t = np.array([0.25, -0.05, 0.4]) * k * step_scale
        R = np.asarray(jba.rodrigues(jnp.asarray(w.astype(np.float32))))
        Xc = X @ R.T + t
        obs.append(Xc[:, :2] / Xc[:, 2:3] + rng.normal(0, noise, (l, 2)))
        rvecs.append(w)
        tvecs.append(t)
    rv = np.array(rvecs)
    tv = np.array(tvecs)
    rv[1:] += rng.normal(0, pose_err, rv[1:].shape)
    tv[1:] += rng.normal(0, pose_err, tv[1:].shape)
    X_init = X + rng.normal(0, pt_err, X.shape)
    return (rv.astype(np.float32), tv.astype(np.float32), X_init.astype(np.float32),
            np.stack(obs).astype(np.float32), np.ones((m, l), bool))


def test_rodrigues_so3_log():
    w = np.random.RandomState(0).uniform(-1.5, 1.5, (32, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = 1e-10
    want_R = np.array(jax.vmap(jba.rodrigues)(jnp.asarray(w)))
    got_R = tba.rodrigues(torch.from_numpy(w)).numpy()
    assert np.abs(got_R - want_R).max() <= 1e-6
    want_w = np.asarray(jax.vmap(jba.so3_log)(jnp.asarray(want_R)))
    got_w = tba.so3_log(torch.from_numpy(want_R)).numpy()
    assert np.abs(got_w - want_w).max() <= 1e-6


def test_pinhole():
    jc = jcam.Pinhole.from_fov(1920, 1080, 155.0)
    tc = tcam.Pinhole.from_fov(1920, 1080, 155.0)
    assert tc == tcam.Pinhole(jc.fx, jc.fy, jc.cx, jc.cy)
    assert tc.sq_norm_thresh(2.0) == jc.sq_norm_thresh(2.0)
    pts = np.random.RandomState(1).uniform(0, 1900, (4, 64, 2)).astype(np.float32)
    want = np.asarray(jc.normalize(jnp.asarray(pts)))
    for arg in (pts, torch.from_numpy(pts)):  # an ndarray or a tensor
        got = tc.normalize(arg)
        assert got.dtype == torch.float32 and _rel(want, got.numpy()) <= 1e-5
    xyz = np.random.RandomState(2).uniform([-3, -2, 2], [3, 2, 9], (50, 3)).astype(np.float32)
    assert _rel(jc.project(jnp.asarray(xyz)), tc.project(torch.from_numpy(xyz)).numpy()) <= 1e-5


@pytest.mark.parametrize("weighted", [False, True])
def test_estimate_foe(weighted):
    rng = np.random.RandomState(3)
    pts = rng.uniform(0, 640, (300, 2)).astype(np.float32)
    flow = ((pts - np.array([350.0, 170.0])) * 0.02 + rng.normal(0, 0.3, pts.shape)).astype(np.float32)
    flow[:5] = 0.0  # no direction: weight 0
    wts = (rng.uniform(size=300) > 0.3).astype(np.float32) if weighted else None
    je, jr = jax.jit(jfoe.estimate_foe)(jnp.asarray(pts), jnp.asarray(flow), None if wts is None else jnp.asarray(wts))
    te, tr = tfoe.estimate_foe(torch.from_numpy(pts), torch.from_numpy(flow),
                               None if wts is None else torch.from_numpy(wts))
    assert _rel(je, te.numpy()) <= 1e-5 and _rel(jr, tr.numpy()) <= 1e-5


@pytest.mark.parametrize("n", [1000, 999])
def test_endpoint_error(n):
    rng = np.random.RandomState(n)
    a = rng.normal(0, 2, (n, 2)).astype(np.float32)
    b = rng.normal(0, 2, (n, 2)).astype(np.float32)
    want = jmetrics.endpoint_error(jnp.asarray(a), jnp.asarray(b))
    got = tmetrics.endpoint_error(torch.from_numpy(a), torch.from_numpy(b))
    for k in ("mean", "p50", "p95", "max"):
        assert _rel(want[k], got[k].numpy()) <= 1e-5, k


@pytest.mark.parametrize("with_scale", [True, False])
def test_ate_and_track_epe(with_scale):
    rng = np.random.RandomState(4)
    ref = np.cumsum(rng.normal([0, 0, 0.4], 0.05, (30, 3)), 0)
    traj = 0.7 * ref @ _rot([0.2, 1.0, 0.1], 0.3).T + 0.2 + rng.normal(0, 0.01, ref.shape)
    want = jmetrics.ate_umeyama(traj, ref, with_scale)
    got = tmetrics.ate_umeyama(traj, ref, with_scale)
    assert all(abs(got[k] - want[k]) <= 1e-5 * max(abs(want[k]), 1e-12) for k in want)
    ta, tb = rng.uniform(0, 99, (2, 12, 5, 2))
    la, lb = rng.randint(0, 6, (2, 12))
    assert tmetrics.track_endpoint_error(ta, la, tb, lb) == jmetrics.track_endpoint_error(ta, la, tb, lb)


@pytest.mark.parametrize("scene", ["exact", "noisy_outliers"])
def test_relative_pose_matches_jax(scene, jax_draws):
    if scene == "exact":
        p0, p1, R, t, _ = _synthetic_two_view()
        kw = {}
    else:
        p0, p1 = _noisy_with_outliers()
        R = t = None
        kw = dict(inlier_thresh=5e-5, ransac_rounds=32)
    want = jax.jit(functools.partial(jpose.estimate_relative_pose, **kw))(jnp.asarray(p0), jnp.asarray(p1))
    got = tpose.estimate_relative_pose(torch.from_numpy(p0), torch.from_numpy(p1), **kw)
    assert np.array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.n_inliers) == int(want.n_inliers) > 90
    assert np.abs(got.R.numpy() - np.asarray(want.R)).max() <= 1e-4
    assert np.abs(got.t.numpy() - np.asarray(want.t)).max() <= 1e-4
    if R is not None:  # and both recover the truth
        assert np.abs(got.R.numpy() - R).max() < 1e-3 and float(got.t.numpy() @ t) > 0.999


def test_relative_pose_batched(jax_draws):
    """A (2, 3) batch of pairs, with a validity mask, equals the pairs one
    at a time (one RANSAC draw serves the batch, as one key serves JAX's
    vmapped pairs)."""
    p0, p1 = _noisy_with_outliers()
    rng = np.random.RandomState(5)
    valid = rng.uniform(size=(2, 3, 200)) > 0.2
    b0 = np.broadcast_to(p0, (2, 3, 200, 2)).copy()
    b1 = np.broadcast_to(p1, (2, 3, 200, 2)).copy()
    b1 += rng.normal(0, 1e-4, b1.shape).astype(np.float32)
    got = tpose.estimate_relative_pose(torch.from_numpy(b0), torch.from_numpy(b1), torch.from_numpy(valid),
                                       inlier_thresh=5e-5)
    assert got.R.shape == (2, 3, 3, 3) and got.inliers.shape == (2, 3, 200)
    for i in range(2):
        for j in range(3):
            one = tpose.estimate_relative_pose(torch.from_numpy(b0[i, j]), torch.from_numpy(b1[i, j]),
                                               torch.from_numpy(valid[i, j]), inlier_thresh=5e-5)
            assert torch.equal(got.inliers[i, j], one.inliers)
            assert (got.R[i, j] - one.R).abs().max() <= 1e-5 and (got.t[i, j] - one.t).abs().max() <= 1e-5


@pytest.mark.parametrize("huber_delta", [None, 2e-3])
def test_bundle_adjust_matches_jax(huber_delta):
    arrs = _synthetic_ba()
    jstate = jba.BAState(*map(jnp.asarray, arrs))
    want, wstats = jax.jit(lambda s: jba.bundle_adjust(s, iters=12, huber_delta=huber_delta))(jstate)
    got, gstats = tba.bundle_adjust(convert.ba_state(jstate), iters=12, huber_delta=huber_delta)
    for name in ("rvecs", "tvecs", "points"):
        assert _rel(getattr(want, name), getattr(got, name).numpy()) <= 1e-4, name
    for name in ("cost", "initial_cost"):
        assert _rel(getattr(wstats, name), getattr(gstats, name).numpy()) <= 1e-4, name
    assert int(gstats.n_obs) == int(wstats.n_obs) == 4 * 48
    assert float(gstats.cost) < 0.05 * float(gstats.initial_cost)


def test_bundle_adjust_batched():
    """Two windows solved as one batch equal each solved alone; the Schur
    step's pieces have the batch's leading dimension."""
    a = _synthetic_ba(seed=0)
    b = _synthetic_ba(seed=1, step_scale=0.5)
    b[4][1, :5] = False  # a few masked observations in the second window
    both = tba.BAState(*(torch.from_numpy(np.stack([x, y])) for x, y in zip(a, b)))
    got, stats = tba.bundle_adjust(both, iters=8, huber_delta=2e-3)
    assert stats.cost.shape == (2,)
    for i, arrs in enumerate((a, b)):
        one, one_stats = tba.bundle_adjust(tba.BAState(*map(torch.from_numpy, arrs)), iters=8, huber_delta=2e-3)
        for name in ("rvecs", "tvecs", "points"):
            assert _rel(getattr(one, name).numpy(), getattr(got, name)[i].numpy()) <= 1e-5, name
        assert _rel(one_stats.cost.numpy(), stats.cost[i].numpy()) <= 1e-5
