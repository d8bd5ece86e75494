"""The port's odometry (nav/odometry.py) against the JAX package's, on
seeded synthetic scenes (tests/test_odometry.py's `_scene` and
`table_for`, copied; chip_smoke.py's `scene_table` for a 3D scene seen by
a fixed pool of track slots) and a small zoom clip, on the CPU:

- build_window, select_keyframes and stitch_pose_graph identical;
- triangulate within 1e-4 relative; init_window_poses (unit steps, and
  the scale votes) within 1e-4, its landmarks 1e-4 relative; window_ba
  with 40 masked observations within 1e-3 relative;
- ego_motion_track on a given table: identical keyframes, centres within
  1e-3 of the trajectory's span;
- collect_tracks on a 144x256 9-frame zoom clip: alive and births
  identical, heads within 0.05 px.

The RANSAC draws are JAX's (nav/pose.py::_gumbel replaced by
jax.random.gumbel of the same key). A sample that repeats a slot leaves
the 8-point system two null vectors, of which LAPACK builds may return
different ones; the scenes here are large enough that no such round wins.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import scene_table
from hackathonopticalflow_tpu.core import config as jconfig
from hackathonopticalflow_tpu.nav import ba as jba
from hackathonopticalflow_tpu.nav import camera as jcam
from hackathonopticalflow_tpu.nav import odometry as jodo
from hackathonopticalflow_tpu_torch import convert
from hackathonopticalflow_tpu_torch.nav import camera as tcam
from hackathonopticalflow_tpu_torch.nav import odometry as todo
from hackathonopticalflow_tpu_torch.nav import pose as tpose

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def jax_draws(monkeypatch):
    monkeypatch.setattr(
        tpose, "_gumbel",
        lambda seed, shape, device: torch.from_numpy(np.array(jax.random.gumbel(jax.random.PRNGKey(seed), shape))),
    )


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-12))


def _scene(rng, m=6, l=80, noise=5e-4):
    """Forward-moving camera over random landmarks; returns GT + obs."""
    steps = rng.normal([0, 0, 0.4], [0.05, 0.05, 0.05], (m - 1, 3))
    cs = np.concatenate([[np.zeros(3)], np.cumsum(steps, 0)])
    angs = np.cumsum(rng.normal(0, 0.02, (m, 3)), 0)
    angs[0] = 0
    rs = np.array(jax.jit(jax.vmap(jba.rodrigues))(jnp.asarray(angs, jnp.float32)))
    x = rng.uniform([-3, -2, 4], [3, 2, 12], (l, 3))
    obs = np.zeros((m, l, 2), np.float32)
    for k in range(m):
        pc = (rs[k] @ (x - cs[k]).T).T
        obs[k] = pc[:, :2] / pc[:, 2:3]
    obs += rng.normal(0, noise, obs.shape).astype(np.float32)
    mask = np.ones((m, l), bool)
    return cs, rs, x, obs, mask


def _table_for(rng, noise_px, parallax_px_per_frame, f=40, t=64):
    base = rng.uniform([40, 40], [280, 140], (t, 2)).astype(np.float32)
    pos = np.zeros((f, t, 2), np.float32)
    ctr = np.array([160.0, 90.0])
    d = base - ctr
    dn = d / (np.linalg.norm(d, axis=-1, keepdims=True) + 1e-6)
    for i in range(f):
        pos[i] = base + dn * parallax_px_per_frame * i + rng.normal(0, noise_px, (t, 2))
    return pos, np.ones((f, t), bool), np.zeros((f, t), np.int32)


def _tables(arrs):
    return jodo.TrackTable(*arrs), todo.TrackTable(*arrs)


def test_build_window_identical():
    (pos, alive, birth), _ = scene_table(seed=3, n_frames=12, slots=48, h=180, w=320)
    alive[4:6, :7] = False
    for kf in (np.array([0, 3, 6, 9]), np.array([2, 5, 11]), np.array([10, 11])):
        jt, tt = _tables((pos, alive, birth))
        want = jodo.build_window(jt, kf, jodo.OdometryConfig())
        got = todo.build_window(tt, kf, todo.OdometryConfig())
        assert np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])
        assert got[1].any() and not got[1].all()


@pytest.mark.parametrize("noise_px", [0.3, 3.0], ids=["clean", "noisy"])
def test_select_keyframes_identical(noise_px):
    arrs = _table_for(np.random.RandomState(0), noise_px, 1.5)
    jt, tt = _tables(arrs)
    want = jodo.select_keyframes(jt, jcam.Pinhole.from_fov(320, 180, 90.0), jodo.OdometryConfig())
    got = todo.select_keyframes(tt, tcam.Pinhole.from_fov(320, 180, 90.0), todo.OdometryConfig(), device="cpu")
    assert got.tolist() == want.tolist() and len(got) > 5


def test_nanmedian_matches_jax():
    """The even-count median averages the middle pair; all-NaN gives NaN."""
    x = np.random.RandomState(1).normal(size=(5, 9)).astype(np.float32)
    x[0, :4] = np.nan
    x[1, :5] = np.nan
    x[2] = np.nan
    want = np.asarray(jnp.nanmedian(jnp.asarray(x), axis=-1))
    got = todo._nanmedian(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isnan(got), np.isnan(want)) and np.isnan(got[2])
    assert np.array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


def test_triangulate():
    cs, rs, x, obs, mask = _scene(np.random.RandomState(0), noise=0.0)
    mask[2, :10] = False
    rv = np.array(jax.jit(jax.vmap(jba.so3_log))(jnp.asarray(rs, jnp.float32)))
    tv = np.stack([-(rs[k] @ cs[k]) for k in range(len(rs))]).astype(np.float32)
    want = np.asarray(jax.jit(jodo.triangulate)(*map(jnp.asarray, (obs, mask, rv, tv))))
    got = todo.triangulate(*map(torch.from_numpy, (obs, mask, rv, tv))).numpy()
    # relative to the landmarks' scale (depths 4-12): float32 eigenvectors
    # of the normal matrices differ between LAPACK builds by ~1e-4 of it
    assert _rel(want, got) <= 1e-4
    assert np.abs(got - x).max() < 1e-2


# the JAX scale-vote path's eager calls, jitted once for the module
# (dispatch only: the same computations, compiled instead of run op by op)
_JITTED = {
    "estimate_relative_pose": jax.jit(jodo.estimate_relative_pose,
                                      static_argnames=("ransac_rounds", "sample_size", "seed")),
    "triangulate": jax.jit(jodo.triangulate),
    "_scale_votes": jax.jit(jodo._scale_votes),
}


@pytest.fixture
def jax_jitted(monkeypatch):
    for name, fn in _JITTED.items():
        monkeypatch.setattr(jodo, name, fn)


def _scale_scene():
    """Unequal step lengths along z (tests/test_odometry.py's scale scene)."""
    rng = np.random.RandomState(2)
    m, l = 5, 100
    steps = np.array([[0, 0, 0.2], [0, 0, 0.8], [0, 0, 0.4], [0, 0, 1.2]])
    cs = np.concatenate([[np.zeros(3)], np.cumsum(steps, 0)])
    x = rng.uniform([-3, -2, 4], [3, 2, 12], (l, 3))
    obs = np.zeros((m, l, 2), np.float32)
    for k in range(m):
        pc = x - cs[k]
        obs[k] = pc[:, :2] / pc[:, 2:3]
    return obs, np.ones((m, l), bool)


@pytest.mark.parametrize("scale_votes", [False, True])
def test_init_window_poses(scale_votes, jax_jitted):
    if scale_votes:
        obs, mask = _scale_scene()
    else:
        _, _, _, obs, mask = _scene(np.random.RandomState(1))
    want = jodo.init_window_poses(obs, mask, jodo.OdometryConfig(scale_votes=scale_votes))
    got = todo.init_window_poses(obs, mask, todo.OdometryConfig(scale_votes=scale_votes))
    assert np.abs(got[0] - np.asarray(want[0])).max() <= 1e-4  # rvecs
    assert np.abs(got[1] - np.asarray(want[1])).max() <= 1e-4  # tvecs
    assert _rel(want[2], got[2]) <= 1e-4  # the landmarks, as in test_triangulate


@pytest.mark.parametrize("scale_votes", [False, True])
def test_window_ba(scale_votes, jax_jitted):
    rng = np.random.RandomState(1)
    cs, rs, x, obs, mask = _scene(rng)
    mask[rng.randint(0, len(rs), 40), rng.randint(0, x.shape[0], 40)] = False
    cfg = jodo.OdometryConfig(scale_votes=scale_votes)
    rv_w, tv_w, st_w = jodo.window_ba(obs, mask, cfg)
    rv_g, tv_g, st_g = todo.window_ba(obs, mask, convert.odometry_config(cfg))
    assert _rel(rv_w, rv_g) <= 1e-3 and _rel(tv_w, tv_g) <= 1e-3
    assert _rel(st_w["raw_rvecs"], st_g["raw_rvecs"]) <= 1e-3 and _rel(st_w["raw_tvecs"], st_g["raw_tvecs"]) <= 1e-3
    for k in ("cost0", "cost"):
        assert abs(st_g[k] - st_w[k]) <= 1e-3 * st_w[k], k
    assert st_g["n_obs"] == st_w["n_obs"] and st_g["cost"] <= st_g["cost0"]


def test_stitch_pose_graph_identical():
    rng = np.random.RandomState(4)
    windows = [(rng.normal(0, 0.1, (4, 3)), rng.normal([0, 0, 1.0], 0.2, (4, 3))) for _ in range(5)]
    windows.append((rng.normal(0, 0.1, (2, 3)), rng.normal(0, 0.2, (2, 3))))  # a short tail
    starts = [0, 1, 2, 3, 4, 5]
    want = jodo.stitch_pose_graph(windows, starts)
    got = todo.stitch_pose_graph(windows, starts)
    assert all(np.array_equal(a, b) for a, b in zip(want, got))


def test_ego_motion_track_on_scene_table():
    """A 3D scene tracked by 96 slots over 20 frames at 360x640 (slots
    reborn as their landmarks leave the view)."""
    arrs, centers = scene_table(seed=0, n_frames=20, slots=96, h=360, w=640)
    jt, tt = _tables(arrs)
    want = jodo.ego_motion_track(None, None, jcam.Pinhole.from_fov(640, 360, 155.0), jodo.OdometryConfig(), table=jt)
    got = todo.ego_motion_track(None, None, tcam.Pinhole.from_fov(640, 360, 155.0), todo.OdometryConfig(),
                                table=tt, device="cpu")
    assert got.kf_idx.tolist() == want.kf_idx.tolist() and len(got.kf_idx) >= 5
    span = np.linalg.norm(want.centers - want.centers[0], axis=-1).max()
    assert np.abs(got.centers - want.centers).max() <= 1e-3 * span
    assert np.abs(got.raw_centers - want.raw_centers).max() <= 1e-3 * span
    assert np.abs(got.rotations - want.rotations).max() <= 1e-3
    assert [s["n_obs"] for s in got.stats] == [s["n_obs"] for s in want.stats]
    d = np.diff(got.centers, axis=0)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    assert np.abs(d[:, 2]).mean() > 0.9  # forward flight


def _zoom_clip(h=144, w=256, f=9, seed=3):
    """tests/test_odometry.py's zoom-in clip (a textured plane under forward
    motion) at 144x256, its texture blurred by numpy."""
    rng = np.random.RandomState(seed)
    tex = rng.uniform(0, 255, (h * 3, w * 3))
    k = np.array([0.25, 0.5, 0.25])
    for _ in range(2):
        tex = np.apply_along_axis(np.convolve, 1, tex, k, mode="same")
        tex = np.apply_along_axis(np.convolve, 0, tex, k, mode="same")
    frames = []
    for i in range(f):
        s = 1.0 + 0.012 * i
        hh, ww = int(h * 1.5 / s), int(w * 1.5 / s)
        y0 = (tex.shape[0] - hh) // 2
        x0 = (tex.shape[1] - ww) // 2
        crop = tex[y0 : y0 + hh, x0 : x0 + ww]
        yy = np.linspace(0, hh - 1, h).astype(int)
        xx = np.linspace(0, ww - 1, w).astype(int)
        frames.append(crop[np.ix_(yy, xx)])
    return np.stack(frames).astype(np.uint8)


def test_collect_tracks():
    frames = _zoom_clip()
    params = jconfig.TrackerParams(
        lk=jconfig.LKParams(win_size=(15, 15)),
        max_tracks=96,
        features=jconfig.FeatureParams(max_corners=48, quality_level=0.05, max_candidates=256),
    )
    want = jodo.collect_tracks(frames, params)
    got = todo.collect_tracks(frames, convert.tracker_params(params), chunk=5, device="cpu")
    assert got.pos.shape == want.pos.shape == (9, 96, 2)
    assert np.array_equal(got.alive, want.alive) and np.array_equal(got.birth, want.birth)
    assert got.alive[-1].sum() > 20 and (got.birth > 0).any()
    assert np.abs(got.pos - want.pos)[got.alive].max() <= 0.05


def test_odometry_config_and_cuda():
    cfg = jodo.OdometryConfig(window=5, kf_stride=3, huber_px=None)
    assert convert.odometry_config(cfg) == todo.OdometryConfig(window=5, kf_stride=3, huber_px=None)
    assert convert.odometry_config(jodo.OdometryConfig()) == todo.OdometryConfig()
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        todo.ego_motion_track(np.zeros((3, 8, 8), np.uint8), convert.tracker_params(jconfig.TrackerParams()),
                              tcam.Pinhole.from_fov(8, 8))


class _Reached(Exception):
    pass


@pytest.mark.parametrize("scale_votes", [False, True])
@pytest.mark.parametrize("geometry_device", [None, "meta"], ids=["default", "meta"])
def test_geometry_device_placement(scale_votes, geometry_device, monkeypatch):
    """Keyframes are picked on `device`, every window solve (the batched
    _window_solve, or window_ba with scale votes) runs on
    `geometry_device`, the CPU unless the caller passes another. The
    "meta" device stands in for the GPU: select_keyframes records it and
    computes on the CPU; a solve that reaches "meta" records it and stops
    the run. By default the result equals the all-CPU run's."""
    seen = {"keyframes": [], "solves": []}
    real_kf = todo.select_keyframes

    def select_keyframes(table, cam, cfg, device):
        seen["keyframes"].append(torch.device(device))
        return real_kf(table, cam, cfg, "cpu")

    def recorder(real):
        def solve(obs, mask, cfg):
            seen["solves"].append(obs.device)
            if obs.device.type == "meta":
                raise _Reached
            return real(obs, mask, cfg)
        return solve

    tt = todo.TrackTable(*scene_table(seed=2, n_frames=12, slots=48, h=180, w=320)[0])
    cam = tcam.Pinhole.from_fov(320, 180, 155.0)
    cfg = todo.OdometryConfig(scale_votes=scale_votes)
    want = todo.ego_motion_track(None, None, cam, cfg, table=tt, device="cpu")
    monkeypatch.setattr(todo, "select_keyframes", select_keyframes)
    monkeypatch.setattr(todo, "_window_solve", recorder(todo._window_solve))
    monkeypatch.setattr(todo, "window_ba", recorder(todo.window_ba))
    kw = {} if geometry_device is None else {"geometry_device": geometry_device}
    if geometry_device is None:
        got = todo.ego_motion_track(None, None, cam, cfg, table=tt, device="meta", **kw)
        assert got.kf_idx.tolist() == want.kf_idx.tolist() and len(got.kf_idx) >= 3
        assert np.array_equal(got.centers, want.centers) and np.array_equal(got.raw_centers, want.raw_centers)
        assert set(seen["solves"]) == {torch.device("cpu")}
        # one solve a window with scale votes, else one a group of same-size windows
        groups = {len(st["raw_rvecs"]) for st in want.stats}
        assert len(seen["solves"]) == (len(want.stats) if scale_votes else len(groups))
    else:
        with pytest.raises(_Reached):
            todo.ego_motion_track(None, None, cam, cfg, table=tt, device="cpu", **kw)
        assert seen["solves"] == [torch.device("meta")]
    assert seen["keyframes"] == [torch.device("meta" if geometry_device is None else "cpu")]


def test_geometry_device_cuda_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tt = todo.TrackTable(*scene_table(seed=2, n_frames=12, slots=48, h=180, w=320)[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        todo.ego_motion_track(None, None, tcam.Pinhole.from_fov(320, 180, 155.0), todo.OdometryConfig(),
                              table=tt, device="cpu", geometry_device="cuda")
