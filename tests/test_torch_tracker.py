"""PyTorch port vs the JAX package: LK at arbitrary points in both crop
geometries, the level-0 err, and the Shi-Tomasi + forward-backward
tracker (ops/lk.py, flow/tracker.py, convert.py).

The JAX references run once per module under jax.jit: TRACKER_LK runs
its points-in-lanes Pallas kernel in interpret mode; the v1 geometry runs
as LKParams(win_size=(15, 15), slab_margin=8), the XLA slab path, which
has the v1 kernel's geometry. Bars:
- positions within 0.05 px of JAX with identical status (the JAX
  package's own bar between its kernels; the port sums A and b exactly in
  float64 where JAX sums in float32);
- err within 5e-3 grey levels where both statuses are true: the residual
  windows are sampled at positions that differ by the position error
  (under 1e-3 px here) times the texture's gradient (a few grey levels
  per px);
- tracker decisions (alive, length, spawned slots) identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hackathonopticalflow_tpu.core.config import TRACKER_LK, FeatureParams, LKParams, TrackerParams
from hackathonopticalflow_tpu.core.grid import measurement_grid
from hackathonopticalflow_tpu.flow import tracker as jtr
from hackathonopticalflow_tpu.ops import lk as jlk
from hackathonopticalflow_tpu_torch import convert
from hackathonopticalflow_tpu_torch import core as tcore
from hackathonopticalflow_tpu_torch.flow import dense as tdense
from hackathonopticalflow_tpu_torch.flow import lk_grid as tgrid
from hackathonopticalflow_tpu_torch.flow import tracker as ttr
from hackathonopticalflow_tpu_torch.ops import lk as tlk
from chip_smoke import tracker_points
from test_torch_prepare import shifted_pair, smooth_texture

torch.set_num_threads(1)

H, W = 144, 256
N_FRAMES = 7  # the seeding step plus 6 steps: detections at frame_idx 0 and 5
GEOMETRIES = {
    "lanes": TRACKER_LK,
    "v1": LKParams(win_size=(15, 15), slab_margin=8),
}
TOL_PX = 0.05
TOL_ERR = 5e-3


def _tracker_params(lk):
    return TrackerParams(lk=lk, max_tracks=64, features=FeatureParams(max_candidates=256))


def _clip():
    """N_FRAMES u8 frames drifting by (+2, +1) px per frame over a texture."""
    sm = smooth_texture(21, H + 40, W + 48)
    sm = np.clip(np.floor(sm + 0.5), 0, 255).astype(np.uint8)
    return np.stack([sm[10 + t : 10 + t + H, 10 + 2 * t : 10 + 2 * t + W] for t in range(N_FRAMES)])


N_BAND = 24  # tracker_points' last 24 points lie in the v1 geometry's clipped edge bands


def _points():
    return tracker_points(H, W, 72)


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def jax_levels(request):
    """The JAX arbitrary-point path on one pair, level by level: each
    level's inputs (next_center, status) and outputs (and err at L0)."""
    params = GEOMETRIES[request.param]
    frames = _clip()
    pts = _points()
    prev = jlk.prepare_frame(jnp.asarray(frames[0], jnp.float32), params)
    nxt = jlk.prepare_frame(jnp.asarray(frames[1], jnp.float32), params)
    level_fn = jax.jit(jlk._level_lk, static_argnums=(5, 6))
    center = jnp.asarray(pts) * jnp.float32(1.0 / (1 << params.max_level))
    status = jnp.ones(pts.shape[0], bool)
    levels = {}
    for level in range(params.max_level, -1, -1):
        if level != params.max_level:
            center = center * 2.0
        out_c, out_s, out_e = level_fn(prev, nxt, jnp.asarray(pts), center, status, level, params)
        levels[level] = tuple(np.array(v) for v in (center, status, out_c, out_s, out_e))
        center, status = out_c, out_s
    return dict(name=request.param, params=params, frames=frames, pts=pts, prev=prev, nxt=nxt,
                levels=levels)


@pytest.mark.parametrize("level", [2, 1, 0])
def test_level_matches_jax(jax_levels, level):
    """One level of the port's arbitrary-point path on the JAX package's
    prepared frames and level inputs, including the clipped edge band."""
    c_in, s_in, c_ref, s_ref, e_ref = jax_levels["levels"][level]
    params = convert.lk_params(jax_levels["params"])
    prev = convert.prepared_frame(jax_levels["prev"])
    nxt = convert.prepared_frame(jax_levels["nxt"])
    c, s, e = tlk._level_lk(
        prev, nxt, torch.from_numpy(jax_levels["pts"]), torch.from_numpy(c_in),
        torch.from_numpy(s_in), level, params,
    )
    assert np.array_equal(s.numpy(), s_ref)
    assert np.abs(c.numpy() - c_ref).max() <= TOL_PX
    # the band points do iterate (their estimate moves), so the clipped
    # slab geometry is exercised
    moved = np.abs(c.numpy() - c_in).max(-1) > 1e-3
    assert moved[-N_BAND:].sum() >= 3, moved[-N_BAND:]
    if level == 0:
        both = s.numpy() & s_ref
        assert both.sum() >= 24
        assert np.abs(e.numpy() - e_ref)[both].max() <= TOL_ERR
        assert not e.numpy()[~s.numpy()].any()
    else:
        assert e is None


def test_level0_err_ignores_compute_err(jax_levels):
    """JAX's arbitrary-point branches give the level-0 err whatever
    compute_err says (ops/lk.py:364-369, 408-413); so does the port."""
    c_in, s_in, c_ref, s_ref, e_ref = jax_levels["levels"][0]
    params = dataclasses.replace(convert.lk_params(jax_levels["params"]), compute_err=False)
    prev = convert.prepared_frame(jax_levels["prev"])
    nxt = convert.prepared_frame(jax_levels["nxt"])
    _, s, e = tlk._level_lk(
        prev, nxt, torch.from_numpy(jax_levels["pts"]), torch.from_numpy(c_in),
        torch.from_numpy(s_in), 0, params,
    )
    both = s.numpy() & s_ref
    assert (e.numpy()[both] > 0).all()
    assert np.abs(e.numpy() - e_ref)[both].max() <= TOL_ERR


def test_pyr_lk_matches_jax(jax_levels):
    """pyr_lk on the raw frames vs the JAX level chain's end (its
    pyr_lk_prepared): status identical, positions and err within the
    bars."""
    params = convert.lk_params(jax_levels["params"])
    a, b = jax_levels["frames"][:2]
    res = tlk.pyr_lk(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(jax_levels["pts"]), params)
    _, _, c_ref, s_ref, e_ref = jax_levels["levels"][0]
    assert np.array_equal(res.status.numpy(), s_ref)
    assert np.abs(res.next_pts.numpy() - c_ref).max() <= TOL_PX
    both = res.status.numpy() & s_ref
    assert np.abs(res.err.numpy() - e_ref)[both].max() <= TOL_ERR
    # sanity: in-frame points track the drift (frame 1 is frame 0 moved by (-2, -1))
    flow = res.next_pts.numpy()[:-N_BAND] - jax_levels["pts"][:-N_BAND]
    assert np.abs(np.median(flow, axis=0) - [-2, -1]).max() < 0.1


def test_grid_compute_err_matches_jax():
    """compute_err on the grid path (the production params with err on):
    err within the bar of JAX LKParams(grid_step=30, use_pallas=True)."""
    jparams = LKParams(grid_step=30, use_pallas=True)
    a, b = shifted_pair(9, 3, 2, h=H, w=W)
    pts = measurement_grid(*a.shape, 30)
    want = jlk.pyr_lk(jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32), jnp.asarray(pts), jparams)
    got = tlk.pyr_lk(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(pts), convert.lk_params(jparams))
    s_ref = np.asarray(want.status)
    assert np.array_equal(got.status.numpy(), s_ref)
    assert np.abs(got.next_pts.numpy() - np.asarray(want.next_pts)).max() <= TOL_PX
    err, e_ref = got.err.numpy(), np.asarray(want.err)
    assert np.abs(err - e_ref)[s_ref].max() <= TOL_ERR
    assert (err[s_ref] > 0).all() and not err[~s_ref].any()


@pytest.fixture(scope="module", params=sorted(GEOMETRIES))
def jax_tracker(request):
    """The JAX tracker over the clip: the seeding step (f0, f0), then
    track_video over all frames (frame_idx 1..6)."""
    params = _tracker_params(GEOMETRIES[request.param])
    frames = _clip()
    fr = jnp.asarray(frames, jnp.float32)
    s0 = jax.jit(lambda s, a, b: jtr.track_step(s, a, b, params))(jtr.init_tracker(params), fr[0], fr[0])
    s, hist = jax.jit(lambda f, s: jtr.track_video(f, params, s))(fr, s0)
    np_state = lambda st: jtr.TrackerState(*(np.asarray(v) for v in st))
    return dict(params=params, frames=frames, s0=np_state(s0), s=np_state(s),
                hist=tuple(np.asarray(v) for v in hist))


def test_track_seed_step_matches_jax(jax_tracker):
    """The seeding step's detections land in the same slots at the same
    integer corners."""
    params = convert.tracker_params(jax_tracker["params"])
    f0 = torch.from_numpy(jax_tracker["frames"][0])
    s0 = ttr.track_step(ttr.init_tracker(params, device="cpu"), f0, f0, params, device="cpu")
    ref = jax_tracker["s0"]
    assert int(ref.alive.sum()) == params.features.max_corners
    assert np.array_equal(s0.alive.numpy(), ref.alive)
    assert np.array_equal(s0.length.numpy(), ref.length)
    assert np.array_equal(s0.traj.numpy(), ref.traj)
    assert s0.frame_idx == int(ref.frame_idx) == 1


def test_track_video_matches_jax(jax_tracker):
    """7 frames, two detections inside (frame_idx 0 and 5): alive, length
    and the spawned slots identical at every step, positions within the
    bar."""
    params = convert.tracker_params(jax_tracker["params"])
    s0 = convert.tracker_state(jax_tracker["s0"])
    s, (heads, alive, length) = ttr.track_video(
        torch.from_numpy(jax_tracker["frames"]), params, s0, device="cpu"
    )
    h_ref, a_ref, l_ref = jax_tracker["hist"]
    assert np.array_equal(alive.numpy(), a_ref)
    assert np.array_equal(length.numpy(), l_ref)
    assert np.abs(heads.numpy() - h_ref)[a_ref].max() <= TOL_PX
    ref = jax_tracker["s"]
    live = ref.alive
    assert np.array_equal(s.alive.numpy(), live) and np.array_equal(s.length.numpy(), ref.length)
    assert np.abs(s.traj.numpy() - ref.traj)[live].max() <= TOL_PX
    assert s.frame_idx == int(ref.frame_idx) == N_FRAMES
    # detection at frame_idx 5 spawned new tracks, with exact corners
    spawned = (l_ref[4] == 1) & a_ref[4]
    assert spawned.sum() > 0
    assert np.array_equal(heads.numpy()[4][spawned], h_ref[4][spawned])
    # most tracks survive the drift
    assert a_ref[3].sum() >= 0.8 * params.features.max_corners


def test_track_video_equals_steps():
    """The scan (each frame prepared once, carried) equals per-step
    track_step calls exactly, state and history."""
    params = convert.tracker_params(_tracker_params(TRACKER_LK))
    frames = torch.from_numpy(_clip()[:4])
    s = ttr.track_step(ttr.init_tracker(params, device="cpu"), frames[0], frames[0], params, device="cpu")
    s_scan, (heads, alive, length) = ttr.track_video(frames, params, s, device="cpu")
    for t in range(1, frames.shape[0]):
        s = ttr.track_step(s, frames[t - 1], frames[t], params, device="cpu")
        assert torch.equal(ttr._heads(s), heads[t - 1])
        assert torch.equal(s.alive, alive[t - 1]) and torch.equal(s.length, length[t - 1])
    for name in ("traj", "length", "alive"):
        assert torch.equal(getattr(s, name), getattr(s_scan, name)), name
    assert s.frame_idx == s_scan.frame_idx == 4


def _jax_state(traj, length, alive):
    return jtr.TrackerState(
        traj=jnp.asarray(traj), length=jnp.asarray(length), alive=jnp.asarray(alive),
        frame_idx=jnp.int32(0),
    )


def test_append_matches_jax():
    """Shift-left at capacity, append below it, kill the rest."""
    rng = np.random.RandomState(4)
    t, l = 12, 5
    traj = rng.uniform(0, 100, (t, l, 2)).astype(np.float32)
    length = rng.randint(0, l + 1, t).astype(np.int32)
    alive = rng.uniform(size=t) < 0.7
    new = rng.uniform(0, 100, (t, 2)).astype(np.float32)
    keep = alive & (rng.uniform(size=t) < 0.8)
    want = jtr._append(_jax_state(traj, length, alive), jnp.asarray(new), jnp.asarray(keep))
    got = ttr._append(
        convert.tracker_state(_jax_state(traj, length, alive)), torch.from_numpy(new), torch.from_numpy(keep)
    )
    for name in ("traj", "length", "alive"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name))), name


def test_detect_mask_matches_jax():
    """Radius-5 discs at live heads, half-way heads rounded to even,
    discs clipped at the frame's edge: identical."""
    rng = np.random.RandomState(6)
    heads = np.concatenate([
        rng.uniform(-3, [W + 3, H + 3], (20, 2)),
        [[10.5, 20.5], [11.5, 21.5], [0.0, 0.0], [W - 1, H - 1], [-2.5, 50.0]],
    ]).astype(np.float32)
    alive = rng.uniform(size=heads.shape[0]) < 0.6
    alive[-5:] = True
    want = np.asarray(jtr._detect_mask(jnp.asarray(heads), jnp.asarray(alive), H, W))
    got = ttr._detect_mask(torch.from_numpy(heads), torch.from_numpy(alive), H, W)
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), want)


def test_spawn_writes_only_taken_rows():
    """With the table's last slot free, the first corner goes there and
    nothing else changes (the JAX package's dummy rows for untaken
    corners target that same slot)."""
    t, l = 8, 4
    state = ttr.init_tracker(TrackerParams(max_tracks=t, trajectory_len=l), device="cpu")
    traj = torch.arange(t * l * 2, dtype=torch.float32).reshape(t, l, 2)
    alive = torch.ones(t, dtype=torch.bool)
    alive[-1] = False
    length = torch.full((t,), 3, dtype=torch.int32)
    state = state._replace(traj=traj, alive=alive, length=length)
    pts = torch.tensor([[5.0, 6.0], [7.0, 8.0], [0.0, 0.0]])
    corners = ttr.Corners(pts=pts, valid=torch.tensor([True, True, False]), count=torch.tensor(2))
    out = ttr._spawn(state, corners)
    assert bool(out.alive.all())
    assert out.length[-1] == 1 and torch.equal(out.traj[-1, 0], pts[0])
    assert torch.equal(out.traj[-1, 1:], traj[-1, 1:])
    assert torch.equal(out.traj[:-1], traj[:-1]) and torch.equal(out.length[:-1], length[:-1])


ENTRY_POINTS = {
    "lk_grid_flow": lambda f, p: tgrid.lk_grid_flow(f[0], f[1], p),
    "lk_grid_flow_video": lambda f, p: tgrid.lk_grid_flow_video(f, p),
    "farneback_flow": lambda f, p: tdense.farneback_flow(f[0], f[1]),
    "farneback_flow_video": lambda f, p: tdense.farneback_flow_video(f),
    "track_step": lambda f, p: ttr.track_step(ttr.init_tracker(device="cpu"), f[0], f[1]),
    "track_video": lambda f, p: ttr.track_video(f),
    "init_tracker": lambda f, p: ttr.init_tracker(),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_default_to_cuda(name, monkeypatch):
    """The flow entry points run on the GPU unless asked for the CPU: with
    no CUDA device their default raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    frames = torch.zeros((2, 64, 96), dtype=torch.uint8)
    pts = torch.from_numpy(measurement_grid(64, 96, 30))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](frames, pts)


def test_convert_params():
    """JAX configs -> the port's, field by field."""
    assert convert.lk_params(TRACKER_LK) == tcore.TRACKER_LK
    assert convert.tracker_params(TrackerParams()) == tcore.TrackerParams()
    assert convert.feature_params(FeatureParams(max_corners=7)) == tcore.FeatureParams(max_corners=7)
    prod = LKParams(grid_step=30, use_pallas=True, compute_err=False)
    assert convert.lk_params(prod) == tcore.LKParams(grid_step=30, compute_err=False)
    # JAX's v1 kernel: use_pallas without lanes, slab margin defaulting to 8
    v1 = convert.lk_params(LKParams(win_size=(15, 15), use_pallas=True))
    assert v1 == dataclasses.replace(tcore.TRACKER_LK, points_lanes=False)
    with pytest.raises(ValueError):
        convert.lk_params(LKParams(points_lanes=True))


def test_convert_tracker_state():
    rng = np.random.RandomState(8)
    state = jtr.TrackerState(
        traj=jnp.asarray(rng.uniform(0, 50, (6, 4, 2)).astype(np.float32)),
        length=jnp.asarray(rng.randint(0, 5, 6).astype(np.int32)),
        alive=jnp.asarray(rng.uniform(size=6) < 0.5),
        frame_idx=jnp.int32(13),
    )
    got = convert.tracker_state(state)
    assert got.frame_idx == 13 and isinstance(got.frame_idx, int)
    assert got.traj.dtype == torch.float32 and got.length.dtype == torch.int32
    assert got.alive.dtype == torch.bool
    for name in ("traj", "length", "alive"):
        assert np.array_equal(getattr(got, name).numpy(), np.asarray(getattr(state, name))), name
