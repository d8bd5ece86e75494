"""The stream-batched grid path against per-stream calls and against the
JAX package, B = 3 streams on the CPU:

- median / percentile / their masked forms / robust_mask on (B, N) equal
  a loop of the 1-D forms per row exactly, and `jax.vmap` of JAX's forms
  within the stats tolerances (1e-6 relative; identical masks);
- lk_level_reference and patch_bilinear_reference with a stream axis equal
  their per-plane calls;
- lk_grid_flow on (B, H, W) frames equals lk_grid_flow per stream bit for
  bit, at the production grid config and at LKParams() (the exact path),
  and agrees per stream with JAX's lk_grid_flow (what its vmap computes
  per stream): 0.05 px on the grid path, 1e-3 px on the exact path;
- streams with different textures and motions, on which statistics pooled
  over the streams would pick other points.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hackathonopticalflow_tpu.core import LKParams as JLKParams
from hackathonopticalflow_tpu.core.config import PROTO_FILTER as J_PROTO_FILTER
from hackathonopticalflow_tpu.core.config import FilterParams as JFilterParams
from hackathonopticalflow_tpu.flow import lk_grid as jgrid
from hackathonopticalflow_tpu.nav import filter as jfilter
from hackathonopticalflow_tpu.ops import stats as jstats
from hackathonopticalflow_tpu_torch.core import PROTO_FILTER, FilterParams, LKParams, measurement_grid
from hackathonopticalflow_tpu_torch.flow import lk_grid as tgrid
from hackathonopticalflow_tpu_torch.nav import filter as tfilter
from hackathonopticalflow_tpu_torch.ops import lk as tlk
from hackathonopticalflow_tpu_torch.ops import stats as tstats
from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level_reference
from hackathonopticalflow_tpu_torch.ops.patch_bilinear import patch_bilinear_reference
from test_torch_prepare import smooth_texture

torch.set_num_threads(1)

B = 3
H, W = 180, 320
GRID = (JLKParams(grid_step=30, use_pallas=True, compute_err=False), LKParams(grid_step=30, compute_err=False))
EXACT = (JLKParams(), LKParams())
# per stream: texture seed and (dx, dy) shift per frame; the motions differ,
# so each stream's median and P99 differ from the pooled ones
STREAMS = ((8, (1, 1)), (9, (4, -2)), (10, (-7, 3)))


def _streams(h=H, w=W):
    """(2, B, h, w) u8: frame 1 of stream b is frame 0 moved by its shift."""
    out = []
    for seed, (dx, dy) in STREAMS:
        sm = np.clip(np.floor(smooth_texture(seed, h + 40, w + 40) + 0.5), 0, 255).astype(np.uint8)
        out.append(np.stack([sm[20 + t * dy : 20 + t * dy + h, 20 + t * dx : 20 + t * dx + w] for t in range(2)]))
    return np.stack(out, 1)


def _rows(seed, n=144):
    """(B, n) magnitudes as tests/test_torch_lk_grid.py draws them (gamma),
    each row at its own scale, with ties."""
    rng = np.random.RandomState(seed)
    x = rng.gamma(2.0, 3.0, (B, n)).astype(np.float32) * np.array([[1.0], [3.0], [9.0]], np.float32)
    x[:, : n // 20] = x[:, n // 2 : n // 2 + 1]
    return x


def _masks(seed, n=144):
    """(B, n): an odd count, an even count and no valid entry."""
    rng = np.random.RandomState(seed + 1)
    m = rng.rand(B, n) < 0.6
    if m[0].sum() % 2 == 0:
        m[0, np.flatnonzero(~m[0])[0]] = True
    if m[1].sum() % 2 == 1:
        m[1, np.flatnonzero(~m[1])[0]] = True
    m[2] = False
    return m


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("n", [144, 2304, 7])
def test_median_percentile_per_row(n):
    x = torch.from_numpy(_rows(n, n))
    med = tstats.median(x)
    assert med.shape == (B,)
    assert torch.equal(med, torch.stack([tstats.median(r) for r in x]))
    _close(med, jax.vmap(jstats.median)(jnp.asarray(x.numpy())))
    for q in (99.0, 50.0, 0.0):
        got = tstats.percentile(x, q)
        assert torch.equal(got, torch.stack([tstats.percentile(r, q) for r in x]))
        np.testing.assert_allclose(got.numpy(), np.percentile(x.numpy().astype(np.float64), q, axis=-1), rtol=1e-7)
        want = np.asarray(jax.vmap(lambda r: jstats.percentile(r, q))(jnp.asarray(x.numpy())))
        # ROADMAP fault 4: XLA rounds the rank to float32, which moves the
        # interpolated value by up to the rank's rounding times the gap
        # between the two order statistics
        v = np.sort(x.numpy(), axis=-1).astype(np.float64)
        pos = q / 100.0 * (n - 1)
        lo, hi = int(np.floor(pos)), min(int(np.floor(pos)) + 1, n - 1)
        slack = 2.0 * np.spacing(np.float32(max(pos, 1.0))) * (v[:, hi] - v[:, lo])
        assert np.all(np.abs(got.numpy() - want) <= 1e-6 * np.abs(want) + slack)


def test_masked_statistics_per_row():
    x, m = torch.from_numpy(_rows(3)), torch.from_numpy(_masks(3))
    jx, jm = jnp.asarray(x.numpy()), jnp.asarray(m.numpy())
    med = tstats.masked_median(x, m)
    assert torch.equal(med, torch.stack([tstats.masked_median(r, k) for r, k in zip(x, m)]))
    _close(med, jax.vmap(jstats.masked_median)(jx, jm))
    for q in (99.0, 50.0):
        got = tstats.masked_percentile(x, m, q)
        want = torch.stack([tstats.masked_percentile(r, k, q) for r, k in zip(x, m)])
        assert torch.equal(got[:2], want[:2]) and bool(torch.isnan(got[2])) and bool(torch.isnan(want[2]))
        _close(got, jax.vmap(lambda r, k: jstats.masked_percentile(r, k, q))(jx, jm))


@pytest.mark.parametrize("filt", ["viewer", "proto"])
def test_robust_mask_per_row(filt):
    """Each row's mask is its own 1-D mask, and JAX's vmapped one; the
    rows' scales differ, so statistics pooled over the rows would keep
    other entries."""
    tp, jp = (FilterParams(), JFilterParams()) if filt == "viewer" else (PROTO_FILTER, J_PROTO_FILTER)
    x = torch.from_numpy(_rows(5))
    got = tfilter.robust_mask(x, tp)
    assert torch.equal(got, torch.stack([tfilter.robust_mask(r, tp) for r in x]))
    assert np.array_equal(got.numpy(), np.asarray(jax.vmap(lambda r: jfilter.robust_mask(r, jp))(jnp.asarray(x.numpy()))))
    pooled = tfilter.robust_mask(x.reshape(-1), tp).reshape(B, -1)
    assert not torch.equal(got, pooled)
    m = torch.from_numpy(_masks(5))
    got_m = tfilter.robust_mask_masked(x, m, tp)
    assert torch.equal(got_m, torch.stack([tfilter.robust_mask_masked(r, k, tp) for r, k in zip(x, m)]))
    want_m = jax.vmap(lambda r, k: jfilter.robust_mask_masked(r, k, jp))(jnp.asarray(x.numpy()), jnp.asarray(m.numpy()))
    assert np.array_equal(got_m.numpy(), np.asarray(want_m))


def _level_args(params, frames, level):
    """lk_level's inputs at `level` for the B streams (stream-major) and
    for each stream alone, from the grid points' coarse estimate."""
    pts_np = measurement_grid(H, W, 30)
    pts = torch.from_numpy(pts_np)
    grid_xy = (np.unique(pts_np[:, 0]).astype(int), np.unique(pts_np[:, 1]).astype(int))

    def inputs(a, b, p):
        prev, nxt = tlk.prepare_frame(torch.from_numpy(a), params), tlk.prepare_frame(torch.from_numpy(b), params)
        center = p * float(2.0 ** (level - params.max_level))
        if params.grid_step is None:
            args, kw, _ = tlk.point_level_inputs(prev, nxt, p, center, level, params)
        else:
            args, kw = tlk.level_inputs(prev, nxt, grid_xy, center, level, params)
        return args, kw

    batched = inputs(frames[1], frames[0], pts.repeat(B, 1))
    single = [inputs(frames[1, s], frames[0, s], pts) for s in range(B)]
    return batched, single


@pytest.mark.parametrize("config", ["grid", "exact"])
@pytest.mark.parametrize("level", [2, 0])
def test_lk_level_reference_stream_axis(config, level):
    """lk_level_reference on (B, Hp, Wp) planes and stream-major points
    equals its call on each stream's plane, top-lefts and status."""
    params = GRID[1] if config == "grid" else EXACT[1]
    (args, kw), single = _level_args(params, _streams(), level)
    assert args[1].dim() == 3
    n = args[0].shape[0] // B
    status = torch.ones(B * n, dtype=torch.bool)
    tl, st = lk_level_reference(*args, status, **kw)
    for s, (a1, kw1) in enumerate(single):
        assert torch.equal(a1[0], args[0][s * n : (s + 1) * n])
        tl1, st1 = lk_level_reference(*a1, status[:n], **kw1)
        assert torch.equal(tl1, tl[s * n : (s + 1) * n]), s
        assert torch.equal(st1, st[s * n : (s + 1) * n]), s


@pytest.mark.parametrize("quantize", [True, False])
def test_patch_bilinear_reference_stream_axis(quantize):
    rng = np.random.RandomState(11)
    planes = torch.from_numpy(rng.uniform(0, 255, (B, 3, 40, 60)).astype(np.float32))
    tl = torch.from_numpy(rng.uniform(-20, 70, (B * 25, 2)).astype(np.float32))
    got = patch_bilinear_reference(planes, tl, 9, 11, quantize)
    assert got.shape == (B * 25, 3, 9, 11)
    for s in range(B):
        want = patch_bilinear_reference(planes[s], tl[s * 25 : (s + 1) * 25], 9, 11, quantize)
        assert torch.equal(got[s * 25 : (s + 1) * 25], want)


@pytest.fixture(scope="module")
def batched_flows():
    """The port's lk_grid_flow on the (B, H, W) pair in both configs."""
    frames = _streams()
    pts = torch.from_numpy(measurement_grid(H, W, 30))
    return frames, {
        name: tgrid.lk_grid_flow(torch.from_numpy(frames[0]), torch.from_numpy(frames[1]), pts, lk=cfg[1],
                                 device="cpu")
        for name, cfg in (("grid", GRID), ("exact", EXACT))
    }


@pytest.mark.parametrize("config", ["grid", "exact"])
def test_lk_grid_flow_batched_equals_per_stream(batched_flows, config):
    frames, flows = batched_flows
    res = flows[config]
    pts = torch.from_numpy(measurement_grid(H, W, 30))
    n = pts.shape[0]
    assert res.raw_next_pts.shape == (B, n, 2) and res.good.shape == (B, n) and res.pts.shape == (B, n, 2)
    lk = GRID[1] if config == "grid" else EXACT[1]
    for s in range(B):
        one = tgrid.lk_grid_flow(torch.from_numpy(frames[0, s]), torch.from_numpy(frames[1, s]), pts, lk=lk,
                                 device="cpu")
        for name, v in one._asdict().items():
            assert torch.equal(v, getattr(res, name)[s]), (s, name)
    # the streams' statistics differ: pooled over the streams, the mask
    # would keep other points
    pooled = tfilter.robust_mask(res.modulus.reshape(-1)).reshape(B, n)
    assert not torch.equal(pooled, res.good)


@pytest.mark.parametrize("config", ["grid", "exact"])
def test_lk_grid_flow_batched_matches_jax_per_stream(batched_flows, config):
    frames, flows = batched_flows
    res = flows[config]
    jparams = GRID[0] if config == "grid" else EXACT[0]
    tol = 0.05 if config == "grid" else 1e-3
    jpts = jnp.asarray(measurement_grid(H, W, 30))
    fn = jax.jit(lambda a, b: jgrid.lk_grid_flow(a, b, jpts, lk=jparams))
    for s, (_, (dx, dy)) in enumerate(STREAMS):
        want = fn(jnp.asarray(frames[0, s]), jnp.asarray(frames[1, s]))
        st = np.asarray(want.status)
        assert np.array_equal(res.status[s].numpy(), st), s
        raw = res.raw_next_pts[s].numpy()
        assert np.abs(raw - np.asarray(want.raw_next_pts))[st].max() < tol, s
        assert np.mean(res.good[s].numpy() == np.asarray(want.good)) >= 0.95, s
        # the backward flow is the stream's own shift
        assert np.abs(np.median(raw[st] - np.asarray(jpts)[st], axis=0) - [dx, dy]).max() < 0.1, s


def test_pack_unpack_stream_axis(batched_flows):
    """pack_grid_result / unpack_grid_result keep a (T, B) lead."""
    _, flows = batched_flows
    res = tgrid.GridFlowResult(*(torch.stack([f, f]) for f in flows["grid"]))
    packed = tgrid.pack_grid_result(res)
    n = res.modulus.shape[-1]
    assert packed.shape == (2, B, 10 * n)
    back = tgrid.unpack_grid_result(packed.numpy(), res.pts[0, 0].numpy())
    for name, v in res._asdict().items():
        assert np.array_equal(getattr(back, name), v.numpy()), name
