"""The port's multi-rank layer (hackathonopticalflow_tpu_torch/parallel)
against the JAX package's shard_map functions on 4 of the 8 virtual CPU
devices.

One world of 4 gloo ranks on the CPU runs every port-side check
(tests/torch_parallel_ranks.py::parallel_checks) under a 60 s deadline;
the parent assembles each rank's block and compares:

- halo exchange in the modes "edge", "reflect", "constant": identical to
  JAX's and to slices of the padded frame;
- distributed median and percentile within 1e-6 relative of JAX's; the
  psum-histogram quantile identical;
- derive_halo equal to JAX's for FarnebackParams() and a sweep;
- tiled_farneback ("exact", levels 1) and tiled_farneback_multi (levels
  2, on a (2, 2) mesh; both run one function), on a smooth 256x192
  texture, against JAX's tiled result
  (EPE mean <= 1e-3 px, max <= 0.05 px, the bar of
  tests/test_torch_farneback.py) and against the port's single-device
  farneback over the core rows (<= 1e-3 px);
- stream_batched_grid_flow (two streams a rank) identical to each
  stream's lk_grid_flow, at the production and the exact LKParams;
- the launcher: a failing rank's traceback is raised and the others are
  killed, a rank past the deadline is killed with TimeoutError, and NCCL
  with more ranks than GPUs raises naming gloo.
"""

import multiprocessing
import time
from datetime import timedelta
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

import torch_parallel_ranks as ranks
from hackathonopticalflow_tpu.core.config import FarnebackParams as JFarnebackParams
from hackathonopticalflow_tpu.parallel import halo as jhalo
from hackathonopticalflow_tpu.parallel import quantile as jquantile
from hackathonopticalflow_tpu.parallel import tiling as jtiling
from hackathonopticalflow_tpu.parallel.mesh import make_mesh as j_make_mesh
from hackathonopticalflow_tpu.parallel.mesh import stream_tile_mesh as j_stream_tile_mesh
from hackathonopticalflow_tpu_torch import parallel as par
from hackathonopticalflow_tpu_torch.core import FarnebackParams, measurement_grid
from hackathonopticalflow_tpu_torch.flow.lk_grid import lk_grid_flow
from hackathonopticalflow_tpu_torch.ops.farneback import farneback
from test_torch_prepare import smooth_texture

torch.set_num_threads(1)

H, W = 256, 192
GRID_H, GRID_W = 180, 320


def _pair(seed: int) -> tuple[np.ndarray, np.ndarray]:
    """Two float32 frames of one smooth texture, the second moved by
    (-1, +1) px and zoomed by 1.01 about the centre (flow up to ~2.3 px)."""
    sm = smooth_texture(seed, H + 40, W + 40)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    out = []
    for s, (dx, dy) in ((1.0, (0, 0)), (1.01, (1.0, -1.0))):
        x = cx + (xx - cx) / s + 20 - dx
        y = cy + (yy - cy) / s + 20 - dy
        x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
        ax, ay = x - x0, y - y0
        v = (sm[y0, x0] * (1 - ax) * (1 - ay) + sm[y0, x0 + 1] * ax * (1 - ay)
             + sm[y0 + 1, x0] * (1 - ax) * ay + sm[y0 + 1, x0 + 1] * ax * ay)
        out.append(np.floor(v + 0.5).astype(np.float32))
    return out[0], out[1]


def _inputs() -> dict:
    rng = np.random.RandomState(0)
    a, b = _pair(5)
    c, d = _pair(6)
    tex = rng.uniform(0, 255, (8, GRID_H + 8, GRID_W + 8))
    for _ in range(3):  # smooth, so the grid points track
        tex = 0.25 * np.roll(tex, 1, -1) + 0.5 * tex + 0.25 * np.roll(tex, -1, -1)
        tex = 0.25 * np.roll(tex, 1, -2) + 0.5 * tex + 0.25 * np.roll(tex, -1, -2)
    # eight streams, each its own texture moved by its own (dx, dy)
    prev = tex[:, 4 : 4 + GRID_H, 4 : 4 + GRID_W]
    cur = np.stack([tex[i, 4 + i % 3 : 4 + i % 3 + GRID_H, 2 + i % 5 : 2 + i % 5 + GRID_W] for i in range(8)])
    return {
        "halo_x": np.arange(64 * 6, dtype=np.float32).reshape(64, 6),
        "stat_x": rng.uniform(0, 40, (4, 64)).astype(np.float32),
        "pair": (a, b),
        "pairs": (np.stack([a, c]), np.stack([b, d])),
        "streams": (np.floor(prev).astype(np.uint8), np.floor(cur).astype(np.uint8)),
        "pts": measurement_grid(GRID_H, GRID_W, 30),
    }


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def world(inputs):
    """One 4-rank gloo world on the CPU running every port-side check."""
    return par.run_on_mesh(ranks.parallel_checks, 4, (inputs,), device="cpu", timeout_s=60)


def _cat(world, key) -> np.ndarray:
    return np.concatenate([w[key].numpy() for w in world])


def test_world_ranks_in_order(world):
    assert [w["tile_index"] for w in world] == [0, 1, 2, 3]
    for w in world:  # all_gather tiled and stacked, gather_rows
        assert w["gathered"][0].tolist() == [0, 1, 2, 3] and w["gathered"][1].tolist() == [[0], [1], [2], [3]]
        assert torch.equal(w["tiled_whole"], torch.cat([v["tiled"] for v in world]))
    assert [w["multi_coords"] for w in world] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    # round-robin by rank, as the JAX package splits videos by process
    assert [w["local_streams"] for w in world] == [list("aei"), list("bfj"), list("cg"), list("dh")]
    assert par.host_local_streams(list("abc")) == list("abc")  # one process: every path
    assert par.init_multihost(None) is False  # one process: nothing to do
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("mode", ranks.HALO_MODES)
def test_halo_exchange_matches_jax_and_padding(world, inputs, mode):
    x = inputs["halo_x"]
    h = ranks.HALO_ROWS
    jmesh = j_make_mesh((4,), ("tile",))
    want = np.asarray(shard_map(lambda t: jhalo.halo_exchange_rows(t, h, "tile", mode=mode), mesh=jmesh,
                                in_specs=P("tile", None), out_specs=P("tile", None))(jnp.asarray(x)))
    got = _cat(world, f"halo_{mode}")
    np.testing.assert_array_equal(got, want)
    padded = np.pad(x, ((h, h), (0, 0)), mode={"edge": "edge", "reflect": "reflect", "constant": "constant"}[mode])
    for i in range(4):
        np.testing.assert_array_equal(world[i][f"halo_{mode}"].numpy(), padded[i * 16 : i * 16 + 16 + 2 * h])


def test_distributed_statistics_match_jax(world, inputs):
    jmesh = j_make_mesh((4,), ("tile",))
    x = jnp.asarray(inputs["stat_x"])

    def on_mesh(fn):
        return float(np.asarray(shard_map(lambda t: fn(t)[None], mesh=jmesh, in_specs=P("tile", None),
                                          out_specs=P("tile"))(x))[0])

    med = on_mesh(lambda t: jquantile.distributed_median(t.ravel(), "tile"))
    p99 = on_mesh(lambda t: jquantile.distributed_percentile(t.ravel(), 99, "tile"))
    hist = on_mesh(lambda t: jquantile.psum_histogram_quantile(t, 50.0, "tile", 0.0, 40.0, bins=4096))
    for w in world:  # every rank holds the statistic
        assert abs(float(w["median"]) - med) <= 1e-6 * abs(med)
        assert abs(float(w["p99"]) - p99) <= 1e-6 * abs(p99)
        assert float(w["hist_q50"]) == hist
    assert abs(float(world[0]["median"]) - np.median(inputs["stat_x"])) <= 1e-6 * np.median(inputs["stat_x"])


@pytest.mark.parametrize(
    "kw", [{}, {"levels": 1}, {"levels": 4}, {"win_size": 21}, {"poly_n": 7}, {"pyr_scale": 0.6}]
)
@pytest.mark.parametrize("disp", [0.0, 30.0, 101.0])
def test_derive_halo_matches_jax(kw, disp):
    got = par.derive_halo(FarnebackParams(**kw), disp)
    assert got == jtiling.derive_halo(JFarnebackParams(**kw), disp)
    assert got % 2 == 0
    if not kw and disp == 30.0:
        assert got == 142
        assert par.TileConfig.for_params(FarnebackParams()) == par.TileConfig(halo=142)


def _epe(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.linalg.norm(a - b, axis=-1)


def test_tiled_farneback_matches_jax_and_single(world, inputs):
    levels, halo = ranks.TILED_LEVELS[0]
    a, b = inputs["pair"]
    jmesh = j_make_mesh((4,), ("tile",))
    jp = JFarnebackParams(levels=levels, warp_mode="exact")
    want = np.asarray(jax.jit(lambda x, y: jtiling.tiled_farneback(x, y, jmesh, jp, jtiling.TileConfig(halo=halo)))(a, b))
    got = _cat(world, "tiled")
    assert got.shape == want.shape == (H, W, 2)
    epe = _epe(got, want)
    assert epe.mean() <= 1e-3 and epe.max() <= 0.05, (epe.mean(), epe.max())
    single = farneback(torch.from_numpy(a), torch.from_numpy(b), FarnebackParams(levels=levels)).numpy()
    core = _epe(got, single)[halo:-halo]
    assert core.max() <= 1e-3, core.max()


def test_tiled_farneback_multi_matches_jax_and_single(world, inputs):
    levels, halo = ranks.TILED_LEVELS[-1]
    prev, nxt = inputs["pairs"]
    jmesh = j_stream_tile_mesh(2, 2)
    jp = JFarnebackParams(levels=levels, warp_mode="exact")
    want = np.asarray(jax.jit(lambda x, y: jtiling.tiled_farneback_multi(
        x, y, jmesh, jp, jtiling.TileConfig(halo=halo)))(prev, nxt))
    # rank (s, t) holds stream s's tile t
    got = np.stack([np.concatenate([world[2 * s + t]["multi"].numpy()[0] for t in range(2)]) for s in range(2)])
    epe = _epe(got, want)
    assert epe.mean() <= 1e-3 and epe.max() <= 0.05, (epe.mean(), epe.max())
    single = farneback(torch.from_numpy(prev), torch.from_numpy(nxt), FarnebackParams(levels=levels)).numpy()
    core = _epe(got, single)[:, halo:-halo]
    assert core.max() <= 1e-3, core.max()


@pytest.mark.parametrize("name", list(ranks.GRID_LKS))
def test_stream_batched_grid_flow_equals_per_stream(world, inputs, name):
    prev, cur = inputs["streams"]
    pts = torch.from_numpy(inputs["pts"])
    got = [w[f"grid_{name}"] for w in world]
    assert all(g.flow.shape[0] == 2 for g in got)  # two streams a rank
    for i in range(8):
        want = lk_grid_flow(torch.from_numpy(prev[i]), torch.from_numpy(cur[i]), pts, lk=ranks.GRID_LKS[name],
                            device="cpu")
        res = got[i // 2]
        for field, value in zip(want._fields, want):
            assert torch.equal(getattr(res, field)[i % 2], value), (i, field)
    # the textures track: LK's status holds on most points
    assert sum(int(g.status.sum()) for g in got) > 0.9 * 8 * len(pts)


def test_stream_batched_farneback_equals_per_stream(world, inputs):
    prev, cur = inputs["streams"]
    got = torch.cat([w["dense_streams"] for w in world])
    for i in range(8):  # a batch row equals its stream's own call
        want = farneback(torch.from_numpy(prev[i]), torch.from_numpy(cur[i]), FarnebackParams(levels=1))
        assert torch.equal(got[i], want), i


def test_failing_rank_raises_and_stops_the_world():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        par.run_on_mesh(ranks.failing, 2, (1,), device="cpu", timeout_s=60)
    # rank 0 waited in a psum rank 1 never joined: it was killed, not
    # left to the 60 s collective timeout
    assert time.monotonic() - t0 < 30
    assert not multiprocessing.active_children()


def test_deadline_kills_the_world():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish in 3"):
        par.run_on_mesh(ranks.sleeping, 1, (600.0,), device="cpu", timeout_s=3)
    assert time.monotonic() - t0 < 20
    assert not multiprocessing.active_children()  # the rank was killed and reaped


def test_backend_is_never_chosen_silently():
    with mock.patch.object(torch.cuda, "is_available", return_value=True), \
            mock.patch.object(torch.cuda, "device_count", return_value=1):
        with pytest.raises(ValueError, match="backend='gloo'"):
            par.run_on_mesh(ranks.sleeping, 4, (0.0,), device="cuda", backend="nccl")
        with pytest.raises(ValueError, match="backend='gloo'"):
            par.run_on_mesh(ranks.sleeping, 2, (0.0,), device="cuda")  # nccl by default on CUDA
    with pytest.raises(ValueError, match="need backend='gloo'"):
        par.run_on_mesh(ranks.sleeping, 1, (0.0,), device="cpu", backend="nccl")
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            par.run_on_mesh(ranks.sleeping, 1, (0.0,), device="cuda", backend="gloo")


@pytest.mark.parametrize("route", ["coordinator", "torchrun"])
def test_init_multihost_routes_pass_the_timeout(route, monkeypatch):
    """A coordinator joins over tcp://, torchrun's environment over
    env://; both give init_process_group the collective timeout."""
    calls = []
    monkeypatch.setattr(torch.distributed, "init_process_group", lambda *a, **kw: calls.append((a, kw)))
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert par.init_multihost(None, backend="gloo") is False  # neither: one process
    if route == "coordinator":
        assert par.init_multihost("10.0.0.1:1234", 4, 2, backend="gloo", timeout_s=7) is True
        where = {"init_method": "tcp://10.0.0.1:1234", "world_size": 4, "rank": 2}
    else:
        monkeypatch.setenv("RANK", "1")
        monkeypatch.setenv("WORLD_SIZE", "2")
        monkeypatch.setenv("MASTER_ADDR", "localhost")
        monkeypatch.setenv("MASTER_PORT", "1234")
        assert par.init_multihost(backend="gloo", timeout_s=7) is True
        where = {"init_method": "env://"}
    assert calls == [(("gloo",), {"timeout": timedelta(seconds=7), **where})]
