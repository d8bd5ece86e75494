"""The port's distributed bundle adjustment, its batch runner over several
ranks and its multi-rank dry run, against the JAX package's shard_map
functions on 4 of the 8 virtual CPU devices and the port's single-device
functions.

One world of 4 gloo ranks on the CPU runs the port side
(tests/torch_parallel_ranks.py::ba_batch_checks) under a 60 s deadline:

- distributed_bundle_adjust (64 landmarks, 16 a rank) and
  ring_bundle_adjust (8 keyframes, 2 a rank), on tests/test_pose_ba.py's
  scenes, against JAX's distributed and ring results and the port's
  bundle_adjust at tests/test_pose_ba.py's bounds (rvecs and tvecs 1e-4,
  points 1e-3, cost 1e-3 relative, n_obs equal); the replicated poses
  identical on every rank. In float64 at test_pose_ba's 8 iterations
  (JAX's in x64), where the port's ring also meets JAX's ring and the
  port's single solve to 1e-9; in float32, the GPU's type, at 4: from the
  5th iteration on, the ring scene's converged steps are accepted or
  rejected on float32 rounding, and any two float32 solvers part by up to
  4e-4 there (JAX's own ring on one device against its bundle_adjust at 8
  iterations: 2.1e-4);
- run_batch with n_devices=2 (ranks 2 and 3 idle) on in-memory streams,
  equal on every rank to the n_devices=1 run: a full run of streams of 9
  and 7 frames, a checkpointed run cut by max_frames and its resume, and
  resumes after one rank's stream ended before the other's was cut (at a
  checkpoint step and between two) and after both ended; with the hook
  set on the ranks and not on the one device, and the hook called on the
  rank that runs each stream, once a pair;
- dryrun_multichip(4, device="cpu") in a world of its own.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_parallel_ranks as ranks
from hackathonopticalflow_tpu.nav import ba as jba
from hackathonopticalflow_tpu.parallel.ba_dist import distributed_bundle_adjust as j_distributed_bundle_adjust
from hackathonopticalflow_tpu.parallel.ba_ring import ring_bundle_adjust as j_ring_bundle_adjust
from hackathonopticalflow_tpu.parallel.mesh import make_mesh as j_make_mesh
from hackathonopticalflow_tpu_torch import parallel as par
from hackathonopticalflow_tpu_torch.core import LKParams
from hackathonopticalflow_tpu_torch.entry import dryrun_multichip
from hackathonopticalflow_tpu_torch.nav.ba import BAState, bundle_adjust
from test_torch_pose_ba import _synthetic_ba
from test_torch_prepare import smooth_texture

torch.set_num_threads(1)

LK = LKParams(grid_step=30, compute_err=False)
H, W = 144, 256

#: stream lengths and the runs in order (BatchRunnerConfig fields; "ck"
#: stands for a checkpoint file per scenario and device count)
SCENARIOS = {
    "full": ((9, 7), [{}]),
    # cut by max_frames at a checkpoint, then resumed
    "resume": ((9, 9), [{"max_frames": 4, "checkpoint_path": "ck", "checkpoint_every": 2},
                        {"max_frames": 8, "checkpoint_path": "ck", "checkpoint_every": 2}]),
    # the first stream ends (after step 4) before the second is cut at a
    # checkpoint (step 6, checkpoints every 3 steps)
    "ended": ((5, 9), [{"max_frames": 7, "checkpoint_path": "ck", "checkpoint_every": 3},
                       {"checkpoint_path": "ck", "checkpoint_every": 3}]),
    # the first stream ends (after step 4) past the last checkpoint (step
    # 3) and the second is cut between checkpoints (step 5)
    "between": ((5, 9), [{"max_frames": 6, "checkpoint_path": "ck", "checkpoint_every": 3},
                         {"checkpoint_path": "ck", "checkpoint_every": 3}]),
    # every stream ends before max_frames (after steps 4 and 6), the last
    # checkpoint at step 4
    "finished": ((5, 7), [{"max_frames": 20, "checkpoint_path": "ck", "checkpoint_every": 4},
                          {"max_frames": 20, "checkpoint_path": "ck", "checkpoint_every": 4}]),
}


def _stream(seed: int, n: int) -> np.ndarray:
    """(n, H, W) uint8: a smooth texture walked 0-3 px a frame."""
    sm = smooth_texture(seed, H + 3 * n + 8, W + 3 * n + 8)
    rng = np.random.RandomState(seed)
    x = y = 4
    frames = []
    for _ in range(n):
        frames.append(np.floor(sm[y : y + H, x : x + W] + 0.5).astype(np.uint8))
        x += int(rng.randint(0, 4))
        y += int(rng.randint(0, 3))
    return np.stack(frames)


def _batch_calls(tmp: str, n_devices: int) -> list:
    """[(streams, runs)] of every scenario at n_devices."""
    calls = []
    for i, (name, (lengths, runs)) in enumerate(SCENARIOS.items()):
        streams = {f"{name}{j}": _stream(10 * i + j, n) for j, n in enumerate(lengths)}
        ck = f"{tmp}/{name}-n{n_devices}.ckpt.npz"
        calls.append((streams, [{**kw, "lk": LK, "n_devices": n_devices,
                                 **({"checkpoint_path": ck} if "checkpoint_path" in kw else {})} for kw in runs]))
    return calls


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return str(tmp_path_factory.mktemp("batch"))


#: (solver, dtype, iterations) of the BA checks
BA_CASES = [("dist", "float64", 8), ("ring", "float64", 8), ("dist", "float32", 4), ("ring", "float32", 4)]


def _ba_scene(name: str, dtype: str):
    """test_pose_ba.py's scenes: its distributed one (4 keyframes, 64
    landmarks) and its ring one (8 keyframes, 48 landmarks)."""
    arrs = _synthetic_ba(l=64) if name == "dist" else _synthetic_ba(m=8, l=48)
    return tuple(a.astype(dtype) if a.dtype == np.float32 else a for a in arrs)


@pytest.fixture(scope="module")
def world(tmp):
    """One 4-rank gloo world on the CPU: the BA cases, then every batch
    scenario at n_devices=2."""
    inp = {"ba": [(name, iters, _ba_scene(name, dtype)) for name, dtype, iters in BA_CASES],
           "batch": _batch_calls(tmp, 2)}
    return par.run_on_mesh(ranks.ba_batch_checks, 4, (inp,), device="cpu", timeout_s=60)


def _close(got, want, stats_got, stats_want, tight: bool):
    """tests/test_pose_ba.py's bounds; 1e-9 (relative for the cost) where
    tight."""
    pose, pts, cost = (1e-9, 1e-9, 1e-9) if tight else (1e-4, 1e-3, 1e-3)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), rtol=0, atol=pose)
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]), rtol=0, atol=pose)
    np.testing.assert_allclose(np.asarray(got[2]), np.asarray(want[2]), rtol=0, atol=pts)
    c, cw = float(stats_got.cost), float(stats_want.cost)
    assert abs(c - cw) < cost * max(cw, 1.0), (c, cw)
    assert int(stats_got.n_obs) == int(stats_want.n_obs)


@pytest.mark.parametrize("case", range(len(BA_CASES)), ids=["-".join(map(str, c)) for c in BA_CASES])
def test_distributed_ba_matches_jax_and_single(world, case):
    name, dtype, iters = BA_CASES[case]
    arrs = _ba_scene(name, dtype)
    results = [w["ba"][case] for w in world]
    rv0, tv0, _, stats = results[0]
    for rv, tv, _, st in results:  # the replicated poses agree bit for bit
        assert torch.equal(rv, rv0) and torch.equal(tv, tv0) and torch.equal(st.cost, stats.cost)
    if name == "dist":
        points = torch.cat([r[2] for r in results])  # each rank's landmark shard
    else:
        points = results[0][2]
        assert all(torch.equal(r[2], points) for r in results)
    assert rv0.dtype == getattr(torch, dtype)
    got = (rv0, tv0, points)
    with jax.enable_x64(dtype == "float64"):
        jstate = jba.BAState(*(jnp.asarray(a) for a in arrs))
        if name == "dist":
            mesh = j_make_mesh((4,), ("tile",))
            jout, jstats = jax.jit(lambda s: j_distributed_bundle_adjust(s, mesh, "tile", iters=iters))(jstate)
        else:
            mesh = j_make_mesh((4,), ("win",))
            jout, jstats = jax.jit(lambda s: j_ring_bundle_adjust(s, mesh, "win", iters=iters))(jstate)
        want = tuple(np.asarray(x) for x in (jout.rvecs, jout.tvecs, jout.points))
        assert want[0].dtype == np.dtype(dtype)
    _close(got, want, stats, jstats, tight=False)
    single, sstats = bundle_adjust(BAState(*map(torch.from_numpy, arrs)), iters=iters)
    _close(got, (single.rvecs, single.tvecs, single.points), stats, sstats, tight=False)
    if dtype == "float64":
        _close(got, want, stats, jstats, tight=True)
        _close(got, (single.rvecs, single.tvecs, single.points), stats, sstats, tight=True)
    assert float(stats.cost) < 0.05 * float(stats.initial_cost)


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_run_batch_on_two_ranks_equals_one_device(world, tmp, scenario):
    i = list(SCENARIOS).index(scenario)
    streams, runs = _batch_calls(tmp, 1)[i]
    want = ranks.batch_runs("cpu", streams, runs)
    timing = ("wall_s", "aggregate_fps", "devices")
    for w in world:  # every rank returns the gathered result
        got = w["batch"][i]
        assert len(got) == len(want)
        for g, e in zip(got, want):
            assert g["devices"] == 2 and e["devices"] == 1
            assert {k: v for k, v in g.items() if k not in timing} == {k: v for k, v in e.items() if k not in timing}
    # rank r < 2 runs stream r: its hook calls are that stream's pairs in
    # order, each the pair's count, a resumed run's numbered on from its
    # checkpoint's pair; the idle ranks are called for nothing
    for r, w in enumerate(world):
        want_calls = [] if r >= 2 else [(j, r, k, c) for j, e in enumerate(want)
                                         for k, c in enumerate(e["danger_counts"][r], max(e["first_step"], 1))]
        assert w["calls"][i] == want_calls, r
    if scenario == "resume":
        part1, part2 = want
        assert part1["steps"] == 3 and part2["first_step"] == 3
    if scenario == "ended":
        part1, part2 = want
        assert [len(c) for c in part1["danger_counts"]] == [4, 6]
        assert [len(c) for c in part2["danger_counts"]] == [0, 2]
    if scenario == "between":
        part1, part2 = want
        assert [len(c) for c in part1["danger_counts"]] == [4, 5]
        assert [len(c) for c in part2["danger_counts"]] == [1, 5]
        assert part2["first_step"] == 4 and part2["steps"] == 5
    if scenario == "finished":
        part1, part2 = want
        assert [len(c) for c in part1["danger_counts"]] == [4, 6]
        assert [len(c) for c in part2["danger_counts"]] == [0, 2]
        assert part2["first_step"] == 5 and part2["steps"] == 2


def test_dryrun_multichip_cpu():
    out = dryrun_multichip(4, device="cpu", timeout_s=60)
    assert len(out) == 4
    for r in out:
        assert all(np.isfinite(v) for k, v in r.items() if k != "launches")
        assert r["launches"] == {"lk_level": 0, "patch_bilinear": 0, "warp_bilinear": 0}  # plain versions
        assert r["ba_dist_cost"] <= 1.01 * r["ba_dist_initial_cost"]
        assert r["ba_ring_cost"] <= 1.01 * r["ba_ring_initial_cost"]
    # a stream's two tiles share its sparse flow; the quantile is per stream
    assert out[0]["sparse_modulus"] == out[1]["sparse_modulus"] and out[0]["q99"] == out[1]["q99"]
