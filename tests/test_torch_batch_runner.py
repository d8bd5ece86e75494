"""The port's batch runner against the JAX package's, on cv2-written clips
of two streams (9 and 7 frames, so one stream ends first), at LKParams()
(the exact path, the JAX BatchRunnerConfig's default) in both and the port
on the CPU. Mirrors tests/test_apps.py's batch-runner tests:

- per-pair danger counts within 2% of the grid's points of JAX's
  run_batch (the exact path agrees to 1e-3 px, which can flip borderline
  points); each stream's counts equal its own lk_grid_flow_video scan;
- total_frames 8 + 6, the ended stream masked;
- run_batch_staged == run_batch exactly;
- checkpoint / resume and a double resume keep the "n_steps == index of
  prev" invariant; a rerun after every stream ended resumes from the last
  periodic checkpoint, as JAX's does;
- device="cuda" without CUDA raises; so does n_devices > 1 outside a
  world of ranks, and staged;
- `on_result`, at the benchmark's pathfinder configuration over three
  in-memory zoom clips of 7, 4 and 6 frames: every call's eight arrays
  equal the benchmark's plain reference (portbench/reference/lk_grid.py)
  on that stream alone, bit for bit; the calls come in step order and
  stop at a stream's end; every returned key but the times is the
  hook-less run's.
"""

import copy
import json
from unittest import mock

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from chip_smoke import ClipReader  # noqa: E402
from hackathonopticalflow_tpu.apps.batch_runner import BatchRunnerConfig as JConfig  # noqa: E402
from hackathonopticalflow_tpu.apps.batch_runner import run_batch as j_run_batch  # noqa: E402
from hackathonopticalflow_tpu_torch.apps import batch_runner as tbr  # noqa: E402
from hackathonopticalflow_tpu_torch.core import LKParams, measurement_grid  # noqa: E402
from hackathonopticalflow_tpu_torch.flow.lk_grid import lk_grid_flow_video  # noqa: E402
from hackathonopticalflow_tpu_torch.io.video import read_frames  # noqa: E402
from portbench.harness.clip import host_bgr, make_clip  # noqa: E402
from portbench.harness.grid_check import FIELDS  # noqa: E402
from portbench.harness.port import grid_params  # noqa: E402
from portbench.harness.spec import BENCH_DIR  # noqa: E402
from portbench.reference.image import bgr2gray_u8  # noqa: E402
from portbench.reference.lk_grid import LKGridReference  # noqa: E402

torch.set_num_threads(1)

H, W = 180, 320


def _make_clip(path: str, n: int, seed: int, h: int = H, w: int = W) -> None:
    """A blurred noise texture as tests/test_apps.py writes it, moved by a
    seeded random walk of 0-3 px a frame, so each pair's count is its own
    (a pair out of place shows)."""
    rng = np.random.RandomState(seed)
    pad = 3 * n + 8
    base = cv2.GaussianBlur(rng.uniform(40, 220, (h + pad, w + pad)).astype(np.uint8), (5, 5), 1.5)
    mover = cv2.GaussianBlur(rng.uniform(40, 220, (h + pad, w + pad)).astype(np.uint8), (5, 5), 1.5)
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 25.0, (w, h))
    assert vw.isOpened()
    cut = int(w * 0.6) // 16 * 16
    x = y = 4
    for _ in range(n):
        f = base[4 : 4 + h, 4 : 4 + w].copy()
        f[:, cut:] = mover[y : y + h, x + cut : x + w]
        vw.write(cv2.cvtColor(f, cv2.COLOR_GRAY2BGR))
        x += int(rng.randint(0, 4))
        y += int(rng.randint(0, 2))
    vw.release()


def _clips(tmp_path, lengths, seed0=7):
    paths = []
    for i, n in enumerate(lengths):
        p = str(tmp_path / f"clip{i}.mp4")
        _make_clip(p, n, seed0 + i)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    return _clips(tmp_path_factory.mktemp("clips"), (9, 7))


def _cfg(videos, **kw):
    return tbr.BatchRunnerConfig(videos=videos, lk=LKParams(), device="cpu", **kw)


@pytest.fixture(scope="module")
def streaming(clips):
    return tbr.run_batch(_cfg(clips))


def test_counts_match_jax(clips, streaming):
    want = j_run_batch(JConfig(videos=clips))
    n_pts = len(measurement_grid(H, W, 30))
    assert [len(c) for c in streaming["danger_counts"]] == [len(c) for c in want["danger_counts"]] == [8, 6]
    for got, ref in zip(streaming["danger_counts"], want["danger_counts"]):
        assert np.abs(np.array(got) - np.array(ref)).max() <= 0.02 * n_pts
    assert streaming["first_step"] == want["first_step"] == 0
    assert streaming["steps"] == want["steps"] == 8


def test_streams_equal_their_own_scans(clips, streaming):
    """Batched, each stream's counts are its own clip scan's `good` sums;
    the ended stream is masked (6 counts, not 8)."""
    pts = torch.from_numpy(measurement_grid(H, W, 30))
    for path, got in zip(clips, streaming["danger_counts"]):
        frames = np.stack(read_frames(path, range(len(got) + 1), gray=True))
        want = lk_grid_flow_video(torch.from_numpy(frames), pts, lk=LKParams(), device="cpu")
        assert got == want.good.sum(1).tolist()
    assert streaming["total_frames"] == 8 + 6 and streaming["streams"] == 2 and streaming["devices"] == 1
    assert streaming["mean_danger_per_stream"] == [float(np.mean(c)) for c in streaming["danger_counts"]]


def test_staged_equals_streaming(clips, streaming, monkeypatch):
    # chunks of 3 pairs: several chunks per stream, their one-frame
    # overlaps and a padded tail
    monkeypatch.setattr(tbr, "STAGED_CHUNK", 3)
    staged = tbr.run_batch_staged(_cfg(clips), reps=1)
    assert staged["danger_counts"] == streaming["danger_counts"]
    assert staged["total_frames"] == streaming["total_frames"] == 8 + 6


def test_checkpoint_resume(tmp_path):
    videos = _clips(tmp_path, (9, 9), seed0=3)
    full = tbr.run_batch(_cfg(videos, max_frames=8))
    ck = str(tmp_path / "br.ckpt.npz")
    part1 = tbr.run_batch(_cfg(videos, max_frames=4, checkpoint_path=ck, checkpoint_every=2))
    assert part1["steps"] == 3  # the checkpoint landed at step 2
    part2 = tbr.run_batch(_cfg(videos, max_frames=8, checkpoint_path=ck, checkpoint_every=2))
    assert part2["first_step"] == 3
    for i in range(2):
        assert part1["danger_counts"][i] == full["danger_counts"][i][:3]
        assert part2["danger_counts"][i] == full["danger_counts"][i][2:]


def test_resume_after_every_stream_ended_matches_jax(clips, streaming, tmp_path):
    """Both streams end before max_frames (after steps 6 and 8): no
    checkpoint is written at the end, so a rerun resumes from the last
    periodic one (step 6) as JAX's run_batch does."""
    runs = {}
    for name, run, cfg in (("port", tbr.run_batch, _cfg), ("jax", j_run_batch, lambda v, **kw: JConfig(videos=v, **kw))):
        kw = dict(max_frames=20, checkpoint_path=str(tmp_path / f"{name}.ckpt.npz"), checkpoint_every=3)
        runs[name] = [run(cfg(clips, **kw)) for _ in range(2)]
    n_pts = len(measurement_grid(H, W, 30))
    for got, want in zip(runs["port"], runs["jax"]):
        assert (got["steps"], got["first_step"]) == (want["steps"], want["first_step"])
        assert [len(c) for c in got["danger_counts"]] == [len(c) for c in want["danger_counts"]]
        for g, w in zip(got["danger_counts"], want["danger_counts"]):
            assert np.abs(np.array(g) - np.array(w)).max(initial=0) <= 0.02 * n_pts
    part1, part2 = runs["port"]
    assert part1["danger_counts"] == streaming["danger_counts"]
    assert (part2["first_step"], part2["steps"]) == (7, 2)
    assert part2["danger_counts"] == [streaming["danger_counts"][0][6:], []]


def test_double_resume(tmp_path):
    """A crash after a resume: the resumed run's checkpoints keep the
    n_steps == prev-frame-index invariant, so a second resume neither
    skips nor repeats a frame."""
    videos = _clips(tmp_path, (12, 12), seed0=11)
    full = tbr.run_batch(_cfg(videos, max_frames=11))
    assert any(len(set(c)) > 1 for c in full["danger_counts"])
    ck = str(tmp_path / "br2.ckpt.npz")
    kw = dict(checkpoint_path=ck, checkpoint_every=2)
    part1 = tbr.run_batch(_cfg(videos, max_frames=4, **kw))
    part2 = tbr.run_batch(_cfg(videos, max_frames=7, **kw))  # first resume
    part3 = tbr.run_batch(_cfg(videos, max_frames=11, **kw))  # second resume
    assert part2["first_step"] == 3
    assert part3["first_step"] == 7
    for i in range(2):
        assert part1["danger_counts"][i] == full["danger_counts"][i][:3]
        assert part2["danger_counts"][i] == full["danger_counts"][i][2:6]
        assert part3["danger_counts"][i] == full["danger_counts"][i][6:10]


def test_cuda_without_cuda_and_several_devices_raise(clips):
    with mock.patch.object(torch.cuda, "is_available", return_value=False):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tbr.run_batch(tbr.BatchRunnerConfig(videos=clips))
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tbr.run_batch_staged(tbr.BatchRunnerConfig(videos=clips))
    # several devices shard the streams over the ranks of a world
    # (tests/test_torch_parallel_ba.py); outside one, and staged, it raises
    with pytest.raises(ValueError, match="torch.distributed world"):
        tbr.run_batch(_cfg(clips, n_devices=2))
    with pytest.raises(ValueError, match="one device"):
        tbr.run_batch_staged(_cfg(clips, n_devices=2))


# ---- on_result ----

HOOK_LENGTHS = (7, 4, 6)  # frames a stream: stream 1 ends after 3 pairs, stream 2 after 5


@pytest.fixture(scope="module")
def hooked():
    """The benchmark's pathfinder configuration at H x W, three zoom clips
    from their own seeds as BGR, and run_batch over them without and with
    the hook: (config, clips, hook-less stats, stats, the hook's calls
    as (stream, pair, eight arrays))."""
    with open(BENCH_DIR / "configs" / "pathfinder-1080p.json") as f:
        cfg = copy.deepcopy(json.load(f))
    cfg.update(height=H, width=W)
    clips = [host_bgr(make_clip("cpu", H, W, n, 6, 1000 + i, 1.02)) for i, n in enumerate(HOOK_LENGTHS)]
    calls = []

    def keep(stream, pair, res):
        calls.append((stream, pair, [np.array(getattr(res, f)) for f in FIELDS]))

    return cfg, clips, _hook_run(cfg, clips, None), _hook_run(cfg, clips, keep), calls


def _hook_run(cfg, clips, hook, **kw):
    lk, norm, filt = grid_params(cfg)
    return tbr.run_batch(tbr.BatchRunnerConfig(
        videos=[str(i) for i in range(len(clips))], step=lk.grid_step, lk=lk, norm=norm, filt=filt,
        device="cpu", open_reader=lambda v: ClipReader(clips[int(v)]), on_result=hook, **kw))


def test_hook_results_equal_the_plain_reference_per_stream(hooked):
    cfg, clips, _, _, calls = hooked
    ref = LKGridReference(cfg, "cpu")
    assert len(calls) == sum(n - 1 for n in HOOK_LENGTHS)
    for stream, pair, got in calls:
        gray = [torch.from_numpy(bgr2gray_u8(clips[stream][i])) for i in (pair - 1, pair)]
        want = ref.pair(ref.prepare(gray[0]), ref.prepare(gray[1]))
        for name, g, w in zip(FIELDS, got, want):
            assert g.shape == w.shape and np.array_equal(g, w.numpy()), (stream, pair, name)


def test_hook_calls_come_in_step_order_and_stop_at_a_streams_end(hooked):
    *_, stats, calls = hooked
    want = [(s, k) for k in range(1, max(HOOK_LENGTHS)) for s in range(3) if k < HOOK_LENGTHS[s]]
    assert [(s, k) for s, k, _ in calls] == want
    assert [len(c) for c in stats["danger_counts"]] == [n - 1 for n in HOOK_LENGTHS]
    # a pair's count is its result's `good` sum
    for s, k, arrays in calls:
        assert stats["danger_counts"][s][k - 1] == int(arrays[FIELDS.index("good")].sum())


def test_hook_leaves_every_returned_key_unchanged(hooked):
    _, _, plain, stats, _ = hooked
    assert stats.keys() == plain.keys()
    for key in stats.keys() - {"wall_s", "aggregate_fps"}:
        assert stats[key] == plain[key], key
    assert stats["steps"] == max(HOOK_LENGTHS) - 1 and stats["total_frames"] == sum(HOOK_LENGTHS) - 3


def test_hook_pairs_go_on_from_the_checkpoint_after_a_resume(hooked, tmp_path):
    """A run cut after 3 steps (its checkpoint at step 2) and its resume:
    the resumed run's calls are numbered from pair 3 on, as the
    uninterrupted run's, each with that run's arrays."""
    cfg, clips, _, _, full = hooked
    ck = str(tmp_path / "hook.ckpt.npz")
    parts = []
    for max_frames in (4, None):
        calls = []
        _hook_run(cfg, clips, lambda s, k, res: calls.append((s, k, [np.array(getattr(res, f)) for f in FIELDS])),
                  max_frames=max_frames, checkpoint_path=ck, checkpoint_every=2)
        parts.append(calls)
    for part, want in zip(parts, ([c for c in full if c[1] <= 3], [c for c in full if c[1] >= 3])):
        assert [(s, k) for s, k, _ in part] == [(s, k) for s, k, _ in want]
        for (_, _, got), (_, _, arrays) in zip(part, want):
            assert all(np.array_equal(g, w) for g, w in zip(got, arrays))
