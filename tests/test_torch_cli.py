"""The port's command lines parse what the JAX package's parse, each main
run with its app or runner replaced by a recorder:

- the pathfinder takes the hidden no-op --fast;
- the batch runner takes no videos, or --corpus, and then runs the
  reference clips (CORPUS_GLOB, the same pattern as JAX's); with no clips
  to run it exits with a usage error instead of starting no stream.
"""

import glob

import pytest

from hackathonopticalflow_tpu.apps import batch_runner as jbr
from hackathonopticalflow_tpu.apps import pathfinder as jpf
from hackathonopticalflow_tpu_torch.apps import batch_runner as tbr
from hackathonopticalflow_tpu_torch.apps import pathfinder as tpf


def _app_recorder(seen: list):
    class App:
        def __init__(self, cfg):
            seen.append(cfg)

        def run(self, **kw):
            return {"danger_counts": []}

        run_batched = run

    return App


@pytest.mark.parametrize("argv", [["clip.mp4", "--fast"], ["clip.mp4", "--fast", "--chunk", "4", "--step", "20"]])
def test_pathfinder_takes_fast(argv, monkeypatch):
    seen_j, seen_t = [], []
    monkeypatch.setattr(jpf, "PathfinderApp", _app_recorder(seen_j))
    monkeypatch.setattr(tpf, "PathfinderApp", _app_recorder(seen_t))
    jpf.main(argv)
    tpf.main(argv + ["--device", "cpu"])
    (j,), (t,) = seen_j, seen_t
    assert (t.video, t.step, t.lk.grid_step, t.device) == (j.video, j.step, j.lk.grid_step, "cpu")


@pytest.mark.parametrize("argv", [[], ["--corpus"], ["a.mp4", "--corpus"], ["a.mp4", "b.mp4"]])
def test_batch_runner_videos_and_corpus(argv, monkeypatch):
    corpus = ["/clips/b.mp4", "/clips/a.mp4"]
    monkeypatch.setattr(glob, "glob", lambda pattern: list(corpus) if pattern == tbr.CORPUS_GLOB else [])
    seen_j, seen_t = [], []
    monkeypatch.setattr(jbr, "run_batch", lambda cfg: seen_j.append(cfg) or {})
    monkeypatch.setattr(tbr, "run_batch", lambda cfg: seen_t.append(cfg) or {})
    jbr.main(argv)
    tbr.main(argv + ["--device", "cpu"])
    (j,), (t,) = seen_j, seen_t
    assert t.videos == j.videos
    assert t.videos == (sorted(corpus) if "--corpus" in argv or not argv else argv)


@pytest.mark.parametrize("argv", [[], ["--corpus"]])
def test_batch_runner_without_clips_exits(argv, monkeypatch, capsys):
    monkeypatch.setattr(glob, "glob", lambda pattern: [])
    monkeypatch.setattr(tbr, "run_batch", lambda cfg: pytest.fail("run_batch started with no streams"))
    with pytest.raises(SystemExit) as exc:
        tbr.main(argv + ["--device", "cpu"])
    assert exc.value.code == 2
    assert f"none match {tbr.CORPUS_GLOB}" in capsys.readouterr().err
