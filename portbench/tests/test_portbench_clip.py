"""The clip, its loop and the readers that hand it to the port."""

import math

import numpy as np
import pytest
import torch

import portbench_tiny  # noqa: F401  (puts the repository root on sys.path)
from portbench.harness.clip import LoopReader, PacedReader, host_bgr, loop_index, make_clip, pair_at, stream_seed


@pytest.mark.parametrize("n", [2, 3, 5, 31])
def test_loop_gives_only_real_zoom_pairs(n):
    # forwards then backwards, over and over: every pair is one zoom step
    # in or out, never a repeated frame and never a jump
    seen = set()
    for k in range(1, 6 * n):
        a, b = pair_at(k, n)
        assert abs(a - b) == 1
        assert 0 <= a < n and 0 <= b < n
        seen.add((a, b))
    assert len(seen) == 2 * (n - 1)
    assert [loop_index(p, n) for p in range(2 * n - 1)] == list(range(n)) + list(range(n - 2, -1, -1))


def test_clip_frames_zoom_about_the_centre_and_follow_the_seed():
    a = make_clip("cpu", 40, 64, 3, 2, stream_seed(2**31 + 5, 0), 1.05)
    b = make_clip("cpu", 40, 64, 3, 2, stream_seed(2**31 + 5, 0), 1.05)
    c = make_clip("cpu", 40, 64, 3, 2, stream_seed(2**31 + 5, 1), 1.05)
    assert a.dtype == torch.uint8 and a.shape == (3, 40, 64)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a[0], a[1])
    bgr = host_bgr(a)
    assert bgr.shape == (3, 40, 64, 3) and np.array_equal(bgr[..., 2], a.numpy())


def test_stream_seeds_differ_and_take_large_seeds():
    seeds = {stream_seed(s, i) for s in (0, 2**31 + 3, 2**40) for i in range(4)}
    assert len(seeds) == 12
    assert all(0 <= s < 2**63 for s in seeds)


class FakeClock:
    def __init__(self, t=100.0):
        self.t = t
        self.slept = []

    def __call__(self):
        return self.t

    def sleep(self, dt):
        self.slept.append(dt)
        self.t += dt


def test_loop_reader_stops_at_the_deadline_and_the_limit():
    bgr = np.zeros((4, 2, 3, 3), np.uint8)
    bgr[:, 0, 0, 0] = np.arange(4)
    clock = FakeClock()
    r = LoopReader(bgr, deadline=101.0, clock=clock)
    got = []
    for _ in range(7):
        got.append(int(r.read()[0, 0, 0]))
    assert got == [0, 1, 2, 3, 2, 1, 0]
    clock.t = 101.0
    assert r.read() is None
    lim = LoopReader(bgr, limit=2)
    assert lim.read() is not None and lim.read() is not None and lim.read() is None
    assert (r.height, r.width) == (2, 3)


def test_paced_reader_keeps_due_times_and_stops_at_the_deadline():
    bgr = np.zeros((3, 2, 2, 3), np.uint8)
    clock = FakeClock(10.0)
    r = PacedReader(bgr, t0=10.0, fps=50.0, deadline=10.1, clock=clock, sleep=clock.sleep)
    frames = []
    while (f := r.read()) is not None:
        frames.append(f)
    # due at 10.00, 10.02, ..., 10.08; 10.10 is at the deadline
    assert len(frames) == 5
    assert np.allclose(r.due, [10.0 + i / 50.0 for i in range(5)])
    assert np.allclose(r.released, r.due)
    assert math.isclose(sum(clock.slept), 0.08)
    # a reader behind the camera gets the overdue frame at once
    late = PacedReader(bgr, t0=0.0, fps=50.0, deadline=1.0, clock=FakeClock(0.5), sleep=pytest.fail)
    assert late.read() is not None and late.released[0] - late.due[0] == pytest.approx(0.5)
