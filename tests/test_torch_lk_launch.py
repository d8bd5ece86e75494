"""The lk_level kernel's launch shapes, and what its integer sums assume.

`launch_shape` picks the kernel's team (warps per point, window pixels per
lane, and whether it walks a window past its slots) from the window;
csrc/lk_level.cu instantiates exactly the shapes of `LAUNCH_SHAPES` and the
walking `WALK_SHAPE`. The kernel sums A and b as integers (x 1024), exact on
the 1/32-grid templates and windows every caller hands it: these tests
hold the callers' templates to that grid and its bounds. The kernels
themselves run only on the GPU (tests/test_torch_cuda.py); here the
wrappers take their plain versions.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hackathonopticalflow_tpu_torch.core import TRACKER_LK, LKParams, measurement_grid
from hackathonopticalflow_tpu_torch.ops import lk as tlk
from hackathonopticalflow_tpu_torch.ops.lk_level import (
    LAUNCH_SHAPES,
    MAX_PIXELS,
    WALK_SHAPE,
    launch_shape,
    lk_level,
    lk_level_reference,
)
from hackathonopticalflow_tpu_torch.ops.patch_bilinear import patch_bilinear, patch_bilinear_reference

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "hackathonopticalflow_tpu_torch" / "csrc"

# every window of the repo's LK configurations and tests: the JAX
# package's and the port's defaults (45), the tracker's (15), the JAX
# tests' 21, the port's CPU tests' 5, and the GPU tests' windows (one per
# team shape)
REPO_WINDOWS = sorted(
    {LKParams().win_size, TRACKER_LK.win_size, (21, 21), (5, 5), (7, 7), (11, 11), (31, 31), (45, 21)}
)


@pytest.mark.parametrize("win", REPO_WINDOWS)
def test_launch_shape_covers_window(win):
    """The team's slots hold the window, with at most max(64, 2 x
    pixels) slots: at most half of them idle past 64."""
    warps, k, walk = launch_shape(*win)
    assert (warps, k) in LAUNCH_SHAPES and not walk
    slots, npix = 32 * warps * k, win[0] * win[1]
    assert npix <= slots <= max(64, 2 * npix)


def test_launch_shape_main_windows():
    """The tracker's 15 x 15 on 4 warps (2 px per lane); the sparse
    grid's 45 x 45 on 8 warps (8 px per lane); small windows on one or
    two warps."""
    assert launch_shape(15, 15) == (4, 2, False)
    assert launch_shape(45, 45) == (8, 8, False)
    assert launch_shape(45, 21) == (8, 4, False)
    assert launch_shape(7, 7) == (1, 2, False)
    assert launch_shape(11, 11) == (2, 2, False)


@pytest.mark.parametrize("win", [(46, 45), (46, 46), (64, 64), (91, 91), (MAX_PIXELS + 1, 1)])
def test_launch_shape_raises_past_budget(win):
    """Past the slots' budget the launch no longer raises: the walking
    shape takes any window (tests/test_torch_cuda.py holds it to the plain
    version at 46 x 46, 64 x 64 and 91 x 91)."""
    assert win[0] * win[1] > MAX_PIXELS
    assert launch_shape(*win) == (*WALK_SHAPE, True)


def test_launch_shapes_double_and_match_the_source():
    """Slots double from shape to shape, the last is the budget, and the
    CUDA source instantiates exactly these shapes and the walking one."""
    slots = [32 * w * k for w, k in LAUNCH_SHAPES]
    assert all(b == 2 * a for a, b in zip(slots, slots[1:]))
    assert slots[-1] == MAX_PIXELS
    src = (CSRC / "lk_level.cu").read_text()
    shapes = {(int(w), int(k)) for w, k in re.findall(r"^\s*LK_SHAPE\((\d+), (\d+)\)\s*$", src, re.M)}
    assert shapes == set(LAUNCH_SHAPES)
    walks = {(int(w), int(k)) for w, k in re.findall(r"^\s*LK_WALK\((\d+), (\d+)\)\s*$", src, re.M)}
    assert walks == {WALK_SHAPE}


def test_cpu_path_unchanged_past_budget():
    """On CPU tensors lk_level runs its plain version, any window size
    included, and launches nothing."""
    g = torch.Generator().manual_seed(1)
    n, win, m = 3, 50, 2
    tmpl = torch.floor(torch.rand((n, 3, win, win), generator=g) * 32 * 50) / 32
    plane = torch.floor(torch.rand((70, 70), generator=g) * 255)
    kw = dict(m=m, win_w=win, win_h=win, level_w=60, level_h=60, max_iters=3,
              eps2=9e-4, is_level0=True, min_eig_threshold=1e-4)
    tl0 = torch.full((n, 2), 7.25)
    org = torch.floor(tl0).to(torch.int32) - m
    st = torch.ones(n, dtype=torch.bool)
    before = lk_level.launches
    out = lk_level(tmpl, plane, 5, tl0, org, st, **kw)
    ref = lk_level_reference(tmpl, plane, 5, tl0, org, st, **kw)
    assert lk_level.launches == before
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


@pytest.mark.parametrize("c", [1, 3, 64])
def test_patch_bilinear_any_channel_count(c):
    """No shared-memory staging: any channel count at window 45 (64
    crops of 46 x 46 exceeded a block's shared memory before); on the CPU,
    the plain version."""
    rng = np.random.RandomState(c)
    planes = torch.from_numpy(rng.uniform(0, 255, (c, 60, 70)).astype(np.float32))
    tl = torch.from_numpy(rng.uniform(-10, 30, (5, 2)).astype(np.float32))
    before = patch_bilinear.launches
    got = patch_bilinear(planes, tl, 45, 45, True)
    assert patch_bilinear.launches == before
    assert got.shape == (5, c, 45, 45)
    assert torch.equal(got, patch_bilinear_reference(planes, tl, 45, 45, True))


def _frames(h=120, w=200):
    """u8 frames a, b of a smoothed noise texture stretched to 0-255, b
    shifted by (+4, -3) px."""
    rng = np.random.RandomState(3)
    sm = rng.uniform(0, 255, (h + 20, w + 20))
    for _ in range(3):
        p = np.pad(sm, 1, mode="reflect")
        sm = (p[:-2, 1:-1] + 2 * p[1:-1, 1:-1] + p[2:, 1:-1]) / 4
        p = np.pad(sm, 1, mode="reflect")
        sm = (p[1:-1, :-2] + 2 * p[1:-1, 1:-1] + p[1:-1, 2:]) / 4
    # full contrast, so the gradients reach far into their range
    sm = (sm - sm.min()) / (sm.max() - sm.min()) * 255
    a = np.floor(sm + 0.5).astype(np.uint8)
    return torch.from_numpy(a[10 : 10 + h, 10 : 10 + w].copy()), torch.from_numpy(a[7 : 7 + h, 14 : 14 + w].copy())


@pytest.mark.parametrize("geometry", ["grid", "point"])
@pytest.mark.parametrize("win", [(45, 45), (15, 15), (21, 21), (45, 21)])
def test_callers_templates_on_the_kernel_grid(geometry, win):
    """What the kernel's integer sums need, at every level: templates on
    the 1/32 grid, 32 x gradients within +-4080, 32 x image values in
    [0, 8160], and the level plane's values in [0, 255]."""
    a, b = _frames()
    if geometry == "grid":
        params = dataclasses.replace(LKParams(grid_step=30, compute_err=False), win_size=win)
    else:
        params = dataclasses.replace(TRACKER_LK, win_size=win)
    prev, nxt = tlk.prepare_frame(a, params), tlk.prepare_frame(b, params)
    pts_np = measurement_grid(*a.shape, 30)
    pts = torch.from_numpy(pts_np)
    grid_xy = (np.unique(pts_np[:, 0]).astype(int), np.unique(pts_np[:, 1]).astype(int))
    for level in range(params.max_level, -1, -1):
        center = pts * float(2.0**-level)
        if geometry == "grid":
            args, _ = tlk.level_inputs(prev, nxt, grid_xy, center, level, params)
        else:
            args, _, _ = tlk.point_level_inputs(prev, nxt, pts, center, level, params)
        tmpl, plane = args[0], args[1]
        x32 = tmpl.double() * 32
        assert torch.equal(x32, torch.round(x32)), level
        assert float(x32[:, 0].min()) >= 0 and float(x32[:, 0].max()) <= 8160
        assert float(x32[:, 1:].abs().max()) <= 4080
        assert float(plane.min()) >= 0 and float(plane.max()) <= 255
