"""The port's CUDA kernels against their plain versions on the GPU.

These tests need a CUDA GPU and nvcc; elsewhere they skip. The file
imports no jax, so on a machine without jax it runs without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import sample_texture, smooth_texture, tracker_points

from hackathonopticalflow_tpu_torch.core import (
    TRACKER_LK,
    FarnebackParams,
    FeatureParams,
    LKParams,
    TrackerParams,
    measurement_grid,
)
from hackathonopticalflow_tpu_torch.flow import dense as tdense
from hackathonopticalflow_tpu_torch.flow import tracker as ttr
from hackathonopticalflow_tpu_torch.ops import farneback as tfb
from hackathonopticalflow_tpu_torch.ops import lk as tlk
from hackathonopticalflow_tpu_torch.ops import patch as tpatch
from hackathonopticalflow_tpu_torch.ops.gather_rects import gather_rects, gather_rects_reference
from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level, lk_level_reference
from hackathonopticalflow_tpu_torch.ops.patch_bilinear import patch_bilinear, patch_bilinear_reference
from hackathonopticalflow_tpu_torch.ops.warp_bilinear import warp_bilinear, warp_bilinear_reference

PARAMS = LKParams(grid_step=30, compute_err=False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _frames(n, h=270, w=480, dx=5, dy=3):
    """n u8 frames of a smoothed noise texture, frame t (x, y) = frame 0
    (x + t dx, y + t dy)."""
    sm = np.random.RandomState(7).uniform(0, 255, (h + 100, w + 100))
    for _ in range(4):
        p = np.pad(sm, 1, mode="reflect")
        sm = 0.25 * p[:-2, 1:-1] + 0.5 * p[1:-1, 1:-1] + 0.25 * p[2:, 1:-1]
        sm = 0.25 * sm[:, :-2] + 0.5 * sm[:, 1:-1] + 0.25 * sm[:, 2:]
    sm = np.clip(np.floor(sm + 0.5), 0, 255).astype(np.uint8)
    return [sm[50 + t * dy : 50 + t * dy + h, 50 + t * dx : 50 + t * dx + w] for t in range(n)]


def _pair(h=270, w=480, dx=5, dy=3):
    """u8 frames a, b of a smoothed noise texture, b(x, y) = a(x+dx, y+dy)."""
    return _frames(2, h, w, dx, dy)


@pytest.mark.cuda
@pytest.mark.parametrize("level", [2, 1, 0])
def test_lk_level_kernel_matches_plain(cuda_device, level):
    """Status and top-lefts identical: both sum exactly in float64 and
    blend without FMA contraction, so any difference is a fault."""
    a, b = _pair()
    pts = measurement_grid(*a.shape, PARAMS.grid_step)
    grid_xy = (np.unique(pts[:, 0]).astype(int), np.unique(pts[:, 1]).astype(int))
    prev = tlk.prepare_frame(torch.from_numpy(a).to(cuda_device), PARAMS)
    nxt = tlk.prepare_frame(torch.from_numpy(b).to(cuda_device), PARAMS)
    center = torch.from_numpy(pts).to(cuda_device) * float(2.0 ** (level - PARAMS.max_level))
    args, statics = tlk.level_inputs(prev, nxt, grid_xy, center, level, PARAMS)
    status = torch.ones(pts.shape[0], dtype=torch.bool, device=cuda_device)
    before = lk_level.launches
    tl_k, st_k = lk_level(*args, status, **statics)
    torch.cuda.synchronize()
    assert lk_level.launches == before + 1
    tl_p, st_p = lk_level_reference(*args, status, **statics)
    assert torch.equal(st_k, st_p)
    assert torch.equal(tl_k, tl_p)


@pytest.mark.cuda
@pytest.mark.parametrize("hw", [(90, 160), (361, 643)])
def test_warp_bilinear_kernel_matches_plain(cuda_device, hw):
    """Identical over every pixel, inside the frame and past its borders:
    both round every product and sum alike (no FMA contraction)."""
    h, w = hw
    rng = np.random.RandomState(h)
    src = torch.from_numpy(rng.randn(2, 5, h, w).astype(np.float32) * 100).to(cuda_device)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx = torch.from_numpy(xx + rng.uniform(-8, 8, (2, h, w)).astype(np.float32)).to(cuda_device)
    fy = torch.from_numpy(yy + rng.uniform(-8, 8, (2, h, w)).astype(np.float32)).to(cuda_device)
    before = warp_bilinear.launches
    out = warp_bilinear(src, fx, fy)
    torch.cuda.synchronize()
    assert warp_bilinear.launches == before + 1
    assert torch.equal(out, warp_bilinear_reference(src, fx, fy))


@pytest.mark.cuda
def test_farneback_video_kernel_path_matches_plain(cuda_device):
    """2 pairs of the dense scan through the kernel equal the plain path's:
    the rest of the path is the same ops on the same inputs."""
    params = FarnebackParams()
    clip = torch.from_numpy(np.stack(_frames(3, 144, 256, 1, 1))).to(cuda_device)
    before = warp_bilinear.launches
    got = tdense.farneback_flow_video(clip, params, device=cuda_device)
    torch.cuda.synchronize()
    assert warp_bilinear.launches - before == 2 * params.iterations * (params.levels + 1)
    with mock.patch.object(tfb, "warp_bilinear", warp_bilinear_reference):
        want = tdense.farneback_flow_video(clip, params, device=cuda_device)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 1])
@pytest.mark.parametrize("quantize", [True, False])
def test_patch_bilinear_kernel_matches_plain(cuda_device, c, quantize):
    """Identical windows, in range and beyond the plane's edges (wrapped
    and clamped origins): both round every product and sum alike."""
    rng = np.random.RandomState(c)
    planes = torch.from_numpy(rng.uniform(-300, 300, (c, 300, 500)).astype(np.float32)).to(cuda_device)
    tl = torch.from_numpy(rng.uniform(-40, 540, (256, 2)).astype(np.float32)).to(cuda_device)
    before = patch_bilinear.launches
    got = patch_bilinear(planes, tl, 15, 15, quantize)
    torch.cuda.synchronize()
    assert patch_bilinear.launches == before + 1
    assert torch.equal(got, patch_bilinear_reference(planes, tl, 15, 15, quantize))


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["lanes", "v1"])
@pytest.mark.parametrize("level", [2, 1, 0])
def test_lk_level_points_kernel_matches_plain(cuda_device, geometry, level):
    """The tracker's level in both crop geometries, points in the clipped
    edge band included: status and top-lefts identical."""
    params = TRACKER_LK if geometry == "lanes" else LKParams(win_size=(15, 15), slab_margin=8)
    a, b = _pair()
    pts = torch.from_numpy(tracker_points(*a.shape, 256)).to(cuda_device)
    prev = tlk.prepare_frame(torch.from_numpy(a).to(cuda_device), params)
    nxt = tlk.prepare_frame(torch.from_numpy(b).to(cuda_device), params)
    center = pts * float(2.0**-level)
    args, statics, _ = tlk.point_level_inputs(prev, nxt, pts, center, level, params)
    status = torch.ones(pts.shape[0], dtype=torch.bool, device=cuda_device)
    before = lk_level.launches
    tl_k, st_k = lk_level(*args, status, **statics)
    torch.cuda.synchronize()
    assert lk_level.launches == before + 1
    tl_p, st_p = lk_level_reference(*args, status, **statics)
    assert torch.equal(st_k, st_p)
    assert torch.equal(tl_k, tl_p)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [True, False])
def test_tracker_kernel_path_matches_plain(cuda_device, lanes):
    """3 tracker steps through both kernels equal the plain path's."""
    lk = dataclasses.replace(TRACKER_LK, points_lanes=lanes)
    params = TrackerParams(lk=lk, max_tracks=64, features=FeatureParams(max_candidates=256))
    clip = torch.from_numpy(np.stack(_frames(4, 144, 256, 2, 1))).to(cuda_device)
    s0 = ttr.track_step(ttr.init_tracker(params), clip[0], clip[0], params, device=cuda_device)
    before = (lk_level.launches, patch_bilinear.launches)
    got, hist = ttr.track_video(clip, params, s0, device=cuda_device)
    torch.cuda.synchronize()
    assert lk_level.launches - before[0] == 3 * 6 and patch_bilinear.launches - before[1] == 3 * 8
    with mock.patch.object(tlk, "lk_level", lk_level_reference), \
            mock.patch.object(tpatch, "patch_bilinear", patch_bilinear_reference):
        want, want_hist = ttr.track_video(clip, params, s0, device=cuda_device)
    for name in ("traj", "length", "alive"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    for g, w in zip(hist, want_hist):
        assert torch.equal(g, w)


def _lattice_pair(dev, dx, dy, h=270, w=480):
    """u8 frames a, b with b(x, y) = a(x + dx, y + dy) of chip_smoke.py's
    lattice texture, on which LK follows a 40 px shift down the pyramid."""
    lat = smooth_texture(torch.Generator().manual_seed(3), dev, h + 2 * abs(dy) + 60, w + 2 * abs(dx) + 60)
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=dev),
        torch.arange(w, dtype=torch.float64, device=dev),
        indexing="ij",
    )
    frame = lambda ox, oy: torch.floor(sample_texture(lat, xx + ox, yy + oy) + 0.5).to(torch.uint8)
    return frame(0, 0), frame(dx, dy)


GRID_CONFIGS = {
    "blocked": dataclasses.replace(PARAMS, grid_kernel="blocked"),
    "no_rescue": dataclasses.replace(PARAMS, rescue_large=False),
    "rescue_levels_1": dataclasses.replace(PARAMS, rescue_levels=1),
    "exact": LKParams(compute_err=False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("config", sorted(GRID_CONFIGS))
def test_lk_level_new_geometries_kernel_match_plain(cuda_device, config):
    """The grid-anchored crops (three configurations) and the exact
    geometry at every level of a (+40, +3) pair, points frozen at level 0
    included: status and top-lefts identical."""
    params = GRID_CONFIGS[config]
    a, b = _lattice_pair(cuda_device, 40, 3)
    pts_np = measurement_grid(*a.shape, 30)
    pts = torch.from_numpy(pts_np).to(cuda_device)
    grid_xy = (np.unique(pts_np[:, 0]).astype(int), np.unique(pts_np[:, 1]).astype(int))
    prev = tlk.prepare_frame(a, params)
    nxt = tlk.prepare_frame(b, params)
    center = pts * 0.25
    status = torch.ones(pts.shape[0], dtype=torch.bool, device=cuda_device)
    frozen = 0
    for level in (2, 1, 0):
        if level != 2:
            center = center * 2.0
        if config == "exact":
            args, kw, _ = tlk.point_level_inputs(prev, nxt, pts, center, level, params)
        else:
            args, kw = tlk.level_inputs(prev, nxt, grid_xy, center, level, params)
        before = lk_level.launches
        tl_k, st_k = lk_level(*args, status, **kw)
        torch.cuda.synchronize()
        assert lk_level.launches == before + 1
        tl_p, st_p = lk_level_reference(*args, status, **kw)
        assert torch.equal(st_k, st_p), level
        assert torch.equal(tl_k, tl_p), level
        if kw.get("active0") is not None and level == 0:
            frozen = int((~kw["active0"]).sum())
        center, status = tl_p + tlk._halfwin(params, cuda_device), st_p
    if config in ("blocked", "no_rescue"):
        assert frozen > 0


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [None, 3])
def test_gather_rects_kernel_matches_plain(cuda_device, channels):
    """Identical rects, in bounds and off the plane (wrapped and clamped
    origins)."""
    rng = np.random.RandomState(9)
    shape = (300, 500) if channels is None else (channels, 300, 500)
    img = torch.from_numpy(rng.uniform(-300, 300, shape).astype(np.float32)).to(cuda_device)
    tl = torch.from_numpy(rng.randint(-200, 600, (512, 2)).astype(np.int32)).to(cuda_device)
    before = gather_rects.launches
    got = gather_rects(img, tl, 118, 128)
    torch.cuda.synchronize()
    assert gather_rects.launches == before + 1
    assert torch.equal(got, gather_rects_reference(img, tl, 118, 128))


# one LK configuration per lk_level geometry, at any window
WINDOW_GEOMETRIES = {
    "centred": lambda win: dataclasses.replace(PARAMS, win_size=win),
    "anchored": lambda win: dataclasses.replace(PARAMS, win_size=win, grid_kernel="blocked"),
    "v1": lambda win: LKParams(win_size=win, slab_margin=8, compute_err=False),
    "exact": lambda win: LKParams(win_size=win, compute_err=False),
}


def _levels_match_plain(dev, params, a, b, geometry, top=None):
    """Runs every level of `params` on frames a -> b (grid points, or the
    tracker's points with edge bands on the point paths), each level
    through lk_level and its plain version from the plain version's
    inputs: status and top-lefts identical, and the geometry the one
    asked for (`top` at the top level, where given)."""
    if params.grid_step is not None:
        pts_np = measurement_grid(*a.shape, params.grid_step)
        pts = torch.from_numpy(pts_np).to(dev)
        grid_xy = (np.unique(pts_np[:, 0]).astype(int), np.unique(pts_np[:, 1]).astype(int))
    else:
        pts = torch.from_numpy(tracker_points(*a.shape, 256)).to(dev)
    prev = tlk.prepare_frame(torch.as_tensor(a).to(dev), params)
    nxt = tlk.prepare_frame(torch.as_tensor(b).to(dev), params)
    center = pts * float(2.0**-params.max_level)
    status = torch.ones(pts.shape[0], dtype=torch.bool, device=dev)
    for level in range(params.max_level, -1, -1):
        if level != params.max_level:
            center = center * 2.0
        if params.grid_step is not None:
            args, kw = tlk.level_inputs(prev, nxt, grid_xy, center, level, params)
        else:
            args, kw, _ = tlk.point_level_inputs(prev, nxt, pts, center, level, params)
        want = top if top is not None and level == params.max_level else geometry
        assert kw["geometry"] == want or (geometry == "centred" and level == params.max_level)
        before = lk_level.launches
        tl_k, st_k = lk_level(*args, status, **kw)
        torch.cuda.synchronize()
        assert lk_level.launches == before + 1
        tl_p, st_p = lk_level_reference(*args, status, **kw)
        assert torch.equal(st_k, st_p), level
        assert torch.equal(tl_k, tl_p), level
        center, status = tl_p + tlk._halfwin(params, dev), st_p


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ["shift_5_3", "lattice_40_3"])
@pytest.mark.parametrize("geometry", sorted(WINDOW_GEOMETRIES))
@pytest.mark.parametrize("win", [(7, 7), (11, 11), (15, 15), (21, 21), (31, 31), (45, 45), (45, 21)])
def test_lk_level_windows_kernel_match_plain(cuda_device, win, geometry, pair):
    """Every team shape of lk_level (one warp for small windows, teams of
    warps for large ones) in every geometry, on the 270x480 pair and on
    a (+40, +3) lattice pair: identical to the plain version at every
    level."""
    params = WINDOW_GEOMETRIES[geometry](win)
    if pair == "shift_5_3":
        a, b = (torch.from_numpy(f) for f in _pair())
    else:
        a, b = _lattice_pair(cuda_device, 40, 3)
    _levels_match_plain(cuda_device, params, a, b, geometry)


# Windows past the largest team's 2048 slots take the walking team. The
# anchored geometry comes from rescue_large=False here (levels below the top;
# the top is "centred"): the blocked kernel's 128 px slab holds no top-level
# crop of a window past 46 px.
WALK_GEOMETRIES = dict(
    WINDOW_GEOMETRIES,
    anchored=lambda win: dataclasses.replace(PARAMS, win_size=win, rescue_large=False),
)


@pytest.mark.cuda
@pytest.mark.parametrize("pair", ["shift_5_3", "lattice_40_3"])
@pytest.mark.parametrize("geometry", sorted(WALK_GEOMETRIES))
@pytest.mark.parametrize("win", [(46, 46), (64, 64), (91, 91)])
def test_lk_level_walking_windows_kernel_match_plain(cuda_device, win, geometry, pair):
    """The walking team (any window past 45 x 45) in every geometry, on
    the 270x480 pair and on a (+40, +3) lattice pair: identical to the
    plain version at every level."""
    params = WALK_GEOMETRIES[geometry](win)
    if pair == "shift_5_3":
        a, b = (torch.from_numpy(f) for f in _pair())
    else:
        a, b = _lattice_pair(cuda_device, 40, 3)
    top = "centred" if geometry == "anchored" else None
    _levels_match_plain(cuda_device, params, a, b, geometry, top)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [3, 1])
@pytest.mark.parametrize("quantize", [True, False])
def test_patch_bilinear_window45_kernel_matches_plain(cuda_device, c, quantize):
    """The exact scan's shape, 2304 windows of 45 x 45, origins off the
    plane included (wrapped and clamped): identical windows."""
    rng = np.random.RandomState(45 + c)
    planes = torch.from_numpy(rng.uniform(0, 255, (c, 300, 500)).astype(np.float32)).to(cuda_device)
    tl = torch.from_numpy(rng.uniform(-80, 580, (2304, 2)).astype(np.float32)).to(cuda_device)
    before = patch_bilinear.launches
    got = patch_bilinear(planes, tl, 45, 45, quantize)
    torch.cuda.synchronize()
    assert patch_bilinear.launches == before + 1
    assert torch.equal(got, patch_bilinear_reference(planes, tl, 45, 45, quantize))
