"""The port's CUDA kernels against their plain versions on the GPU.

These tests need a CUDA GPU and nvcc; elsewhere they skip. The file
imports no jax, so on a machine without jax it runs without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import dataclasses
import gc
import importlib
from unittest import mock

import numpy as np
import pytest
import torch

from chip_smoke import (
    ClipReader,
    counted,
    eager,
    sample_texture,
    scene_table,
    smooth_texture,
    strict_replays,
    tracker_points,
)

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
from hackathonopticalflow_tpu_torch.ops import lk as tlk
from hackathonopticalflow_tpu_torch.ops import patch as tpatch
from hackathonopticalflow_tpu_torch.ops.gather_rects import gather_rects, gather_rects_reference
from hackathonopticalflow_tpu_torch.ops.grid_templates import grid_templates, grid_templates_reference
from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level, lk_level_reference
from hackathonopticalflow_tpu_torch.ops.patch_bilinear import patch_bilinear, patch_bilinear_reference
from hackathonopticalflow_tpu_torch.ops.warp_bilinear import warp_bilinear, warp_bilinear_reference
from hackathonopticalflow_tpu_torch.utils import graphs
import torch_graph_steps as graph_steps

# the package's ops/__init__ re-exports a function named farneback
tfb = importlib.import_module("hackathonopticalflow_tpu_torch.ops.farneback")

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


def _grid_template_calls(device, params, b, h, w):
    """Per level of `params`, (level, the three planes, the same planes as
    slices of one (B, 3, Hp, Wp) stack) of b frames (one without a stream
    axis), and the grid's axes and the pad."""
    fr = np.stack(_frames(b, h, w))
    prep = tlk.prepare_frame(torch.from_numpy(fr if b > 1 else fr[0]).to(device), params)
    calls = []
    for level in range(params.max_level, -1, -1):
        planes = [prep.img_p[level], prep.dix_p[level], prep.diy_p[level]]
        calls.append((level, planes, torch.stack(planes, -3).unbind(-3)))
    return calls, tlk._grid_axes(h, w, params.grid_step), tlk._frame_pad(params)


@pytest.mark.cuda
@pytest.mark.parametrize("grid_kernel", ["lanes", "blocked"])
@pytest.mark.parametrize("b", [1, 2])
def test_grid_templates_kernel_matches_plain(cuda_device, b, grid_kernel):
    """The review's geometry (1920x1080, 2304 points, window 45, pad 70)
    at its three levels: one launch a level, identical to the plain
    version, on three planes and on the planes of one stack."""
    params = dataclasses.replace(PARAMS, grid_kernel=grid_kernel)
    calls, (xs, ys), pad = _grid_template_calls(cuda_device, params, b, 1080, 1920)
    assert pad == 70 and len(xs) * len(ys) == 2304
    for level, planes, views in calls:
        before = grid_templates.launches
        got = grid_templates(*planes, xs, ys, level, 45, 45, pad)
        torch.cuda.synchronize()
        assert grid_templates.launches == before + 1
        assert got.shape == (b * 2304, 3, 45, 45)
        assert torch.equal(got, grid_templates_reference(*planes, xs, ys, level, 45, 45, pad)), level
        assert torch.equal(grid_templates(*views, xs, ys, level, 45, 45, pad), got), level


@pytest.mark.cuda
@pytest.mark.parametrize("win", [(5, 5), (15, 15), (21, 21), (33, 33), (45, 21), (91, 91)])
def test_grid_templates_windows_kernel_match_plain(cuda_device, win):
    """Other windows, each launch shape and a window of several passes,
    on two streams at 270x480: identical at every level."""
    params = dataclasses.replace(PARAMS, win_size=win)
    calls, (xs, ys), pad = _grid_template_calls(cuda_device, params, 2, 270, 480)
    for level, planes, _ in calls:
        got = grid_templates(*planes, xs, ys, level, *win, pad)
        assert torch.equal(got, grid_templates_reference(*planes, xs, ys, level, *win, pad)), level


# (b, c, h, w) of the warp's GPU tests: the 720p dense path's level sizes,
# the ragged shape, a stream axis of 4, odd sizes, the tiled ranks' 644-
# and 1004-row slabs and their coarsest level, and other channel counts
# (one channel a block); together they take every branch of launch_shape
WARP_SHAPES = [(1, 5, 90, 160), (1, 5, 180, 320), (1, 5, 360, 640), (1, 5, 720, 1280), (1, 5, 20, 200),
               (4, 5, 90, 160), (2, 5, 361, 643), (1, 5, 644, 1280), (1, 5, 1004, 1280), (1, 5, 81, 160),
               (1, 1, 20, 200), (1, 3, 90, 160)]
WARP_IDS = ["x".join(map(str, s)) for s in WARP_SHAPES]


def _warp_inputs(device, b, c, h, w, dtype, amp, seed):
    """A (b, c, h, w) source of `dtype` and coordinates fx, fy (b, h, w):
    the pixel grid displaced by a smooth field of amplitude `amp` px and
    +-2 px of noise (amp 150: samples past the TPU slab's margins)."""
    rng = np.random.RandomState(seed)
    src = torch.from_numpy(rng.randn(b, c, h, w).astype(np.float32) * 100).to(device).to(dtype)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx = xx + amp * np.sin(yy / 3.0 + xx / 17.0) + rng.uniform(-2, 2, (b, h, w))
    fy = yy + amp * np.cos(xx / 5.0) + rng.uniform(-2, 2, (b, h, w))
    fx, fy = (torch.from_numpy(f.astype(np.float32)).to(device) for f in (fx, fy))
    return src, fx, fy


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bchw", WARP_SHAPES, ids=WARP_IDS)
def test_warp_bilinear_kernel_matches_plain(cuda_device, bchw, dtype):
    """The gather geometry: identical over every pixel, inside the frame
    and past its borders (an 8 px field): both round every product and
    sum alike (no FMA contraction)."""
    src, fx, fy = _warp_inputs(cuda_device, *bchw, dtype, 8.0, sum(bchw))
    before = warp_bilinear.launches
    out = warp_bilinear(src, fx, fy)
    torch.cuda.synchronize()
    assert warp_bilinear.launches == before + 1
    assert torch.equal(out, warp_bilinear_reference(src, fx, fy))


@pytest.mark.cuda
@pytest.mark.parametrize("spread", [False, True], ids=["in_margin", "spread"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bchw", WARP_SHAPES, ids=WARP_IDS)
def test_warp_bilinear_slab_kernel_matches_plain(cuda_device, bchw, dtype, spread):
    """The slab geometry at the 720p dense path's level sizes, the tiled
    ranks' slab heights, a ragged shape and a stream axis, float32 and
    bf16 source, with flow inside the TPU kernel's margins and flow whose
    spread clamps samples: identical over every pixel."""
    src, fx, fy = _warp_inputs(cuda_device, *bchw, dtype, 150.0 if spread else 3.0, sum(bchw) + spread)
    before = warp_bilinear.launches
    out = warp_bilinear(src, fx, fy, "slab")
    torch.cuda.synchronize()
    assert warp_bilinear.launches == before + 1
    assert torch.equal(out, warp_bilinear_reference(src, fx, fy, "slab"))


@pytest.mark.cuda
@pytest.mark.parametrize("geometry", ["gather", "slab"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bchw", [(2, 5, 20, 200), (2, 5, 180, 320), (1, 3, 90, 160)],
                         ids=["2x5x20x200", "2x5x180x320", "1x3x90x160"])
def test_warp_bilinear_every_launch_matches_plain(cuda_device, bchw, dtype, geometry):
    """Every launch the kernel takes (launch_shapes: all 5 channels a
    block or one; in the slab geometry a tile to 1 or 2 blocks)
    gives the plain version's result; a launch it does not take raises."""
    from hackathonopticalflow_tpu_torch.ops.warp_bilinear import _launch, launch_shapes

    src, fx, fy = _warp_inputs(cuda_device, *bchw, dtype, 150.0, 7)
    ref = warp_bilinear_reference(src, fx, fy, geometry)
    shapes = launch_shapes(*bchw, geometry)
    assert len(shapes) == (1 + (bchw[1] == 5)) * (2 if geometry == "slab" else 1)
    for shape in shapes:
        out = torch.full_like(ref, float("nan"))
        _launch(src, fx, fy, out, geometry, shape)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), shape
    for bad in (shapes[0]._replace(grid=shapes[0].grid + 1), shapes[0]._replace(splits=3)):
        with pytest.raises(RuntimeError, match="cudaError"):
            _launch(src, fx, fy, out, geometry, bad)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["pallas", "pallas_bf16", "packed"])
def test_farneback_video_modes_kernel_path_matches_plain(cuda_device, mode):
    """2 pairs of the dense scan in the coefficient modes through the
    kernel equal the plain path's (the cumsum box is the same torch call
    on both paths)."""
    params = FarnebackParams(warp_mode=mode)
    clip = torch.from_numpy(np.stack(_frames(3, 144, 256, 1, 1))).to(cuda_device)
    got, runs = counted(lambda: tdense.farneback_flow_video(clip, params, device=cuda_device))
    assert runs.replayed["warp_bilinear"] == 2 * params.iterations * (params.levels + 1)
    with eager(), mock.patch.object(tfb, "warp_bilinear", warp_bilinear_reference):
        want = tdense.farneback_flow_video(clip, params, device=cuda_device)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_farneback_video_kernel_path_matches_plain(cuda_device):
    """2 pairs of the dense scan through the kernel equal the plain path's:
    the rest of the path is the same ops on the same inputs."""
    params = FarnebackParams()
    clip = torch.from_numpy(np.stack(_frames(3, 144, 256, 1, 1))).to(cuda_device)
    got, runs = counted(lambda: tdense.farneback_flow_video(clip, params, device=cuda_device))
    assert runs.replayed["warp_bilinear"] == 2 * params.iterations * (params.levels + 1)
    with eager(), mock.patch.object(tfb, "warp_bilinear", warp_bilinear_reference):
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
    (got, hist), runs = counted(lambda: ttr.track_video(clip, params, s0, device=cuda_device))
    assert runs.replayed["lk_level"] == 3 * 6 and runs.replayed["patch_bilinear"] == 3 * 8
    with eager(), mock.patch.object(tlk, "lk_level", lk_level_reference), \
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


# one LK configuration per lk_level geometry at the 45 x 45 window, for
# the stream-batched calls
BATCH_GEOMETRIES = {
    "centred": PARAMS,
    "anchored": dataclasses.replace(PARAMS, grid_kernel="blocked"),
    "v1": LKParams(slab_margin=8, compute_err=False),
    "exact": LKParams(compute_err=False),
}


def _stream_frames(dev, b):
    """(2, b, 270, 480) u8: stream s moves by its own (dx, dy)."""
    shifts = [(5, 3), (-4, 2), (7, -1), (1, 6)][:b]
    out = [np.stack(_frames(2, dx=dx, dy=dy)) for dx, dy in shifts]
    return torch.from_numpy(np.stack(out, 1)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("geometry", sorted(BATCH_GEOMETRIES))
def test_lk_level_stream_batched_kernel_matches_plain(cuda_device, geometry, b):
    """A stream axis of b planes in every geometry, one launch per level for
    all streams: identical to the plain version at every level, and each
    stream's rows identical to the unbatched call on its own plane."""
    params = BATCH_GEOMETRIES[geometry]
    frames = _stream_frames(cuda_device, b)
    pts_np = measurement_grid(270, 480, 30) if params.grid_step else tracker_points(270, 480, 256)
    pts = torch.from_numpy(pts_np).to(cuda_device)
    n = pts.shape[0]
    grid_xy = (np.unique(pts_np[:, 0]).astype(int), np.unique(pts_np[:, 1]).astype(int))
    prev, nxt = tlk.prepare_frame(frames[1], params), tlk.prepare_frame(frames[0], params)
    singles = [(tlk.prepare_frame(frames[1, s], params), tlk.prepare_frame(frames[0, s], params)) for s in range(b)]

    def inputs(p, q, points, center, level):
        if params.grid_step is not None:
            return tlk.level_inputs(p, q, grid_xy, center, level, params)
        args, kw, _ = tlk.point_level_inputs(p, q, points, center, level, params)
        return args, kw

    center = pts.repeat(b, 1) * 0.25
    status = torch.ones(b * n, dtype=torch.bool, device=cuda_device)
    for level in (2, 1, 0):
        if level != 2:
            center = center * 2.0
        args, kw = inputs(prev, nxt, pts.repeat(b, 1), center, level)
        assert args[1].shape[0] == b and kw["geometry"] in (geometry, "centred")
        before = lk_level.launches
        tl_k, st_k = lk_level(*args, status, **kw)
        torch.cuda.synchronize()
        assert lk_level.launches == before + 1
        tl_p, st_p = lk_level_reference(*args, status, **kw)
        assert torch.equal(st_k, st_p), level
        assert torch.equal(tl_k, tl_p), level
        for s, (p1, q1) in enumerate(singles):
            rows = slice(s * n, (s + 1) * n)
            a1, kw1 = inputs(p1, q1, pts, center[rows], level)
            tl1, st1 = lk_level(*a1, status[rows], **kw1)
            assert torch.equal(tl1, tl_k[rows]) and torch.equal(st1, st_k[rows]), (level, s)
        center, status = tl_p + tlk._halfwin(params, cuda_device), st_p


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("c", [3, 1])
def test_patch_bilinear_stream_batched_kernel_matches_plain(cuda_device, c, b):
    """(b, C, Hp, Wp) stacks and stream-major points at the exact scan's
    window (45 x 45), origins off the plane included, in one launch:
    identical to the plain version and, per stream, to the unbatched
    call."""
    rng = np.random.RandomState(45 + c + b)
    planes = torch.from_numpy(rng.uniform(0, 255, (b, c, 300, 500)).astype(np.float32)).to(cuda_device)
    tl = torch.from_numpy(rng.uniform(-80, 580, (b * 576, 2)).astype(np.float32)).to(cuda_device)
    before = patch_bilinear.launches
    got = patch_bilinear(planes, tl, 45, 45, True)
    torch.cuda.synchronize()
    assert patch_bilinear.launches == before + 1
    assert torch.equal(got, patch_bilinear_reference(planes, tl, 45, 45, True))
    for s in range(b):
        rows = slice(s * 576, (s + 1) * 576)
        assert torch.equal(got[rows], patch_bilinear(planes[s], tl[rows].contiguous(), 45, 45, True))


@pytest.mark.cuda
def test_two_gloo_ranks_share_the_gpu(cuda_device):
    """Two gloo ranks on cuda:0 (parallel/mesh.py::run_on_mesh): halo
    exchange of CUDA tensors in every mode (the gloo route stages them
    through the host) equal to slices of the padded frame, and
    stream_batched_grid_flow (one stream a rank, production params, 6
    lk_level launches a rank: the warm-up and the capture of lk_grid_flow's
    graph) identical to each stream's lk_grid_flow."""
    import torch_parallel_ranks as ranks

    from hackathonopticalflow_tpu_torch import kernels, parallel
    from hackathonopticalflow_tpu_torch.flow.lk_grid import lk_grid_flow

    kernels.build("lk_level")  # once, before the ranks load it
    f0, f1, f2 = _frames(3)
    x = np.arange(64 * 6, dtype=np.float32).reshape(64, 6)
    inp = {"ranks": 2, "halo_x": x, "streams": (np.stack([f0, f1]), np.stack([f1, f2])),
           "pts": measurement_grid(*f0.shape, PARAMS.grid_step)}
    out = parallel.run_on_mesh(ranks.cuda_checks, 2, (inp,), device="cuda", backend="gloo", timeout_s=300)
    h = ranks.HALO_ROWS
    for mode in ranks.HALO_MODES:
        padded = np.pad(x, ((h, h), (0, 0)), mode=mode)
        for r in range(2):
            assert np.array_equal(out[r][f"halo_{mode}"].numpy(), padded[r * 32 : r * 32 + 32 + 2 * h]), (mode, r)
    pts = torch.from_numpy(inp["pts"])
    for r in range(2):
        assert out[r]["lk_level_launches"] == 2 * (PARAMS.max_level + 1)
        want = lk_grid_flow(torch.from_numpy(inp["streams"][0][r]), torch.from_numpy(inp["streams"][1][r]), pts,
                            lk=PARAMS, device=cuda_device)
        for field, value in zip(want._fields, want):
            assert torch.equal(getattr(out[r]["grid"], field)[0], value.cpu()), (r, field)


@pytest.mark.cuda
def test_ego_motion_default_route_matches_gpu_geometry(cuda_device):
    """ego_motion_track with device="cuda" on scene_table()'s 3D scene:
    the default route (keyframes on the GPU, windows on the host) against
    geometry_device="cuda" (windows on the GPU too): identical keyframes,
    centres within 1e-3 of the span (their RANSAC draws come from the
    two devices' generators)."""
    from hackathonopticalflow_tpu_torch.nav import odometry as todo
    from hackathonopticalflow_tpu_torch.nav.camera import Pinhole

    table = todo.TrackTable(*scene_table()[0])
    cam = Pinhole.from_fov(1920, 1080, 155.0)
    host = todo.ego_motion_track(None, TrackerParams(), cam, table=table, device=cuda_device)
    card = todo.ego_motion_track(None, TrackerParams(), cam, table=table, device=cuda_device,
                                 geometry_device=cuda_device)
    assert host.kf_idx.tolist() == card.kf_idx.tolist() and len(host.kf_idx) >= 4
    span = np.linalg.norm(host.centers - host.centers[0], axis=-1).max()
    assert np.abs(host.centers - card.centers).max() <= 1e-3 * span


@pytest.mark.cuda
def test_run_batched_on_the_card_equals_the_scan(cuda_device):
    """run_batched on the card: 22 frames in chunks of 4 pairs, so its
    three pinned slots each take two chunks and the last chunk is a
    padded tail of one pair; each pair's eight arrays equal
    lk_grid_flow_video's over the same frames."""
    from hackathonopticalflow_tpu_torch.apps.pathfinder import PathfinderApp, PathfinderConfig
    from hackathonopticalflow_tpu_torch.flow.lk_grid import GridFlowResult, lk_grid_flow_video

    frames = np.stack(_frames(22, dx=2, dy=1))

    class Keeping(PathfinderApp):
        def render_frame(self, img, res, fps=None):
            self.kept.append(GridFlowResult(*[np.array(a) for a in res]))
            return img

    app = Keeping(PathfinderConfig(video="clip", lk=PARAMS, device="cuda"), open_reader=lambda path: ClipReader(frames))
    app.kept = []
    gc.collect()  # another test's dropped app would free its graph during this capture
    stats = app.run_batched(chunk=4, render=True)
    assert stats["frames"] == len(app.kept) == 21
    pts = torch.from_numpy(measurement_grid(*frames.shape[1:], PARAMS.grid_step)).to(cuda_device)
    want = lk_grid_flow_video(torch.from_numpy(frames), pts, PARAMS, device=cuda_device)
    for i, got in enumerate(app.kept):
        for name in GridFlowResult._fields:
            assert np.array_equal(getattr(got, name), getattr(want, name)[i].cpu().numpy()), (i, name)


@pytest.mark.cuda
def test_run_batch_hook_on_the_card_equals_each_streams_scan(cuda_device):
    """run_batch on the card with on_result: three streams of 9, 6 and 8
    frames, so two slots of the pinned results alternate and two streams
    end early; each call's eight arrays equal lk_grid_flow_video's over
    that stream alone, and the counts equal the hook-less run's."""
    from hackathonopticalflow_tpu_torch.apps.batch_runner import BatchRunnerConfig, run_batch
    from hackathonopticalflow_tpu_torch.flow.lk_grid import GridFlowResult, lk_grid_flow_video

    clips = [np.stack(_frames(n, dx=dx, dy=1)) for n, dx in ((9, 2), (6, 4), (8, 1))]
    calls = []

    def keep(stream, pair, res):
        calls.append((stream, pair, GridFlowResult(*[np.array(a) for a in res])))

    def cfg(hook):
        return BatchRunnerConfig(videos=["0", "1", "2"], lk=PARAMS, device="cuda", on_result=hook,
                                 open_reader=lambda name: ClipReader(clips[int(name)]))

    gc.collect()
    plain = run_batch(cfg(None))
    hooked = run_batch(cfg(keep))
    assert hooked["danger_counts"] == plain["danger_counts"]
    assert [len(c) for c in hooked["danger_counts"]] == [8, 5, 7]
    pts = torch.from_numpy(measurement_grid(*clips[0].shape[1:], PARAMS.grid_step)).to(cuda_device)
    want = [lk_grid_flow_video(torch.from_numpy(c), pts, PARAMS, device=cuda_device) for c in clips]
    assert [(s, p) for s, p, _ in calls] == [(s, k) for k in range(1, 9) for s in range(3) if k <= (8, 5, 7)[s]]
    for stream, pair, got in calls:
        for name in GridFlowResult._fields:
            assert np.array_equal(getattr(got, name), getattr(want[stream], name)[pair - 1].cpu().numpy()), (
                stream, pair, name)


def _leaves(tree):
    return [x for x in torch.utils._pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


@pytest.mark.cuda
@pytest.mark.parametrize("step", list(graph_steps.STEPS))
def test_graphed_step_replays_its_eager_form(cuda_device, step):
    """Each captured step: its first call (warm-up, capture, replay) and a
    second one (a replay, under sync debug mode "error") equal the eager
    form (__wrapped__, nested steps eager too) with torch.equal; one graph
    for the key; an earlier output is not overwritten by the later
    replay."""
    fn, args = graph_steps.STEPS[step](cuda_device)
    fn.clear()
    owner = getattr(fn.__wrapped__, "__self__", None)  # the app whose chunk it is
    with eager(*([] if owner is None else [owner])):
        want = fn.__wrapped__(*args)
    # an earlier step's app is cyclic garbage that holds a graph: freed by
    # the collector during this capture, it would invalidate the capture
    gc.collect()
    first = fn(*args)
    with strict_replays():
        second = fn(*args)
    torch.cuda.synchronize()
    assert len(fn._entries) == 1
    for got in (first, second):
        assert len(_leaves(got)) == len(_leaves(want))
        for g, w in zip(_leaves(got), _leaves(want)):
            assert g.device.type == "cuda" and torch.equal(g, w)


# the grid steps and the template launches their graphs record: one a
# level a pair, every stream in one launch
GRID_STEPS = {"sparse step": 3, "sparse pair": 3, "pathfinder chunk": 9, "pathfinder pair": 3,
              "batch step B=2": 3}


@pytest.mark.cuda
@pytest.mark.parametrize("step", sorted(GRID_STEPS))
def test_grid_step_captures_the_template_kernel(cuda_device, step):
    """Each grid step's graph records the template kernel, and its replay
    equals the eager form with the plain version patched in."""
    fn, args = graph_steps.STEPS[step](cuda_device)
    fn.clear()
    owner = getattr(fn.__wrapped__, "__self__", None)
    with eager(*([] if owner is None else [owner])), mock.patch.object(tlk, "grid_templates",
                                                                        grid_templates_reference):
        want = fn.__wrapped__(*args)
    gc.collect()
    got = fn(*args)
    torch.cuda.synchronize()
    (entry,) = fn._entries.values()
    assert entry.nodes["grid_templates"] == GRID_STEPS[step]
    assert len(_leaves(got)) == len(_leaves(want))
    for g, w in zip(_leaves(got), _leaves(want)):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_graphed_new_shape_captures_a_second_graph(cuda_device):
    """A call at a new frame size captures a second graph; both sizes
    replay their eager results."""
    fn = graph_steps.STEPS["sparse pair"](cuda_device)[0]
    fn.clear()
    for h, w in ((144, 256), (160, 288), (144, 256)):
        _, args = graph_steps.sparse_pair(cuda_device, h, w)
        got, want = fn(*args), fn.__wrapped__(*args)
        assert all(torch.equal(g, x) for g, x in zip(_leaves(got), _leaves(want)))
    assert len(fn._entries) == 2


@pytest.mark.cuda
def test_graphed_output_survives_later_replays(cuda_device):
    """An output handed out is a copy: replaying the graph on other inputs
    leaves it as it was."""
    fn = graphs.graphed(lambda x: (x * 2.0 + 1.0).cumsum(0))
    x1 = torch.arange(8.0, device=cuda_device)
    out1 = fn(x1)
    fn(x1 + 100.0)
    torch.cuda.synchronize()
    assert torch.equal(out1, (x1 * 2.0 + 1.0).cumsum(0))


@pytest.mark.cuda
def test_graphed_keeps_what_it_reads_alive(cuda_device):
    """A tensor the capture read from outside (a cache's entry) stays
    alive with the graph: dropped from the cache and its memory offered
    to new tensors, the replay still reads its values."""
    cache = {"c": torch.arange(4.0, device=cuda_device)}
    fn = graphs.graphed(lambda x: x + cache["c"])
    x = torch.ones(4, device=cuda_device)
    fn(x)
    del cache["c"]
    junk = [torch.full((4,), 7.0, device=cuda_device) for _ in range(64)]
    torch.cuda.synchronize()
    assert torch.equal(fn(x), x + torch.arange(4.0, device=cuda_device)) and len(junk) == 64


@pytest.mark.cuda
def test_graphed_capture_failure_raises(cuda_device):
    """A function that reads a device value on the host cannot be
    captured: the call raises, keeps no graph, and raises again; the
    device stays usable."""
    fn = graphs.graphed(lambda x: x * float(x.sum()))
    x = torch.ones(4, device=cuda_device)
    for _ in range(2):
        with pytest.raises(RuntimeError):
            fn(x)
        assert fn._entries == {}
    torch.cuda.synchronize()
    assert torch.equal(fn.__wrapped__(x), x * 4.0)
