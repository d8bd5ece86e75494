"""The grid template kernel's wrapper and plain version on the CPU.

`grid_templates_reference` is held to the JAX package's
extract_grid_templates_lanes bit for bit (u8 frames: every value is a small
dyadic rational), at every level, at windows 45 and 15, with and without a
stream axis; `level_inputs` hands the three level planes to the extractor
as they are, with no stack. The kernel itself runs only on the GPU
(tests/test_torch_cuda.py); here the wrapper takes its plain version and
its launch shape and argument checks are held to csrc/grid_templates.cu.
"""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hackathonopticalflow_tpu.core import LKParams as JLKParams
from hackathonopticalflow_tpu.ops import lk as jlk
from hackathonopticalflow_tpu.ops.grid_patch import extract_grid_templates_lanes
from hackathonopticalflow_tpu_torch.core import LKParams, measurement_grid
from hackathonopticalflow_tpu_torch.ops import grid_templates as tgt
from hackathonopticalflow_tpu_torch.ops import lk as tlk
from hackathonopticalflow_tpu_torch.ops.grid_templates import (
    EPT,
    MAX_LANES,
    grid_templates,
    grid_templates_reference,
    launch_shape,
)

torch.set_num_threads(1)

CSRC = Path(__file__).resolve().parent.parent / "hackathonopticalflow_tpu_torch" / "csrc"
H, W = 180, 320


def frames(n: int, seed: int = 5, h: int = H, w: int = W) -> np.ndarray:
    """n u8 frames of a smoothed noise texture drifting by (3, 2) px a
    frame."""
    rng = np.random.RandomState(seed)
    sm = rng.uniform(0, 255, (h + 2 * n + 8, w + 3 * n + 8))
    for _ in range(4):
        p = np.pad(sm, 1, mode="reflect")
        sm = 0.25 * p[:-2, 1:-1] + 0.5 * p[1:-1, 1:-1] + 0.25 * p[2:, 1:-1]
        sm = 0.25 * sm[:, :-2] + 0.5 * sm[:, 1:-1] + 0.25 * sm[:, 2:]
    sm = np.clip(np.floor(sm + 0.5), 0, 255).astype(np.uint8)
    return np.stack([sm[2 * t : 2 * t + h, 3 * t : 3 * t + w] for t in range(n)])


def axes(h: int = H, w: int = W):
    pts = measurement_grid(h, w, 30)
    return np.unique(pts[:, 0]).astype(int), np.unique(pts[:, 1]).astype(int), pts.shape[0]


def params(win: int) -> LKParams:
    return dataclasses.replace(LKParams(grid_step=30, compute_err=False), win_size=(win, win))


def jax_templates(frame: np.ndarray, level: int, win: int) -> np.ndarray:
    """JAX's extract_grid_templates_lanes on its own prepared frame, as
    (N, 3, win, win) float32."""
    jp = JLKParams(grid_step=30, use_pallas=True, compute_err=False, win_size=(win, win))
    prep = jlk.prepare_frame(jnp.asarray(frame, jnp.float32), jp)
    planes = jnp.stack([prep.img_p[level], prep.dix_p[level], prep.diy_p[level]])
    xs, ys, _ = axes(*frame.shape)
    pad = jlk._frame_pad(jp)
    assert pad == tlk._frame_pad(params(win))
    ref = np.asarray(extract_grid_templates_lanes(planes, xs, ys, level, win, win, pad))
    return np.transpose(ref[:, :, :win, :], (3, 0, 1, 2)).astype(np.float32) / 32.0


@pytest.mark.parametrize("streams", [None, 2], ids=["one", "B=2"])
@pytest.mark.parametrize("win", [45, 15])
@pytest.mark.parametrize("level", [2, 1, 0])
def test_reference_equals_jax_extractor(level, win, streams):
    """The plain version equals JAX's templates bit for bit; with a stream
    axis each stream's rows are its own frame's, stream-major; the wrapper
    gives the same on the planes of one stack."""
    clip = frames(2)
    xs, ys, n = axes()
    p = params(win)
    pad = tlk._frame_pad(p)
    img = torch.from_numpy(clip[0] if streams is None else clip)
    prep = tlk.prepare_frame(img, p)
    planes = (prep.img_p[level], prep.dix_p[level], prep.diy_p[level])
    got = grid_templates_reference(*planes, xs, ys, level, win, win, pad)
    assert got.shape == ((streams or 1) * n, 3, win, win) and got.is_contiguous()
    for b in range(streams or 1):
        assert np.array_equal(got[b * n : (b + 1) * n].numpy(), jax_templates(clip[b], level, win)), b
    stacked = grid_templates(*torch.stack(planes, dim=-3).unbind(-3), xs, ys, level, win, win, pad)
    assert torch.equal(stacked, got)


@pytest.mark.parametrize("grid_kernel", ["lanes", "blocked"])
def test_level_inputs_hands_over_the_planes_without_a_stack(monkeypatch, grid_kernel):
    """level_inputs passes the level's three planes themselves to the
    extractor (no stacked copy) and its templates equal the plain version
    on the stacked planes, at every level."""
    p = dataclasses.replace(params(45), grid_kernel=grid_kernel)
    clip = torch.from_numpy(frames(2))
    prev, nxt = tlk.prepare_frame(clip[0], p), tlk.prepare_frame(clip[1], p)
    xs, ys, n = axes()
    pts = torch.from_numpy(measurement_grid(H, W, 30))
    seen = []

    def spy(*args):
        seen.append(args[:3])
        return grid_templates(*args)

    monkeypatch.setattr(tlk, "grid_templates", spy)
    pad = tlk._frame_pad(p)
    for level in range(3):
        (tmpl, *_), _ = tlk.level_inputs(prev, nxt, (xs, ys), pts * 2.0**-level, level, p)
        planes = seen[-1]
        assert all(a is b for a, b in zip(planes, (prev.img_p[level], prev.dix_p[level], prev.diy_p[level])))
        want = grid_templates_reference(*torch.stack(planes).unbind(0), xs, ys, level, 45, 45, pad)
        assert torch.equal(tmpl, want) and tmpl.shape == (n, 3, 45, 45)
    assert len(seen) == 3


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper returns the plain version's result and
    launches nothing, with and without a stream axis and on the planes of
    one stack."""
    p = params(45)
    pad = tlk._frame_pad(p)
    xs, ys, _ = axes()
    prep = tlk.prepare_frame(torch.from_numpy(frames(3)), p)
    before = grid_templates.launches
    for level in range(3):
        planes = [prep.img_p[level], prep.dix_p[level], prep.diy_p[level]]
        want = grid_templates_reference(*planes, xs, ys, level, 45, 45, pad)
        assert torch.equal(grid_templates(*planes, xs, ys, level, 45, 45, pad), want)
        views = torch.stack(planes, 1).unbind(1)  # (B, 3, Hp, Wp) sliced: streams 3 planes apart
        assert torch.equal(grid_templates(*views, xs, ys, level, 45, 45, pad), want)
    assert grid_templates.launches == before


def _planes(h=120, w=200):
    g = torch.Generator().manual_seed(2)
    return [torch.floor(torch.rand((h, w), generator=g) * 255) for _ in range(3)]


@pytest.mark.parametrize("fault", ["dtype", "shape", "rows", "streams apart", "dims", "outside", "device"])
def test_arguments_are_checked(fault):
    """The wrapper raises, on either route, for what the kernel cannot
    take: another dtype, planes of other shapes, rows that are not
    contiguous, streams spaced unlike img's, a plane that is not 2-d or
    3-d, windows reaching outside the planes, planes on another device."""
    xs, ys = (40, 70, 100), (30, 60)
    img, dix, diy = _planes()
    if fault == "dtype":
        dix = dix.double()
    elif fault == "shape":
        diy = diy[:-1]
    elif fault == "rows":
        img = img.t().contiguous().t()
    elif fault == "streams apart":
        img, dix, diy = (torch.stack([t, t]) for t in (img, dix, diy))
        dix = torch.stack([dix, dix], 1).unbind(1)[0]  # one more stream between two
    elif fault == "dims":
        img, dix, diy = (t[None, None] for t in (img, dix, diy))
    elif fault == "outside":
        xs = (5, 70, 100)  # the window at x 5 starts 17 px left of a pad of 5
    elif fault == "device":
        dix = dix.to("meta")
    pad = 5
    # the template windows at level 0, window 45 x 45, lie inside a 120 x 200 plane
    with pytest.raises((ValueError, TypeError)):
        grid_templates(img, dix, diy, xs, ys, 0, 45, 45, pad)


def test_planes_off_cpu_and_cuda_raise():
    img, dix, diy = (t.to("meta") for t in _planes())
    with pytest.raises(ValueError, match="cpu or cuda"):
        grid_templates(img, dix, diy, (40, 70, 100), (30, 60), 0, 45, 45, 5)


@pytest.mark.parametrize("win", [(45, 45), (15, 15), (21, 21), (5, 5), (7, 7), (33, 33), (45, 21), (91, 91)])
def test_launch_shape_covers_the_window(win):
    """A power of two in [32, MAX_LANES] lanes; one pass wherever
    MAX_LANES x EPT outputs hold the window, and no lanes idle in it past
    the first 32 (each halving would not cover it)."""
    lanes = launch_shape(*win)
    npix = win[0] * win[1]
    assert lanes & (lanes - 1) == 0 and 32 <= lanes <= MAX_LANES
    if npix <= MAX_LANES * EPT:
        assert lanes * EPT >= npix
        assert lanes == 32 or (lanes // 2) * EPT < npix
    else:
        assert lanes == MAX_LANES
    assert launch_shape(45, 45) == 128 and launch_shape(15, 15) == 32


def test_launch_constants_match_the_source():
    """csrc/grid_templates.cu takes the wrapper's MAX_LANES and EPT, and
    shares no code with csrc/patch_bilinear.cu."""
    src = (CSRC / "grid_templates.cu").read_text()
    assert int(re.search(r"constexpr int MAX_LANES = (\d+);", src).group(1)) == MAX_LANES
    assert int(re.search(r"constexpr int EPT = (\d+);", src).group(1)) == EPT
    assert "#include" in src and "patch_bilinear" not in re.findall(r'#include\s+[<"]([^>"]+)', src)


def test_template_index_is_cached_per_device():
    """One index per grid, level, window, pad and device, made once: the
    captured steps read it without building it again."""
    xs, ys, _ = axes()
    a = tgt.template_index(tgt.axis_key(xs), tgt.axis_key(ys), 1, 45, 45, 70, torch.device("cpu"))
    b = tgt.template_index(tuple(int(v) for v in xs), tuple(int(v) for v in ys), 1, 45, 45, 70,
                           torch.device("cpu"))
    assert a is b
    assert a.y0.dtype == torch.int32 and a.fy.dtype == torch.float32
    assert a.rows.shape == (len(ys), 46) and a.cols.shape == (len(xs), 46)
