"""PyTorch port vs the JAX package: bilinear windows at arbitrary points
(ops/patch.py, the plain version of the `patch_bilinear` kernel).

Inputs are the JAX package's own prepared tracker frames (u8 levels,
Scharr derivatives, pads), so every window value is a blend of small
dyadic rationals; the port forms the weights and sums the four products in
JAX's order, so windows and quantized templates are held IDENTICAL
(np.array_equal), and so are the dynamic_slice origins of points outside
the plane."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hackathonopticalflow_tpu.core.config import TRACKER_LK
from hackathonopticalflow_tpu.ops import lk as jlk
from hackathonopticalflow_tpu.ops import patch as jpatch
from hackathonopticalflow_tpu_torch import convert
from hackathonopticalflow_tpu_torch.ops import patch as tpatch
from hackathonopticalflow_tpu_torch.ops.patch_bilinear import patch_bilinear, patch_bilinear_reference
from test_torch_prepare import smooth_texture

torch.set_num_threads(1)

H, W = 144, 256
WIN = 15


@pytest.fixture(scope="module")
def planes():
    """(3, Hp, Wp) image, d/dx, d/dy of each level of one frame, as the
    JAX package prepares it for TRACKER_LK (pad 26)."""
    img = np.clip(np.floor(smooth_texture(11, H, W + 8) + 0.5), 0, 255).astype(np.uint8)
    prep = jlk.prepare_frame(jnp.asarray(img, jnp.float32), TRACKER_LK)
    tp = convert.prepared_frame(prep)
    return {
        lv: (
            jnp.stack([prep.img_p[lv], prep.dix_p[lv], prep.diy_p[lv]]),
            torch.stack([tp.img_p[lv], tp.dix_p[lv], tp.diy_p[lv]]),
        )
        for lv in range(TRACKER_LK.max_level + 1)
    }


def _points(n, hp, wp, seed, lo=0.0):
    """n fractional top-lefts whose (WIN+1)^2 crops lie inside the plane
    (lo > 0 keeps them that far from its edge)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(lo, wp - WIN - 1 - lo, n)
    y = rng.uniform(lo, hp - WIN - 1 - lo, n)
    return np.stack([x, y], -1).astype(np.float32)


@pytest.mark.parametrize("level", [2, 1, 0])
@pytest.mark.parametrize("quantize", [False, True], ids=["raw", "fix"])
def test_extract_patches_multi_matches_jax(planes, level, quantize):
    """Template windows (and their _fix'ed form, the LK templates) of three
    planes at in-range points: identical."""
    jp, tp = planes[level]
    tl = _points(64, *tp.shape[1:], seed=level)
    want = jpatch.extract_patches_multi(jp, jnp.asarray(tl), WIN, WIN)
    if quantize:
        want = jnp.floor(want * 32.0 + 0.5) * (1.0 / 32.0)
    got = tpatch.extract_patches_multi(tp, torch.from_numpy(tl), WIN, WIN, quantize=quantize)
    assert got.shape == (64, 3, WIN, WIN)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("level", [2, 0])
def test_extract_patches_matches_jax(planes, level):
    """Single-plane windows (the level-0 err windows): identical."""
    jp, tp = planes[level]
    tl = _points(64, *tp.shape[1:], seed=10 + level)
    want = np.asarray(jpatch.extract_patches(jp[0], jnp.asarray(tl), WIN, WIN))
    got = tpatch.extract_patches(tp[0], torch.from_numpy(tl), WIN, WIN).numpy()
    assert np.array_equal(got, want)


def test_out_of_range_origins_clamp_as_dynamic_slice(planes):
    """Origins outside the plane: negative starts wrap by the plane's size,
    then every start clamps into [0, dim - crop], as lax.dynamic_slice
    places them; the windows equal JAX's."""
    jp, tp = planes[0]
    hp, wp = tp.shape[1:]
    tl = np.array(
        [[-3.25, 5.5], [-wp + 4.75, -hp + 2.5], [-wp - 40.5, 7.0], [wp - 3.5, hp + 9.25],
         [wp + 500.0, -1.0], [-0.5, -0.5], [wp - WIN - 1.0, hp - WIN - 1.0], [2.75, -hp - 3.0]],
        np.float32,
    )
    want = np.asarray(jpatch.extract_patches_multi(jp, jnp.asarray(tl), WIN, WIN))
    got = tpatch.extract_patches_multi(tp, torch.from_numpy(tl), WIN, WIN).numpy()
    assert np.array_equal(got, want)


def test_blend_bilinear_matches_jax():
    rng = np.random.RandomState(5)
    raw = np.floor(rng.uniform(0, 255, (16, WIN + 1, WIN + 1))).astype(np.float32)
    frac = rng.uniform(0, 1, (16, 2)).astype(np.float32)
    want = np.asarray(jpatch.blend_bilinear(jnp.asarray(raw), jnp.asarray(frac), WIN, WIN))
    got = tpatch.blend_bilinear(torch.from_numpy(raw), torch.from_numpy(frac), WIN, WIN).numpy()
    assert np.array_equal(got, want)


def test_patch_bilinear_cpu_runs_plain_version(planes):
    """On CPU tensors the wrapper IS the plain version and launches no
    kernel."""
    _, tp = planes[1]
    tl = torch.from_numpy(_points(32, *tp.shape[1:], seed=3))
    before = patch_bilinear.launches
    for quantize in (False, True):
        got = patch_bilinear(tp, tl, WIN, WIN, quantize)
        assert torch.equal(got, patch_bilinear_reference(tp, tl, WIN, WIN, quantize))
    assert patch_bilinear.launches == before


@pytest.mark.parametrize(
    "bad", ["planes_dtype", "planes_2d", "tl_shape", "tl_dtype", "noncontig", "crop_too_big"]
)
def test_patch_bilinear_rejects_bad_inputs(bad):
    planes = torch.zeros(3, 40, 40)
    tl = torch.zeros(5, 2)
    size = 7
    if bad == "planes_dtype":
        planes = planes.double()
    elif bad == "planes_2d":
        planes = planes[0]
    elif bad == "tl_shape":
        tl = torch.zeros(5, 3)
    elif bad == "tl_dtype":
        tl = tl.to(torch.float16)
    elif bad == "noncontig":
        planes = torch.zeros(3, 40, 80)[:, :, ::2]
    else:
        size = 40
    with pytest.raises((TypeError, ValueError)):
        patch_bilinear(planes, tl, size, size, False)


@pytest.mark.parametrize("win_h,win_w,margin2", [(15, 15, 16), (7, 9, 4)])
def test_select_windows_matches_jax(win_h, win_w, margin2):
    """Windows at integer offsets inside per-point slabs, offsets past
    either end of [0, margin2] included: identical to JAX's masked static
    slices, the sign of zero too."""
    rng = np.random.RandomState(11)
    n, s = 24, max(win_h, win_w) + margin2 + 3
    slabs = rng.uniform(-60, 255, (n, s, s)).astype(np.float32)
    slabs[:, ::5, ::3] = -0.0
    offsets = rng.randint(-4, margin2 + 5, (n, 2)).astype(np.int32)
    offsets[:4] = [[-4, 0], [margin2 + 4, margin2], [0, -1], [margin2, margin2 + 1]]
    want = np.asarray(jpatch.select_windows(jnp.asarray(slabs), jnp.asarray(offsets), win_h, win_w, margin2))
    got = tpatch.select_windows(torch.from_numpy(slabs), torch.from_numpy(offsets), win_h, win_w, margin2).numpy()
    assert got.shape == want.shape == (n, win_h + 1, win_w + 1)
    assert np.array_equal(got, want) and np.array_equal(np.signbit(got), np.signbit(want))
