"""PyTorch port vs the JAX package: frame preparation and grid templates.

Levels, derivatives, pads and templates are held BIT-EXACT: inputs are u8
images, so every value is a small dyadic rational and any summation order
gives the same float32 bits."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hackathonopticalflow_tpu.core import LKParams, measurement_grid
from hackathonopticalflow_tpu.ops import lk as jlk
from hackathonopticalflow_tpu.ops import pyramid as jpyr
from hackathonopticalflow_tpu.ops.grid_patch import extract_grid_templates_lanes
from hackathonopticalflow_tpu_torch import convert
from hackathonopticalflow_tpu_torch import core as tcore
from hackathonopticalflow_tpu_torch.ops import lk as tlk
from hackathonopticalflow_tpu_torch.ops import pyramid as tpyr
from hackathonopticalflow_tpu_torch.ops.image import reflect101_pad
from hackathonopticalflow_tpu_torch.ops.grid_templates import grid_templates

torch.set_num_threads(1)

PARAMS = LKParams(grid_step=30, use_pallas=True, compute_err=False)
TPARAMS = tcore.LKParams(grid_step=30, compute_err=False)


def smooth_texture(seed: int, h: int, w: int) -> np.ndarray:
    """Uniform noise smoothed by four [1/4, 1/2, 1/4] passes (reflect-101),
    as tests/test_lk_static_grid.py builds its synthetic frames."""
    sm = np.random.RandomState(seed).uniform(0, 255, (h, w))
    for _ in range(4):
        p = np.pad(sm, 1, mode="reflect")
        sm = 0.25 * p[:-2, 1:-1] + 0.5 * p[1:-1, 1:-1] + 0.25 * p[2:, 1:-1]
        sm = 0.25 * sm[:, :-2] + 0.5 * sm[:, 1:-1] + 0.25 * sm[:, 2:]
    return sm


def shifted_pair(seed: int, dx: int, dy: int, h: int = 270, w: int = 480):
    """u8 frames a, b of one texture with b(x, y) = a(x + dx, y + dy)."""
    sm = smooth_texture(seed, h + 2 * 50, w + 2 * 50)
    sm = np.clip(np.floor(sm + 0.5), 0, 255).astype(np.uint8)
    a = sm[50 : 50 + h, 50 : 50 + w]
    b = sm[50 + dy : 50 + dy + h, 50 + dx : 50 + dx + w]
    return a, b


def lattice_pair(seed: int, dx: int, dy: int, h: int = 270, w: int = 480, cell: int = 6):
    """u8 frames a, b with b(x, y) = a(x + dx, y + dy) of a coarser texture
    (chip_smoke.py's): a random lattice of spacing `cell` px blurred by four
    [1/4, 1/2, 1/4] passes, bilinear between its nodes, scaled to [10, 245].
    LK follows a (+40, +3) shift on it through the pyramid for about half
    the grid, so the grid-anchored slabs' envelope is reached."""
    ly, lx = (h + abs(dy)) // cell + 10, (w + abs(dx)) // cell + 10
    lat = np.random.RandomState(seed).uniform(0, 1, (ly, lx))
    for _ in range(4):
        p = np.pad(lat, 1, mode="edge")
        lat = 0.25 * p[:-2, 1:-1] + 0.5 * p[1:-1, 1:-1] + 0.25 * p[2:, 1:-1]
        p = np.pad(lat, 1, mode="edge")
        lat = 0.25 * p[1:-1, :-2] + 0.5 * p[1:-1, 1:-1] + 0.25 * p[1:-1, 2:]
    lat = 10.0 + 235.0 * (lat - lat.min()) / (lat.max() - lat.min())

    def frame(ox, oy):
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
        u, v = (xx + ox) / cell + 4.0, (yy + oy) / cell + 4.0
        iu, iv = np.floor(u).astype(int), np.floor(v).astype(int)
        fu, fv = u - iu, v - iv
        img = (lat[iv, iu] * (1 - fu) * (1 - fv) + lat[iv, iu + 1] * fu * (1 - fv)
               + lat[iv + 1, iu] * (1 - fu) * fv + lat[iv + 1, iu + 1] * fu * fv)
        return np.floor(img + 0.5).astype(np.uint8)

    return frame(0, 0), frame(dx, dy)


@pytest.mark.parametrize("n,pad", [(5, 2), (5, 9), (7, 70), (3, 11)])
def test_reflect101_pad_matches_numpy(n, pad):
    x = np.arange(n * (n + 1), dtype=np.float32).reshape(n, n + 1)
    ref = np.pad(x, pad, mode="reflect")
    got = reflect101_pad(torch.from_numpy(x), pad).numpy()
    assert np.array_equal(ref, got)


# JAX's CPU sep_conv2d runs the y pass first, the port the x pass (ROADMAP
# fault 5): unrounded levels of values up to 255 differ by a few float32
# ulps there
PYR_ATOL = 4 * float(np.spacing(np.float32(255.0)))


@pytest.mark.parametrize("quantize_u8", [None, True], ids=["default", "u8"])
@pytest.mark.parametrize("shape", [(37, 50), (36, 64), (2, 37, 51)])
def test_pyramid_matches_jax(shape, quantize_u8):
    """pyr_down and build_pyramid on uniform float input, odd and even
    sizes, at their default (the unrounded pyrDown) and with quantize_u8:
    the u8 levels identical, the unrounded within PYR_ATOL."""
    x = np.random.RandomState(0).uniform(0, 255, shape).astype(np.float32)
    kw = {} if quantize_u8 is None else {"quantize_u8": quantize_u8}
    want = [np.asarray(lv) for lv in jpyr.build_pyramid(jnp.asarray(x), 3, **kw)]
    got = [lv.numpy() for lv in tpyr.build_pyramid(torch.from_numpy(x), 3, **kw)]
    down = tpyr.pyr_down(torch.from_numpy(x), **kw).numpy()
    assert np.array_equal(down, got[1])
    assert np.array_equal(np.asarray(jpyr.pyr_down(jnp.asarray(x), **kw)), want[1])
    for lv, (w, g) in enumerate(zip(want, got)):
        assert g.dtype == np.float32 and g.shape == w.shape, lv
        if quantize_u8:
            assert np.array_equal(g, w), lv
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=PYR_ATOL)
    if quantize_u8 is None:
        assert not np.array_equal(got[1], np.floor(got[1] + 0.5))  # unrounded


@pytest.mark.parametrize("shape", [(270, 480), (271, 479)])
def test_prepare_frame_bit_exact(shape):
    img = np.clip(np.floor(smooth_texture(3, *shape) + 0.5), 0, 255).astype(np.uint8)
    ref = jlk.prepare_frame(jnp.asarray(img, jnp.float32), PARAMS)
    got = tlk.prepare_frame(torch.from_numpy(img), TPARAMS)
    assert tlk._frame_pad(TPARAMS) == jlk._frame_pad(PARAMS) == 70
    for field in ("img_p", "dix_p", "diy_p"):
        for lv in range(PARAMS.max_level + 1):
            r = np.asarray(getattr(ref, field)[lv])
            g = getattr(got, field)[lv].numpy()
            assert g.dtype == np.float32 and r.shape == g.shape, (field, lv)
            assert np.array_equal(r, g), (field, lv)


@pytest.mark.parametrize("level", [2, 1, 0])
def test_grid_templates_bit_exact(level):
    a, _ = shifted_pair(4, 0, 0)
    h, w = a.shape
    pts = measurement_grid(h, w, 30)
    xs = np.unique(pts[:, 0]).astype(int)
    ys = np.unique(pts[:, 1]).astype(int)
    pad = jlk._frame_pad(PARAMS)
    prep = jlk.prepare_frame(jnp.asarray(a, jnp.float32), PARAMS)
    planes = jnp.stack([prep.img_p[level], prep.dix_p[level], prep.diy_p[level]])
    # (3, win_h, WWP, N) i16 on the x32 grid -> (N, 3, win_h, win_w) f32
    ref = np.asarray(extract_grid_templates_lanes(planes, xs, ys, level, 45, 45, pad))
    ref = np.transpose(ref[:, :, :45, :], (3, 0, 1, 2)).astype(np.float32) / 32.0
    tp = convert.prepared_frame(prep)
    got = grid_templates(tp.img_p[level], tp.dix_p[level], tp.diy_p[level], xs, ys, level, 45, 45, pad).numpy()
    assert got.shape == (pts.shape[0], 3, 45, 45)
    assert np.array_equal(ref, got)
