"""The port's Farneback warp modes against the JAX package's: the slab
geometry of `warp_bilinear` against the TPU kernel warp_bilinear_pallas
(interpret mode), the cumsum box, the packed warp, the prewarped update
and farneback in each mode (the clip scan's modes:
tests/test_torch_farneback_scan_modes.py).

Inputs come from numpy seeds; the clip is tests/test_torch_farneback.py's
144x256 smooth zoom-and-drift clip. JAX's farneback loops run as the JAX
package wrote them, eagerly, with their per-level callees (blur, resize,
expansion, matrix updates, solve, frame warp) replaced by jitted versions
of themselves, shared by the module: each compiles once per level shape
and mode. Compiling the whole loop at once would inline its 12 Pallas
calls, about 12 s per pallas mode. The pallas modes' JAX reference runs
with warp_group_rows=96 (one row group, no gating), which compiles in a
third of the time; test_pallas_row_gating_drops_no_weight shows that the
gating of the default 16-row groups never changes the result."""

import importlib
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hackathonopticalflow_tpu.core.config import FarnebackParams as JFarnebackParams
from hackathonopticalflow_tpu.ops import warp as jwarp
from hackathonopticalflow_tpu.ops.warp_pallas import warp_bilinear_pallas
from hackathonopticalflow_tpu_torch import convert
from hackathonopticalflow_tpu_torch import core as tcore
from hackathonopticalflow_tpu_torch.flow import dense as tdense
from hackathonopticalflow_tpu_torch.ops import warp as twarp
from hackathonopticalflow_tpu_torch.ops.warp_bilinear import (
    _corners,
    slab_origins,
    warp_bilinear,
    warp_bilinear_reference,
)
from test_torch_farneback import DRIFT, H, W, _clip, _epe_ok, _rel_per_channel, _smooth_flow

# each package's ops/__init__ re-exports a function named farneback
tfb = importlib.import_module("hackathonopticalflow_tpu_torch.ops.farneback")
jfb = importlib.import_module("hackathonopticalflow_tpu.ops.farneback")

torch.set_num_threads(1)

COEF = ["packed", "pallas", "pallas_bf16"]
MODES = COEF + ["image", "hybrid"]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
EPS32 = float(np.finfo(np.float32).eps)

_JITTED = {
    "gaussian_blur": jax.jit(jfb.gaussian_blur, static_argnums=(1, 2)),
    "resize_bilinear": jax.jit(jfb.resize_bilinear, static_argnums=(1, 2)),
    "poly_exp": jax.jit(jfb.poly_exp, static_argnums=(1, 2)),
    "update_matrices": jax.jit(jfb.update_matrices, static_argnames=("mode", "group_rows")),
    "update_matrices_prewarped": jax.jit(jfb.update_matrices_prewarped),
    "_solve_flow": jax.jit(jfb._solve_flow, static_argnums=(1,)),
}
_JWARP_IMAGE = jax.jit(jwarp.warp_image)
_JBLUR = jax.jit(jfb.update_flow_blur, static_argnums=(1, 2))


@pytest.fixture(scope="module", autouse=True)
def jax_callees_jitted():
    with mock.patch.multiple(jfb, **_JITTED), mock.patch.object(jwarp, "warp_image", _JWARP_IMAGE):
        yield


def _jparams(mode: str) -> JFarnebackParams:
    return JFarnebackParams(warp_mode=mode, warp_group_rows=96)


@pytest.fixture(scope="module")
def clip():
    return _clip()


@pytest.fixture(scope="module")
def jax_pyramids(clip):
    return [jfb.prepare_frame(jnp.asarray(clip[t], jnp.float32), _jparams("exact")) for t in range(len(clip))]


# ---- the slab geometry against the TPU kernel ----


def _warp_case(h, w, spread, seed):
    """(C=5, h, w) source and absolute coordinates: smooth in-margin flow,
    or flow whose spread inside an (8, 128) tile passes the 72 / 128 px
    margins."""
    rng = np.random.RandomState(seed)
    src = (rng.randn(5, h, w) * 10).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    amp = 150.0 if spread else 3.0
    fx = xx + amp * np.sin(yy / 3.0 + xx / 17.0) + rng.uniform(-2, 2, (h, w))
    fy = yy + amp * np.cos(xx / 5.0) + rng.uniform(-2, 2, (h, w))
    return src, fx.astype(np.float32), fy.astype(np.float32)


def _clamped(fx, fy, h, w) -> np.ndarray:
    """Pixels whose slab sample is not their own corner (clamped)."""
    x0, y0, _, _ = _corners(torch.from_numpy(fx), torch.from_numpy(fy), h, w)
    ys, xs = slab_origins(x0.long(), y0.long())
    return ((ys != y0.long()) | (xs != x0.long())).numpy()


@pytest.mark.parametrize("spread", [False, True], ids=["in_margin", "spread"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("hw", [(20, 200), (90, 160)])
def test_slab_matches_pallas_kernel(hw, dtype, spread):
    """The slab plain version against warp_bilinear_pallas (interpret mode)
    at ragged shapes, float32 and bf16 source. Tolerance 2 float32 ulps of
    the source's scale: XLA's CPU backend contracts the kernel's x-lerp
    (1-ax) t0 + ax t1 into one fused multiply-add, which the port rounds
    as two products and a sum (as its CUDA kernel does, -fmad=false)."""
    h, w = hw
    src, fx, fy = _warp_case(h, w, spread, seed=h + w + spread)
    jdt, tdt = DTYPES[dtype]
    want = np.asarray(warp_bilinear_pallas(jnp.asarray(src), jnp.asarray(fx), jnp.asarray(fy),
                                           slab_dtype=jdt, group_rows=96))
    args = (torch.from_numpy(src).to(tdt), torch.from_numpy(fx), torch.from_numpy(fy))
    got = warp_bilinear(*args, "slab").numpy()
    assert np.array_equal(got, warp_bilinear_reference(*args, "slab").numpy())
    tol = 2 * EPS32 * np.abs(src).max()
    assert np.abs(got - want).max() <= tol
    gather = warp_bilinear(*args, "gather").numpy()
    clamped = _clamped(fx, fy, h, w)
    if spread:
        # the clamp shows: a large share of pixels sample the slab's edge,
        # far from the exact gather's values
        assert clamped.mean() > 0.3
        assert np.abs(gather - want)[:, clamped].max() > 100 * tol
    else:
        assert not clamped.any()
    assert np.abs(gather - want)[:, ~clamped].max() <= tol


def test_pallas_row_gating_drops_no_weight():
    """The TPU kernel gates its 16-row groups by the tile's live row bound
    (warp_pallas.py:181-197); with one 96-row group nothing is gated. The
    two agree bit for bit, with clamped tiles: the gating never skips a
    row that carries weight, so the port has no gating."""
    src, fx, fy = _warp_case(90, 160, True, seed=5)
    args = (jnp.asarray(src), jnp.asarray(fx), jnp.asarray(fy))
    gated = np.asarray(warp_bilinear_pallas(*args, group_rows=16))
    whole = np.asarray(warp_bilinear_pallas(*args, group_rows=96))
    assert np.array_equal(gated, whole)
    assert _clamped(fx, fy, 90, 160).mean() > 0.3


@pytest.mark.parametrize("hw", [(20, 200), (90, 160), (144, 256), (2, 2), (9, 300)])
def test_slab_samples_stay_in_plane(hw):
    """Every slab sample's four corners lie inside the plane, whatever the
    flow: a clamped sample lies between the slab's base and the pixel's own
    corner, so the TPU kernel's zero padding is never read."""
    h, w = hw
    rng = np.random.RandomState(h * w)
    for amp in (0.5, 40.0, 1e3, 1e6):
        fx = rng.uniform(-amp, w + amp, (3, h, w)).astype(np.float32)
        fy = rng.uniform(-amp, h + amp, (3, h, w)).astype(np.float32)
        x0, y0, _, _ = _corners(torch.from_numpy(fx), torch.from_numpy(fy), h, w)
        ys, xs = slab_origins(x0.long(), y0.long())
        assert int(ys.min()) >= 0 and int(ys.max()) <= h - 2
        assert int(xs.min()) >= 0 and int(xs.max()) <= w - 2


def test_slab_batch_rows_equal_single():
    src, fx, fy = _warp_case(20, 200, True, seed=9)
    s = torch.from_numpy(np.stack([src, src[::-1].copy()]))
    x = torch.from_numpy(np.stack([fx, fy]))
    y = torch.from_numpy(np.stack([fy, fx]))
    out = warp_bilinear(s, x, y, "slab")
    for i in range(2):
        assert torch.equal(out[i], warp_bilinear(s[i], x[i], y[i], "slab"))
    with pytest.raises(ValueError, match="geometry"):
        warp_bilinear(s, x, y, "tiles")
    with pytest.raises(TypeError):
        warp_bilinear(s.half(), x, y, "slab")


# ---- the box sums, the packed warp, the matrix updates ----


@pytest.mark.parametrize("win", [15, 5])
def test_cumsum_box_matches_jax(jax_pyramids, win):
    """The integral-image box against JAX's, on the M of the clip's finest
    level at a smooth flow. Its running sums round differently per backend
    (XLA sums in float32 by windows, torch's CPU cumsum accumulates in
    float64): EPE within _epe_ok. The port's doubling box gives the same
    flow within the same bar."""
    r0, r1 = convert.farneback_pyramid((jax_pyramids[0][-1], jax_pyramids[1][-1]))
    m = tfb.update_matrices(r0, r1, torch.from_numpy(_smooth_flow(H, W, 1.0, 8)))
    got = tfb.update_flow_blur(m, win, "cumsum").numpy()
    want = np.asarray(_JBLUR(m.numpy(), win, "cumsum"))
    _epe_ok(got, want)
    _epe_ok(tfb.update_flow_blur(m, win).numpy(), want)


def test_cumsum_box_rejects_even_window():
    m = torch.zeros((5, 20, 30))
    with pytest.raises(ValueError, match="odd win_size"):
        tfb.update_flow_blur(m, 14, "cumsum")
    with pytest.raises(ValueError, match="box method"):
        tfb.update_flow_blur(m, 15, "prefix")


def test_packed_warp_matches_jax(jax_pyramids):
    """warp_source("packed") rounds channels 0-3 to bf16 as JAX's astype
    does (bit for bit) and keeps channel 4; the gather warp of it matches
    JAX's _warp5_packed on pixels inside the frame."""
    r1j = jax_pyramids[1][-1]
    r1 = torch.from_numpy(np.array(r1j))
    src = tfb.warp_source(r1, "packed")
    want_src = np.asarray(r1j[:4].astype(jnp.bfloat16).astype(jnp.float32))
    assert np.array_equal(src[:4].numpy(), want_src)
    assert torch.equal(src[4], r1[4])
    flow = _smooth_flow(H, W, 5.0, 4)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    fx, fy = xx + flow[..., 0], yy + flow[..., 1]
    x1, y1 = np.floor(fx), np.floor(fy)
    inside = (x1 >= 0) & (x1 < W - 1) & (y1 >= 0) & (y1 < H - 1)
    got = warp_bilinear(src, torch.from_numpy(fx), torch.from_numpy(fy)).numpy()

    def jpacked(r, fx, fy):
        x1, y1 = jnp.floor(fx), jnp.floor(fy)
        x1i = jnp.clip(x1.astype(jnp.int32), 0, W - 2)
        y1i = jnp.clip(y1.astype(jnp.int32), 0, H - 2)
        return jfb._warp5_packed(r, y1i, x1i, fx - x1, fy - y1, H, W)

    want = np.asarray(jax.jit(jpacked)(r1j, fx, fy))
    assert 0.02 < (~inside).mean() < 0.5
    assert np.abs(got - want)[:, inside].max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("mode", COEF)
def test_update_matrices_modes_match_jax(jax_pyramids, mode):
    """M of each coefficient mode on the same converted pyramids, with a
    flow past every border: within 1e-5 of each channel's scale."""
    r0j, r1j = jax_pyramids[0][-1], jax_pyramids[1][-1]
    r0, r1 = convert.farneback_pyramid((r0j, r1j))
    flow = _smooth_flow(H, W, 5.0, 4)
    got = tfb.update_matrices(r0, r1, torch.from_numpy(flow), mode).numpy()
    want = np.asarray(jfb.update_matrices(r0j, r1j, flow, mode=mode, group_rows=96))
    _rel_per_channel(got, want, 1e-5)


def test_update_matrices_prewarped_matches_jax(jax_pyramids):
    r0j, r1j = jax_pyramids[0][-2], jax_pyramids[1][-2]
    r0, r1 = convert.farneback_pyramid((r0j, r1j))
    flow = _smooth_flow(*r0j.shape[-2:], 6.0, 11)
    got = tfb.update_matrices_prewarped(r0, r1, torch.from_numpy(flow)).numpy()
    want = np.asarray(jfb.update_matrices_prewarped(r0j, r1j, flow))
    _rel_per_channel(got, want, 1e-5)


def test_warp_image_batch_rows_equal_single(clip):
    img = torch.from_numpy(clip[:2].astype(np.float32))
    flow = torch.from_numpy(np.stack([_smooth_flow(H, W, 6.0, 12), _smooth_flow(H, W, 3.0, 13)]))
    out = twarp.warp_image(img, flow)
    assert out.shape == (2, H, W)
    for i in range(2):
        assert torch.equal(out[i], twarp.warp_image(img[i], flow[i]))
    # one image, several flows: broadcast over the flows' batch
    assert torch.equal(twarp.warp_image(img[0], flow)[1], twarp.warp_image(img[0], flow[1]))


# ---- farneback and the clip scan ----


@pytest.fixture(scope="module")
def jax_pairwise(clip):
    """JAX's farneback on each consecutive pair, per mode (lazily)."""
    cache = {}

    def get(mode, t):
        if (mode, t) not in cache:
            a, b = (jnp.asarray(clip[i], jnp.float32) for i in (t, t + 1))
            cache[mode, t] = np.asarray(jfb.farneback(a, b, _jparams(mode)))
        return cache[mode, t]

    return get


@pytest.mark.parametrize("mode", MODES)
def test_farneback_matches_jax(clip, jax_pairwise, mode):
    """Each warp mode against JAX's on the clip's first pair: within
    _epe_ok, the bar JAX's exact path meets against cv2."""
    params = tcore.FarnebackParams(warp_mode=mode)
    got = tfb.farneback(torch.from_numpy(clip[0]), torch.from_numpy(clip[1]), params).numpy()
    want = jax_pairwise(mode, 0)
    assert got.shape == want.shape == (H, W, 2)
    _epe_ok(got, want)
    assert np.abs(want.mean(axis=(0, 1)) - DRIFT).max() < 0.2


@pytest.mark.parametrize("mode", MODES + ["exact", "auto"])
def test_convert_carries_every_mode(mode):
    params = convert.farneback_params(JFarnebackParams(warp_mode=mode, warp_group_rows=8))
    assert params == tcore.FarnebackParams(warp_mode=mode)
