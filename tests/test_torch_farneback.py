"""PyTorch port vs the JAX package: dense image primitives, the coefficient
warp, Farneback and the dense clip scan.

Inputs are smooth textures (numpy seed) zoomed about the centre and
drifting, at 144x256: noise frames make the damped 2x2 solve amplify
float32 reassociation (JAX's own scan-vs-pairwise test needs 2e-3 px on
noise). The JAX reference is warp_mode="exact" on the CPU; its Pallas warp
runs in interpret mode. JAX calls are jitted and shared per module. The
other warp modes: tests/test_torch_farneback_modes.py."""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hackathonopticalflow_tpu.core.config import FarnebackParams as JFarnebackParams
from hackathonopticalflow_tpu.core.config import NormalizeParams as JNormalizeParams
from hackathonopticalflow_tpu.flow import dense as jdense
from hackathonopticalflow_tpu.nav.normalize import radial_normalize_dense as j_radial_normalize_dense
from hackathonopticalflow_tpu.ops import image as jimage
from hackathonopticalflow_tpu.ops import warp as jwarp
from hackathonopticalflow_tpu.ops.warp_pallas import warp_bilinear_pallas
from hackathonopticalflow_tpu_torch import convert
from hackathonopticalflow_tpu_torch import core as tcore
from hackathonopticalflow_tpu_torch.flow import dense as tdense
from hackathonopticalflow_tpu_torch.nav.normalize import radial_normalize_dense
from hackathonopticalflow_tpu_torch.ops import image as timage
from hackathonopticalflow_tpu_torch.ops import warp as twarp
from hackathonopticalflow_tpu_torch.ops.warp_bilinear import warp_bilinear, warp_bilinear_reference
from test_torch_prepare import smooth_texture

# each package's ops/__init__ re-exports a function named farneback
tfb = importlib.import_module("hackathonopticalflow_tpu_torch.ops.farneback")
jfb = importlib.import_module("hackathonopticalflow_tpu.ops.farneback")

torch.set_num_threads(1)

H, W = 144, 256
JPARAMS = JFarnebackParams(warp_mode="exact")
TPARAMS = tcore.FarnebackParams()
ZOOM = 1.01
DRIFT = (1.0, 0.5)  # px per frame (x, y)


def _clip(n: int = 4) -> np.ndarray:
    """(n, H, W) u8: a smooth texture zoomed by ZOOM**t about the centre
    and drifting by t*DRIFT (bilinear in float64, rounded)."""
    sm = smooth_texture(11, H + 60, W + 60)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    frames = []
    for t in range(n):
        s = ZOOM**t
        x = cx + (xx - cx) / s + 30 - t * DRIFT[0]
        y = cy + (yy - cy) / s + 30 - t * DRIFT[1]
        x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
        ax, ay = x - x0, y - y0
        v = (
            sm[y0, x0] * (1 - ax) * (1 - ay)
            + sm[y0, x0 + 1] * ax * (1 - ay)
            + sm[y0 + 1, x0] * (1 - ax) * ay
            + sm[y0 + 1, x0 + 1] * ax * ay
        )
        frames.append(np.clip(np.floor(v + 0.5), 0, 255).astype(np.uint8))
    return np.stack(frames)


@pytest.fixture(scope="module")
def clip():
    return _clip()


@pytest.fixture(scope="module")
def jax_pyramids(clip):
    prep = jax.jit(lambda f: jfb.prepare_frame(f, JPARAMS))
    return [tuple(np.asarray(r) for r in prep(clip[t].astype(np.float32))) for t in range(2)]


def _epe_ok(got: np.ndarray, want: np.ndarray):
    """The bar JAX itself meets against cv2 (tests/test_farneback.py)."""
    epe = np.linalg.norm(got - want, axis=-1)
    assert epe.mean() <= 1e-3, epe.mean()
    assert epe.max() <= 0.05, epe.max()


def _rel_per_channel(got: np.ndarray, want: np.ndarray, tol: float):
    """max |got - want| <= tol * max |want|, per channel (axis -3)."""
    for c in range(want.shape[-3]):
        scale = np.abs(want[..., c, :, :]).max()
        err = np.abs(got[..., c, :, :] - want[..., c, :, :]).max()
        assert err <= tol * scale, (c, err, scale)


# ---- dense image primitives ----


@pytest.mark.parametrize(
    "ksize,sigma", [(3, 0.0), (5, 0.0), (7, 0.0), (9, 1.5), (19, 3.5), (15, -1.0)]
)
def test_gaussian_kernel1d_matches_jax(ksize, sigma):
    got = np.asarray(timage.gaussian_kernel1d(ksize, sigma), np.float32)
    assert np.array_equal(got, np.asarray(jimage.gaussian_kernel1d(ksize, sigma)))


@pytest.mark.parametrize("ksize,sigma", [(3, 0.0), (9, 1.5), (19, 3.5)])
def test_gaussian_blur_matches_jax(clip, ksize, sigma):
    img = clip[0].astype(np.float32)
    got = timage.gaussian_blur(torch.from_numpy(img), ksize, sigma).numpy()
    want = np.asarray(jimage.gaussian_blur(jnp.asarray(img), ksize, sigma))
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("ky,kx", [([0.2, 0.5, 0.3], [0.1, 0.2, 0.4, 0.2, 0.1]), ([1.0], [0.25, 0.5, 0.25])])
def test_sep_conv2d_edge_matches_jax(clip, ky, kx):
    img = clip[1].astype(np.float32)
    ky32 = [float(v) for v in np.float32(ky)]
    kx32 = [float(v) for v in np.float32(kx)]
    got = timage.sep_conv2d(torch.from_numpy(img), ky32, kx32, mode="edge").numpy()
    want = np.asarray(jimage.sep_conv2d(jnp.asarray(img), np.float32(ky), np.float32(kx), mode="edge"))
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("ksize", [15, 5])
def test_box_sum_matches_jax(clip, ksize):
    img = np.stack([clip[0], clip[1]]).astype(np.float32)
    got = timage.box_sum(torch.from_numpy(img), ksize).numpy()
    want = np.asarray(jax.jit(lambda x: jimage.box_sum(x, ksize))(img))
    assert np.abs(got - want).max() <= 1e-4 * ksize * ksize  # sums of ksize^2 values in [0, 255]


@pytest.mark.parametrize("out_hw", [(72, 128), (18, 32), (100, 171), (288, 512)])
def test_resize_bilinear_matches_jax(clip, out_hw):
    img = clip[0].astype(np.float32)
    got = timage.resize_bilinear(torch.from_numpy(img), *out_hw).numpy()
    want = np.asarray(jax.jit(lambda x: jimage.resize_bilinear(x, *out_hw))(img))
    assert got.shape == want.shape == out_hw
    assert np.abs(got - want).max() <= 1e-4


@pytest.mark.parametrize("out_hw", [(18, 32), (50, 90), (288, 512)])
def test_resize_area_matches_jax(clip, out_hw):
    img = np.stack([clip[0], clip[2]]).astype(np.float32)
    got = timage.resize_area(torch.from_numpy(img), *out_hw).numpy()
    want = np.asarray(jax.jit(lambda x: jimage.resize_area(x, *out_hw))(img))
    assert got.shape == want.shape == (2, *out_hw)
    assert np.abs(got - want).max() <= 1e-4


# ---- Farneback building blocks ----


def test_constants_match_jax():
    for n, sigma in [(5, 1.2), (7, 1.5), (5, 0.0)]:
        got, want = tfb._poly_exp_consts(n, sigma), jfb._poly_exp_consts(n, sigma)
        for a, b in zip(got, want):
            assert np.array_equal(np.asarray(a), np.asarray(b))
    for win in (15, 21):
        assert np.array_equal(tfb._gauss_win_kernel(win), jfb._gauss_win_kernel(win))
    for h, w in [(144, 256), (3, 4)]:
        got = tfb._border_factor(h, w, torch.device("cpu")).numpy()
        assert np.array_equal(got, np.asarray(jfb._border_factor(h, w)))


@pytest.mark.parametrize("hw", [(720, 1280), (144, 256), (271, 479)])
def test_level_shapes_match_jax(hw):
    got = tfb._level_shapes(*hw, TPARAMS)
    assert got == jfb._level_shapes(*hw, JPARAMS)
    if hw == (720, 1280):
        # round() halves to even: 19, 9 and 3 taps, then sigma 0 at level
        # 0 -> the fixed [1/4, 1/2, 1/4] table
        assert [(hk, wk, ks) for hk, wk, _, ks in got] == [
            (90, 160, 19), (180, 320, 9), (360, 640, 3), (720, 1280, 3)
        ]
        assert timage.gaussian_kernel1d(3, got[-1][2]) == [0.25, 0.5, 0.25]


def test_poly_exp_matches_jax(clip):
    img = clip[0].astype(np.float32)
    got = tfb.poly_exp(torch.from_numpy(img), 5, 1.2).numpy()
    want = np.asarray(jfb.poly_exp(jnp.asarray(img), 5, 1.2))
    assert got.shape == want.shape == (5, H, W)
    _rel_per_channel(got, want, 1e-5)


def test_prepare_frame_matches_jax(clip, jax_pyramids):
    """2e-5 of each channel's scale, twice poly_exp's bar: the blur and
    resize before it already differ by up to 6e-5 on 0-255 data (JAX's CPU
    branch convolves y first, the port x first), and a_yy / a_xx =
    b1 ig03 + b_k ig33 cancel most at the smooth coarse levels."""
    got = tfb.prepare_frame(torch.from_numpy(clip[0]), TPARAMS)
    assert len(got) == len(jax_pyramids[0]) == 4
    for g, want in zip(got, jax_pyramids[0]):
        assert g.shape == want.shape
        _rel_per_channel(g.numpy(), want, 2e-5)


def _smooth_flow(h, w, amp, seed):
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    ph = np.random.RandomState(seed).uniform(0, 6, 4)
    dx = amp * (np.sin(yy / 7.0 + ph[0]) + np.cos(xx / 11.0 + ph[1]))
    dy = amp * (np.cos(xx / 9.0 + ph[2]) - np.sin(yy / 5.0 + ph[3]))
    return np.stack([dx, dy], -1).astype(np.float32)


def test_warp_reference_matches_pallas_and_gather():
    """warp_bilinear_reference vs the TPU kernel (interpret mode) and the
    exact gather, on in-margin flow, 48x192, C = 5."""
    rng = np.random.RandomState(0)
    h, w, c = 48, 192, 5
    src = rng.randn(c, h, w).astype(np.float32) * 10
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    fx = xx + 3.0 * np.sin(yy / 17.0) + 2.5 * np.cos(xx / 29.0) - 4.0
    fy = yy + 2.0 * np.cos(xx / 23.0) - 1.7 * np.sin(yy / 13.0)
    got = warp_bilinear_reference(*map(torch.from_numpy, (src, fx, fy))).numpy()
    pallas = np.asarray(warp_bilinear_pallas(jnp.asarray(src), jnp.asarray(fx), jnp.asarray(fy)))
    gather = np.asarray(jax.jit(jwarp.bilinear_sample)(src, fx, fy))
    inside = (np.floor(fx) >= 0) & (np.floor(fx) < w - 1) & (np.floor(fy) >= 0) & (np.floor(fy) < h - 1)
    assert inside.mean() > 0.8
    assert np.abs(got - pallas)[:, inside].max() <= 1e-4
    assert np.abs(got - gather)[:, inside].max() <= 1e-4


def test_warp_bilinear_plain_on_cpu_and_checks_inputs():
    rng = np.random.RandomState(1)
    src = torch.from_numpy(rng.randn(2, 5, 9, 13).astype(np.float32))
    fx = torch.from_numpy(rng.uniform(-3, 15, (2, 9, 13)).astype(np.float32))
    fy = torch.from_numpy(rng.uniform(-3, 11, (2, 9, 13)).astype(np.float32))
    before = warp_bilinear.launches
    out = warp_bilinear(src, fx, fy)
    assert warp_bilinear.launches == before
    assert torch.equal(out, warp_bilinear_reference(src, fx, fy))
    # batch rows are independent: each equals the unbatched call
    assert torch.equal(out[1], warp_bilinear(src[1], fx[1], fy[1]))
    # out-of-range samples clamp corners and fractions: finite, and equal
    # to the border pixel beyond the far corner
    assert torch.isfinite(out).all()
    far = warp_bilinear(src, torch.full_like(fx, 100.0), torch.full_like(fy, 100.0))
    assert torch.equal(far, src[..., -1:, -1:].expand_as(src))
    with pytest.raises(ValueError, match="H >= 2"):
        warp_bilinear(src[..., :1, :], fx[..., :1, :], fy[..., :1, :])
    with pytest.raises(ValueError, match="contiguous"):
        warp_bilinear(src, fx.transpose(-1, -2).contiguous().transpose(-1, -2), fy)
    with pytest.raises(ValueError, match="shape"):
        warp_bilinear(src, fx[:, :, :-1].contiguous(), fy)
    with pytest.raises(TypeError):
        warp_bilinear(src.double(), fx, fy)


def test_bilinear_sample_and_warp_image_match_jax(clip):
    img = clip[0].astype(np.float32)
    flow = _smooth_flow(H, W, 6.0, 3)  # reaches past every border
    got = twarp.warp_image(torch.from_numpy(img), torch.from_numpy(flow)).numpy()
    want = np.asarray(jax.jit(jwarp.warp_image)(img, flow))
    assert np.abs(got - want).max() <= 1e-4
    xs = np.linspace(-5, W + 5, 37, dtype=np.float32)
    ys = np.linspace(-5, H + 5, 23, dtype=np.float32)[:, None]
    stack = np.stack([clip[1], clip[2]]).astype(np.float32)
    got = twarp.bilinear_sample(torch.from_numpy(stack), torch.from_numpy(xs), torch.from_numpy(ys)).numpy()
    want = np.asarray(jax.jit(jwarp.bilinear_sample)(stack, xs, ys))
    assert got.shape == want.shape == (2, 23, 37)
    assert np.abs(got - want).max() <= 1e-4


def test_update_matrices_matches_jax(jax_pyramids):
    """On the same converted pyramids and a flow that pushes samples past
    every border: M within 1e-5 of each channel's scale. Outside the
    `inside` mask the warp's clamped fractions differ from JAX's unclamped
    ones, and M still agrees: _assemble_m discards those values."""
    r0j, r1j = jax_pyramids[0][-1], jax_pyramids[1][-1]
    r0, r1 = convert.farneback_pyramid((r0j, r1j))
    flow = _smooth_flow(H, W, 5.0, 4)
    got = tfb.update_matrices(r0, r1, torch.from_numpy(flow)).numpy()
    want = np.asarray(jax.jit(lambda a, b, f: jfb.update_matrices(a, b, f, mode="exact"))(r0j, r1j, flow))
    _rel_per_channel(got, want, 1e-5)

    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    fx, fy = xx + flow[..., 0], yy + flow[..., 1]
    x1, y1 = np.floor(fx), np.floor(fy)
    inside = (x1 >= 0) & (x1 < W - 1) & (y1 >= 0) & (y1 < H - 1)
    assert 0.02 < (~inside).mean() < 0.5
    warped = warp_bilinear_reference(r1, torch.from_numpy(fx), torch.from_numpy(fy)).numpy()
    # JAX's exact gather: clamped corners, unclamped fractions
    x0 = np.clip(x1.astype(int), 0, W - 2)
    y0 = np.clip(y1.astype(int), 0, H - 2)
    ax, ay = fx - x1, fy - y1
    r1n = r1.numpy()
    jgather = (
        r1n[:, y0, x0] * (1 - ax) * (1 - ay)
        + r1n[:, y0, x0 + 1] * ax * (1 - ay)
        + r1n[:, y0 + 1, x0] * (1 - ax) * ay
        + r1n[:, y0 + 1, x0 + 1] * ax * ay
    )
    scale = np.abs(r1n).max()
    assert np.abs(warped - jgather)[:, inside].max() <= 1e-5 * scale
    assert np.abs(warped - jgather)[:, ~inside].max() > 1e-2 * scale


def test_one_level_update_matches_jax(jax_pyramids):
    """One level isolated: the same converted pyramid level, the same flow,
    one matrix update and one box-filter solve."""
    r0j, r1j = jax_pyramids[0][-2], jax_pyramids[1][-2]
    r0, r1 = convert.farneback_pyramid((r0j, r1j))
    flow = _smooth_flow(*r0j.shape[-2:], 1.5, 5)

    def jstep(a, b, f):
        return jfb._solve_flow(jfb.update_matrices(a, b, f, mode="exact"), JPARAMS)

    want = np.asarray(jax.jit(jstep)(r0j, r1j, flow))
    got = tfb._solve_flow(tfb.update_matrices(r0, r1, torch.from_numpy(flow)), TPARAMS).numpy()
    _epe_ok(got, want)


# ---- Farneback and the clip scan ----


@pytest.mark.parametrize("variant", ["reference", "gaussian_win", "flow0"])
def test_farneback_matches_jax(clip, variant):
    extra = {"gaussian_win": True} if variant == "gaussian_win" else {}
    jp = dataclasses.replace(JPARAMS, **extra)
    tp = convert.farneback_params(jp)
    a, b = clip[0].astype(np.float32), clip[1].astype(np.float32)
    flow0 = _smooth_flow(H, W, 0.8, 6) if variant == "flow0" else None
    if flow0 is None:
        want = np.asarray(jax.jit(lambda x, y: jfb.farneback(x, y, jp))(a, b))
        got = tfb.farneback(torch.from_numpy(clip[0]), torch.from_numpy(clip[1]), tp)
    else:
        want = np.asarray(jax.jit(lambda x, y, f: jfb.farneback(x, y, jp, f))(a, b, flow0))
        got = tfb.farneback(torch.from_numpy(clip[0]), torch.from_numpy(clip[1]), tp, torch.from_numpy(flow0))
    assert got.shape == want.shape == (H, W, 2)
    _epe_ok(got.numpy(), want)
    # the flow is real: the mean over the frame is about the drift
    assert np.abs(want.mean(axis=(0, 1)) - DRIFT).max() < 0.2


def test_video_matches_jax_and_pairwise(clip):
    want = np.asarray(jax.jit(lambda f: jdense.farneback_flow_video(f, JPARAMS))(clip.astype(np.float32)))
    got = tdense.farneback_flow_video(torch.from_numpy(clip), TPARAMS, device="cpu")
    assert got.shape == want.shape == (3, H, W, 2)
    _epe_ok(got.numpy(), want)
    # eager torch does not reassociate: the scan equals pairwise farneback
    for t in range(3):
        pair = tfb.farneback(torch.from_numpy(clip[t]), torch.from_numpy(clip[t + 1]), TPARAMS)
        assert torch.equal(got[t], pair)


def test_farneback_flow_batch_rows_equal_single(clip):
    prev = torch.from_numpy(clip[:2])
    nxt = torch.from_numpy(clip[1:3])
    out = tdense.farneback_flow(prev, nxt, TPARAMS, device="cpu")
    assert out.shape == (2, H, W, 2)
    for i in range(2):
        assert torch.equal(out[i], tdense.farneback_flow(prev[i], nxt[i], TPARAMS, device="cpu"))


def test_radial_normalize_dense_matches_jax():
    flow = _smooth_flow(H, W, 3.0, 7)
    got = radial_normalize_dense(torch.from_numpy(flow), tcore.NormalizeParams()).numpy()
    want = np.asarray(j_radial_normalize_dense(jnp.asarray(flow), JNormalizeParams()))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)


def test_unknown_warp_mode_raises(clip):
    frames = torch.from_numpy(clip[:2])
    with pytest.raises(ValueError, match="unknown warp_mode"):
        tfb.farneback(frames[0], frames[1], tcore.FarnebackParams(warp_mode="fast"))
    with pytest.raises(ValueError, match="unknown warp_mode"):
        tdense.farneback_flow_video(frames, tcore.FarnebackParams(warp_mode="fast"), device="cpu")
