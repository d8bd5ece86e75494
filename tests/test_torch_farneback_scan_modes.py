"""The port's Farneback clip scan in the coefficient warp modes against
the JAX package's, and the modes the scan refuses ("image", "hybrid").

The JAX references run as in tests/test_torch_farneback_modes.py: JAX's
loops as written, their per-level callees jitted and shared (the fixtures
and jitted callees come from there). JAX's lax.scan itself is compiled for
the packed mode only; in the pallas modes it would inline its 12
interpret-mode Pallas calls per step (about 15 s per mode), so those steps
are held to JAX's scan step function, farneback_prepared on the carried
pyramids, which the JAX package's own test holds to its scan."""

import numpy as np
import pytest
import torch

import jax

from hackathonopticalflow_tpu.flow import dense as jdense
from hackathonopticalflow_tpu_torch import core as tcore
from hackathonopticalflow_tpu_torch.flow import dense as tdense
from test_torch_farneback import H, W, _epe_ok
from test_torch_farneback_modes import (  # noqa: F401  (fixtures)
    COEF,
    _jparams,
    clip,
    jax_callees_jitted,
    jax_pairwise,
    jax_pyramids,
    jfb,
    tfb,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("mode", COEF)
def test_video_modes_match_jax_and_pairwise(clip, jax_pyramids, jax_pairwise, mode):
    """farneback_flow_video in the coefficient modes: each step within
    _epe_ok of JAX's scan step (farneback_prepared on the carried
    pyramids; the first also of JAX's pairwise farneback) and equal to the
    port's pairwise farneback."""
    params = tcore.FarnebackParams(warp_mode=mode)
    got = tdense.farneback_flow_video(torch.from_numpy(clip), params, device="cpu")
    assert got.shape == (len(clip) - 1, H, W, 2)
    _epe_ok(got[0].numpy(), jax_pairwise(mode, 0))
    for t in range(len(clip) - 1):
        step = np.asarray(jfb.farneback_prepared(jax_pyramids[t], jax_pyramids[t + 1], _jparams(mode)))
        _epe_ok(got[t].numpy(), step)
        pair = tfb.farneback(torch.from_numpy(clip[t]), torch.from_numpy(clip[t + 1]), params)
        assert torch.equal(got[t], pair)


def test_packed_scan_matches_jax_scan(clip):
    """In the packed mode JAX's own lax.scan is cheap to compile: the
    port's scan within _epe_ok of it."""
    params = _jparams("packed")
    want = np.asarray(jax.jit(lambda f: jdense.farneback_flow_video(f, params))(clip.astype(np.float32)))
    got = tdense.farneback_flow_video(torch.from_numpy(clip), tcore.FarnebackParams(warp_mode="packed"),
                                      device="cpu")
    _epe_ok(got.numpy(), want)


@pytest.mark.parametrize("mode", ["image", "hybrid"])
def test_reexpansion_modes_refuse_prepared_paths(clip, mode):
    """"image" and "hybrid" re-expand the frame inside the iteration: the
    prepared path and the clip scan refuse them, as JAX's assert does;
    farneback_flow runs them, batch rows equal to single pairs."""
    params = tcore.FarnebackParams(warp_mode=mode)
    frames = torch.from_numpy(clip[:3])
    rs = tfb.prepare_frame(frames[0], params)
    with pytest.raises(ValueError, match="coefficient warp modes"):
        tfb.farneback_prepared(rs, rs, params)
    with pytest.raises(ValueError, match="coefficient warp modes"):
        tdense.farneback_flow_video(frames, params, device="cpu")
    out = tdense.farneback_flow(frames[:2], frames[1:], params, device="cpu")
    for i in range(2):
        assert torch.equal(out[i], tdense.farneback_flow(frames[i], frames[i + 1], params, device="cpu"))


def test_auto_is_exact(clip):
    auto = tcore.FarnebackParams()
    assert auto.warp_mode == "auto"
    assert tfb.resolve_mode(auto).warp_mode == "exact"
    a, b = torch.from_numpy(clip[0]), torch.from_numpy(clip[1])
    assert torch.equal(tfb.farneback(a, b, auto), tfb.farneback(a, b, tcore.FarnebackParams(warp_mode="exact")))
