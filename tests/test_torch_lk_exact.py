"""PyTorch port vs the JAX package: the exact LK path (JAX's default
LKParams(): grid_step None, slab_margin None, no Pallas), each
iteration's window read straight from the plane (lk_level's "exact"
geometry), and the level-0 err the arbitrary-point paths give whatever
compute_err says.

The JAX references run once per module under jax.jit, on the step-30
grid of a 270x480 pair: a (+5, +3) and a (+40, +3) shift, the pairs of
tests/test_torch_lk.py (the exact path has no envelope to reach). Bars:
status identical, max endpoint |difference| <= 1e-3 px, err within 1e-3
grey levels where both statuses are true. The port sums A and b exactly
in float64 where JAX sums in float32; the window's fraction and blend
follow JAX's extract_patches (fraction of tl + pad, weights first), so
nothing else differs. (Points that wander tens of px within a level
amplify the summation difference: on the coarser lattice texture of
tests/test_torch_lk_anchored.py one reached 1.3e-3 px at level 0.)"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hackathonopticalflow_tpu.core import LKParams, measurement_grid
from hackathonopticalflow_tpu.ops import lk as jlk
from hackathonopticalflow_tpu_torch import convert
from hackathonopticalflow_tpu_torch import core as tcore
from hackathonopticalflow_tpu_torch.ops import lk as tlk
from test_torch_prepare import shifted_pair

torch.set_num_threads(1)

PARAMS = LKParams()
SHIFTS = {"shift_5_3": (5, 3), "shift_40_3": (40, 3)}
TOL_PX = 1e-3
TOL_ERR = 1e-3


@pytest.fixture(scope="module", params=list(SHIFTS))
def jax_chain(request):
    """The JAX exact path on one pair, level by level: each level's inputs
    (next_center, status) and outputs (and err at L0)."""
    a, b = shifted_pair(2, *SHIFTS[request.param])
    pts = measurement_grid(*a.shape, 30)
    prev = jlk.prepare_frame(jnp.asarray(a, jnp.float32), PARAMS)
    nxt = jlk.prepare_frame(jnp.asarray(b, jnp.float32), PARAMS)
    level_fn = jax.jit(jlk._level_lk, static_argnums=(5, 6))
    center = jnp.asarray(pts) * jnp.float32(1.0 / (1 << PARAMS.max_level))
    status = jnp.ones(pts.shape[0], bool)
    levels = {}
    for level in range(PARAMS.max_level, -1, -1):
        if level != PARAMS.max_level:
            center = center * 2.0
        out_c, out_s, out_e = level_fn(prev, nxt, jnp.asarray(pts), center, status, level, PARAMS)
        levels[level] = tuple(np.array(v) for v in (center, status, out_c, out_s, out_e))
        center, status = out_c, out_s
    return dict(frames=(a, b), pts=pts, prev=prev, nxt=nxt, levels=levels)


@pytest.mark.parametrize("level", [2, 1, 0])
def test_level_matches_jax(jax_chain, level):
    """One level of the port's exact path on the JAX package's prepared
    frames and level inputs."""
    c_in, s_in, c_ref, s_ref, e_ref = jax_chain["levels"][level]
    params = tcore.LKParams()
    prev = convert.prepared_frame(jax_chain["prev"])
    nxt = convert.prepared_frame(jax_chain["nxt"])
    pts = torch.from_numpy(jax_chain["pts"])
    args, kw, _ = tlk.point_level_inputs(prev, nxt, pts, torch.from_numpy(c_in), level, params)
    assert kw["geometry"] == "exact"
    c, s, e = tlk._level_lk(prev, nxt, pts, torch.from_numpy(c_in), torch.from_numpy(s_in), level, params)
    assert np.array_equal(s.numpy(), s_ref)
    assert np.abs(c.numpy() - c_ref).max() <= TOL_PX
    if level == 0:
        both = s.numpy() & s_ref
        assert both.sum() >= 100
        assert np.abs(e.numpy() - e_ref)[both].max() <= TOL_ERR
        assert not e.numpy()[~s.numpy()].any()
    else:
        assert e is None


@pytest.mark.parametrize("compute_err", [True, False])
def test_pyr_lk_matches_jax(jax_chain, compute_err):
    """pyr_lk on the raw frames vs the JAX level chain's end. JAX's exact
    path gives err whatever compute_err says, and so does the port."""
    a, b = jax_chain["frames"]
    params = tcore.LKParams(compute_err=compute_err)
    res = tlk.pyr_lk(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(jax_chain["pts"]), params)
    _, _, c_ref, s_ref, e_ref = jax_chain["levels"][0]
    assert np.array_equal(res.status.numpy(), s_ref)
    assert np.abs(res.next_pts.numpy() - c_ref).max() <= TOL_PX
    both = res.status.numpy() & s_ref
    assert (res.err.numpy()[both] > 0).all()
    assert np.abs(res.err.numpy() - e_ref)[both].max() <= TOL_ERR

