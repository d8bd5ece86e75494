"""PyTorch port vs the JAX package: the LK level and pyramidal grid LK.

The JAX side runs its production grid path on the CPU, its Pallas kernels
in interpret mode, once per module. Bars: status identical and max
endpoint |difference| < 0.05 px (the JAX package's own bar between its
kernels, which sum in other orders: tests/test_lk_static_grid.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hackathonopticalflow_tpu.core import LKParams, measurement_grid
from hackathonopticalflow_tpu.ops import lk as jlk
from hackathonopticalflow_tpu_torch import convert
from hackathonopticalflow_tpu_torch import core as tcore
from hackathonopticalflow_tpu_torch.ops import lk as tlk
from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level, lk_level_reference
from test_torch_prepare import shifted_pair

torch.set_num_threads(1)

PARAMS = LKParams(grid_step=30, use_pallas=True, compute_err=False)
TPARAMS = tcore.LKParams(grid_step=30, compute_err=False)
SHIFTS = {"shift_5_3": (5, 3), "shift_40_3": (40, 3)}
TOL_PX = 0.05


def _grid(h, w):
    pts = measurement_grid(h, w, PARAMS.grid_step)
    return pts, (np.unique(pts[:, 0]).astype(int), np.unique(pts[:, 1]).astype(int))


@pytest.fixture(scope="module", params=list(SHIFTS))
def jax_chain(request):
    """The JAX production grid path on one pair, level by level: each
    level's inputs (next_center, status) and outputs."""
    a, b = shifted_pair(2, *SHIFTS[request.param])
    pts, grid_xy = _grid(*a.shape)
    prev = jlk.prepare_frame(jnp.asarray(a, jnp.float32), PARAMS)
    nxt = jlk.prepare_frame(jnp.asarray(b, jnp.float32), PARAMS)
    center = jnp.asarray(pts) * jnp.float32(1.0 / (1 << PARAMS.max_level))
    status = jnp.ones(pts.shape[0], bool)
    levels = {}
    for level in range(PARAMS.max_level, -1, -1):
        if level != PARAMS.max_level:
            center = center * 2.0
        out_c, out_s, _ = jlk._level_lk_static_grid(
            prev, nxt, grid_xy, center, status, level, PARAMS
        )
        levels[level] = tuple(np.array(v) for v in (center, status, out_c, out_s))
        center, status = out_c, out_s
    return dict(frames=(a, b), pts=pts, grid_xy=grid_xy, prev=prev, nxt=nxt,
                levels=levels)


@pytest.mark.parametrize("level", [2, 1, 0])
def test_level_reference_matches_jax(jax_chain, level):
    """lk_level_reference on the JAX package's prepared frames and level
    inputs (through convert.py) vs JAX _level_lk_static_grid."""
    c_in, s_in, c_ref, s_ref = jax_chain["levels"][level]
    prev = convert.prepared_frame(jax_chain["prev"])
    nxt = convert.prepared_frame(jax_chain["nxt"])
    args, statics = tlk.level_inputs(
        prev, nxt, jax_chain["grid_xy"], torch.from_numpy(c_in), level, TPARAMS
    )
    tl, st = lk_level_reference(*args, torch.from_numpy(s_in), **statics)
    got = (tl + tlk._halfwin(TPARAMS, "cpu")).numpy()
    assert np.array_equal(st.numpy(), s_ref)
    assert np.abs(got - c_ref).max() < TOL_PX


def test_pyr_lk_matches_jax(jax_chain):
    a, b = jax_chain["frames"]
    pts = jax_chain["pts"]
    res = tlk.pyr_lk(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(pts), TPARAMS)
    c_ref, s_ref = jax_chain["levels"][0][2:]
    assert np.array_equal(res.status.numpy(), s_ref)
    assert np.abs(res.next_pts.numpy() - c_ref).max() < TOL_PX
    assert not res.err.any()


def test_lk_level_cpu_runs_plain_version():
    """On CPU tensors the wrapper IS the plain version (bit-identical) and
    launches no kernel."""
    a, b = shifted_pair(5, 3, -2)
    pts, grid_xy = _grid(*a.shape)
    prev = tlk.prepare_frame(torch.from_numpy(a), TPARAMS)
    nxt = tlk.prepare_frame(torch.from_numpy(b), TPARAMS)
    center = torch.from_numpy(pts) * 0.25
    args, statics = tlk.level_inputs(prev, nxt, grid_xy, center, 2, TPARAMS)
    status = torch.ones(pts.shape[0], dtype=torch.bool)
    before = lk_level.launches
    tl_w, st_w = lk_level(*args, status, **statics)
    tl_r, st_r = lk_level_reference(*args, status, **statics)
    assert lk_level.launches == before
    assert torch.equal(tl_w, tl_r) and torch.equal(st_w, st_r)


@pytest.mark.parametrize(
    "bad", ["tmpl_dtype", "tl0_shape", "crop_dtype", "status_dtype", "noncontig"]
)
def test_lk_level_rejects_bad_inputs(bad):
    n, win = 4, 5
    kw = dict(m=2, win_w=win, win_h=win, level_w=20, level_h=20, max_iters=3,
              eps2=1e-3, is_level0=True, min_eig_threshold=1e-4)
    args = dict(
        tmpl=torch.zeros(n, 3, win, win),
        plane_p=torch.zeros(30, 30),
        pad=5,
        tl0=torch.zeros(n, 2),
        crop_org=torch.zeros(n, 2, dtype=torch.int32),
        status0=torch.ones(n, dtype=torch.bool),
    )
    if bad == "tmpl_dtype":
        args["tmpl"] = args["tmpl"].double()
    elif bad == "tl0_shape":
        args["tl0"] = torch.zeros(n, 3)
    elif bad == "crop_dtype":
        args["crop_org"] = args["crop_org"].long()
    elif bad == "status_dtype":
        args["status0"] = args["status0"].to(torch.uint8)
    else:
        args["plane_p"] = torch.zeros(30, 60)[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        lk_level(*args.values(), **kw)


def test_unknown_grid_kernel_raises():
    a, b = shifted_pair(6, 0, 0)
    pts, _ = _grid(*a.shape)
    params = dataclasses.replace(TPARAMS, grid_kernel="packed")
    with pytest.raises(ValueError, match="grid_kernel"):
        tlk.pyr_lk(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(pts), params)
