"""PyTorch port vs the JAX package: the grid path's grid-anchored crops
(lk_level's "anchored" geometry) in the three configurations that run
them: grid_kernel="blocked" (every level; the JAX package's
lk_pallas2.py::lk_iterate_grid), and the lanes kernel with
rescue_large=False or rescue_levels=1 (the levels below the top without a
rescue; phase A of lk_pallas3.py::lk_iterate_grid_lanes).

The JAX side runs its Pallas kernels in interpret mode, once per module
and configuration. Pairs: a (+5, +3) shift, and a (+40, +3) shift of a
coarser texture on which LK follows the shift down the pyramid, so that
at level 0 the crop at the coarse estimate leaves the slab and the point
freezes. Bars: status identical, the frozen set identical (points whose
output equals their input), max endpoint |difference| < 0.05 px (the JAX
package's own bar between its kernels, which sum in other orders)."""

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
from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level_reference
from test_torch_prepare import lattice_pair, shifted_pair

torch.set_num_threads(1)

PROD = LKParams(grid_step=30, use_pallas=True, compute_err=False)
CONFIGS = {
    "blocked": dataclasses.replace(PROD, grid_kernel="blocked"),
    "no_rescue": dataclasses.replace(PROD, rescue_large=False),
    "rescue_levels_1": dataclasses.replace(PROD, rescue_levels=1),
}
PAIRS = {
    "shift_5_3": lambda: shifted_pair(2, 5, 3),
    "shift_40_3": lambda: lattice_pair(3, 40, 3),
}
# the levels that cut their crops from grid-anchored slabs
ANCHORED_LEVELS = {"blocked": {2, 1, 0}, "no_rescue": {1, 0}, "rescue_levels_1": {1}}
TOL_PX = 0.05


def _grid(h, w):
    pts = measurement_grid(h, w, 30)
    return pts, (np.unique(pts[:, 0]).astype(int), np.unique(pts[:, 1]).astype(int))


@pytest.fixture(scope="module", params=[(c, p) for c in CONFIGS for p in PAIRS], ids="-".join)
def jax_chain(request):
    """The JAX grid path in one configuration on one pair, level by level:
    each level's inputs (next_center, status) and outputs."""
    config, pair = request.param
    params = CONFIGS[config]
    a, b = PAIRS[pair]()
    pts, grid_xy = _grid(*a.shape)
    prev = jlk.prepare_frame(jnp.asarray(a, jnp.float32), params)
    nxt = jlk.prepare_frame(jnp.asarray(b, jnp.float32), params)
    center = jnp.asarray(pts) * jnp.float32(1.0 / (1 << params.max_level))
    status = jnp.ones(pts.shape[0], bool)
    levels = {}
    for level in range(params.max_level, -1, -1):
        if level != params.max_level:
            center = center * 2.0
        out_c, out_s, _ = jlk._level_lk_static_grid(prev, nxt, grid_xy, center, status, level, params)
        levels[level] = tuple(np.array(v) for v in (center, status, out_c, out_s))
        center, status = out_c, out_s
    return dict(config=config, pair=pair, params=params, frames=(a, b), pts=pts, grid_xy=grid_xy,
                prev=prev, nxt=nxt, levels=levels)


@pytest.mark.parametrize("level", [2, 1, 0])
def test_level_matches_jax(jax_chain, level):
    """One level on the JAX package's prepared frames and level inputs:
    status and frozen set identical, positions within the bar."""
    c_in, s_in, c_ref, s_ref = jax_chain["levels"][level]
    params = convert.lk_params(jax_chain["params"])
    prev = convert.prepared_frame(jax_chain["prev"])
    nxt = convert.prepared_frame(jax_chain["nxt"])
    args, kw = tlk.level_inputs(prev, nxt, jax_chain["grid_xy"], torch.from_numpy(c_in), level, params)
    anchored = level in ANCHORED_LEVELS[jax_chain["config"]]
    assert (kw["geometry"] == "anchored") == anchored
    tl, st = lk_level_reference(*args, torch.from_numpy(s_in), **kw)
    got = (tl + tlk._halfwin(params, "cpu")).numpy()
    assert np.array_equal(st.numpy(), s_ref)
    frozen = (got == c_in).all(-1)
    assert np.array_equal(frozen, (c_ref == c_in).all(-1))
    assert np.abs(got - c_ref).max() < TOL_PX
    if anchored:
        # every point whose crop does not fit keeps its input
        unfit = ~kw["active0"].numpy()
        assert frozen[unfit].all()
        if level == 0 and jax_chain["pair"] == "shift_40_3":
            assert unfit.sum() > 0


def test_pyr_lk_matches_jax(jax_chain):
    """pyr_lk on the raw frames vs the JAX level chain's end."""
    a, b = jax_chain["frames"]
    params = convert.lk_params(jax_chain["params"])
    res = tlk.pyr_lk(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(jax_chain["pts"]), params)
    c_ref, s_ref = jax_chain["levels"][0][2:]
    assert np.array_equal(res.status.numpy(), s_ref)
    assert np.abs(res.next_pts.numpy() - c_ref).max() < TOL_PX
    assert not res.err.any()


@pytest.mark.parametrize("offset", [55, 56, 57, 58, 59, -1])
def test_anchored_slack_per_kernel(offset):
    """The x slack of the grid-anchored crop at window 45 and iter_margin
    12: 58 px for blocked (Rx - crop_x), 56 px for lanes (Rx - crop_x
    rounded up to 8), so offsets 57 and 58 fit in one kernel and freeze in
    the other; the crop origin is clipped into the slack either way."""
    pts, grid_xy = _grid(270, 480)
    level, m = 0, 12
    for kernel, slack in (("blocked", 58), ("lanes", 56)):
        params = tcore.LKParams(grid_step=30, grid_kernel=kernel)
        bx = np.floor(grid_xy[0] - 22.0 - 41).astype(np.int32)
        by = np.floor(grid_xy[1] - 22.0 - 36).astype(np.int32)
        base = torch.from_numpy(np.stack(np.meshgrid(bx, by, indexing="ij"), -1).reshape(-1, 2))
        tl0 = (base + m + torch.tensor([offset, 4])).to(torch.float32) + 0.25
        crop_org, fits = tlk._anchored_crops(tl0, grid_xy, level, m, params)
        assert bool(fits.all()) == (0 <= offset <= slack), kernel
        want = base + torch.tensor([min(max(offset, 0), slack), 4])
        assert torch.equal(crop_org, want.to(torch.int32)), kernel


@pytest.mark.parametrize(
    "change",
    [dict(grid_kernel="blocked"), dict(rescue_large=False), dict(rescue_levels=1), None],
    ids=["blocked", "no_rescue", "rescue_levels_1", "exact"],
)
def test_convert_lk_params(change):
    """convert.lk_params on the JAX package's configurations of the new
    paths (its default LKParams() is the exact path)."""
    if change is None:
        jp, want = LKParams(), tcore.LKParams()
    else:
        jp = dataclasses.replace(PROD, **change)
        want = dataclasses.replace(tcore.LKParams(grid_step=30, compute_err=False), **change)
    got = convert.lk_params(jp)
    assert got == want
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(jp, f.name), f.name
