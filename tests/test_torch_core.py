"""The port's configs and measurement grid equal the JAX package's, field by
field, so the two copies of the constants cannot drift apart."""

import dataclasses

import numpy as np
import pytest

from hackathonopticalflow_tpu import core as jcore
from hackathonopticalflow_tpu.core.config import TRACKER_LK as J_TRACKER_LK
from hackathonopticalflow_tpu_torch import core as tcore


# fields that only pick a TPU implementation of the ported computation, or
# serve paths the port does not have (warp_group_rows: the Pallas warp's
# row-group gating, which never changes its result)
JAX_ONLY = {
    "LKParams": {"use_pallas", "pallas_block", "early_exit", "lanes_packed",
                 "carve_dma"},
    "NormalizeParams": set(),
    "FilterParams": set(),
    "FarnebackParams": {"warp_group_rows"},
    "FeatureParams": set(),
    "TrackerParams": set(),
    "GridParams": set(),
}


def _fields(obj, cls_name):
    """(name, value) of a config's fields without the JAX-only ones,
    nested configs expanded the same way."""
    out = []
    for f in dataclasses.fields(obj):
        if f.name in JAX_ONLY[cls_name]:
            continue
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            v = _fields(v, type(v).__name__)
        out.append((f.name, v))
    return out


@pytest.mark.parametrize("name", sorted(JAX_ONLY))
def test_params_match_jax(name):
    jcls, tcls = getattr(jcore, name), getattr(tcore, name)
    jf = [(f.name, f.type) for f in dataclasses.fields(jcls) if f.name not in JAX_ONLY[name]]
    tf = [(f.name, f.type) for f in dataclasses.fields(tcls)]
    assert tf == jf
    assert {f.name for f in dataclasses.fields(jcls)} - {f[0] for f in tf} == JAX_ONLY[name]
    assert _fields(tcls(), name) == _fields(jcls(), name)
    assert tcls.__dataclass_params__.frozen


def test_tracker_lk_matches_jax():
    """TRACKER_LK field by field (the port's points_lanes means JAX's
    use_pallas + points_lanes)."""
    assert J_TRACKER_LK.use_pallas and J_TRACKER_LK.points_lanes
    assert _fields(tcore.TRACKER_LK, "LKParams") == _fields(J_TRACKER_LK, "LKParams")
    assert tcore.TrackerParams().lk == tcore.TRACKER_LK


def test_proto_filter_matches_jax():
    """PROTO_FILTER (DenseOF.py:228's median*1.2 filter) field by field."""
    from hackathonopticalflow_tpu.core.config import PROTO_FILTER as J_PROTO_FILTER

    assert _fields(tcore.PROTO_FILTER, "FilterParams") == _fields(J_PROTO_FILTER, "FilterParams")
    assert tcore.PROTO_FILTER != tcore.FilterParams()


def test_production_lk_params_match_jax():
    t = tcore.LKParams(grid_step=30, compute_err=False)
    j = jcore.LKParams(grid_step=30, use_pallas=True, compute_err=False)
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name


GRID_SIZES = [(1080, 1920, 30), (270, 480, 30), (271, 479, 30), (720, 1280, 30), (97, 131, 16)]


@pytest.mark.parametrize("h,w,step", GRID_SIZES)
def test_measurement_grid_matches_jax(h, w, step):
    got = tcore.measurement_grid(h, w, step)
    want = jcore.measurement_grid(h, w, step)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("h,w,step", GRID_SIZES)
def test_grid_shape_matches_jax(h, w, step):
    from hackathonopticalflow_tpu.core.grid import grid_shape

    got = tcore.grid_shape(h, w, step)
    assert got == grid_shape(h, w, step)
    assert got[0] * got[1] == len(tcore.measurement_grid(h, w, step))


def test_win_area_matches_jax():
    """LKParams.win_area at the default, the tracker's and a rectangular
    window."""
    for t, j in ((tcore.LKParams(), jcore.LKParams()), (tcore.TRACKER_LK, J_TRACKER_LK),
                 (tcore.LKParams(win_size=(21, 9)), jcore.LKParams(win_size=(21, 9)))):
        assert t.win_area == j.win_area == t.win_size[0] * t.win_size[1]
