"""JAX-package state -> this package's tensors and configs.

The inputs are the JAX package's NamedTuples (PreparedFrame, LKResult,
TrackerState, BAState), tuples of arrays (a Farneback pyramid) or
dataclasses (LKParams, FarnebackParams, FeatureParams, TrackerParams,
OdometryConfig), or anything
with the same fields whose leaves numpy can read (np.asarray of a
jax.Array copies it to the host); this module never imports jax. With it
a test feeds both packages the same pyramid and isolates one level, or
the same track table and isolates one step."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import FarnebackParams, FeatureParams, LKParams, TrackerParams
from .flow.tracker import TrackerState
from .nav.ba import BAState
from .nav.odometry import OdometryConfig
from .ops.lk import LKResult, PreparedFrame


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def prepared_frame(prep, device="cpu") -> PreparedFrame:
    """A JAX PreparedFrame -> the port's PreparedFrame on `device`."""
    return PreparedFrame(
        img_p=tuple(_tensor(a, device) for a in prep.img_p),
        dix_p=tuple(_tensor(a, device) for a in prep.dix_p),
        diy_p=tuple(_tensor(a, device) for a in prep.diy_p),
    )


def lk_result(res, device="cpu") -> LKResult:
    """A JAX LKResult -> the port's LKResult on `device`."""
    return LKResult(
        next_pts=_tensor(res.next_pts, device),
        status=_tensor(res.status, device),
        err=_tensor(res.err, device),
    )


def farneback_pyramid(rs, device="cpu") -> tuple[torch.Tensor, ...]:
    """A JAX Farneback prepare_frame() tuple of (5, Hk, Wk) arrays, coarse
    -> fine, -> the port's tuple of tensors on `device`."""
    return tuple(_tensor(r, device) for r in rs)


def farneback_params(params) -> FarnebackParams:
    """A JAX FarnebackParams -> the port's, field by field by name (the
    port has no warp_group_rows)."""
    return _by_name(FarnebackParams, params)


def _by_name(cls, params, **override):
    return cls(**{f.name: getattr(params, f.name) for f in dataclasses.fields(cls)}, **override)


def lk_params(params) -> LKParams:
    """A JAX LKParams -> the port's, field by field by name, leaving out
    the JAX-only fields. JAX's use_pallas implies a slab margin (its own or
    8); on the arbitrary-point path without points_lanes that margin picks
    the port's v1 geometry. points_lanes without use_pallas has no meaning
    in JAX (it falls back to its other paths) and is refused."""
    if params.points_lanes and not params.use_pallas:
        raise ValueError("points_lanes=True without use_pallas=True has no port counterpart")
    out = _by_name(LKParams, params)
    if params.use_pallas and params.grid_step is None and out.slab_margin is None:
        out = dataclasses.replace(out, slab_margin=8)
    return out


def feature_params(params) -> FeatureParams:
    """A JAX FeatureParams -> the port's, field by field by name."""
    return _by_name(FeatureParams, params)


def tracker_params(params) -> TrackerParams:
    """A JAX TrackerParams -> the port's, its lk and features converted."""
    fields = {f.name for f in dataclasses.fields(TrackerParams)} - {"lk", "features"}
    return TrackerParams(
        lk=lk_params(params.lk),
        features=feature_params(params.features),
        **{name: getattr(params, name) for name in fields},
    )


def tracker_state(state, device="cpu") -> TrackerState:
    """A JAX TrackerState -> the port's on `device` (frame_idx a Python
    int)."""
    return TrackerState(
        traj=_tensor(state.traj, device),
        length=_tensor(state.length, device),
        alive=_tensor(state.alive, device),
        frame_idx=int(np.asarray(state.frame_idx)),
    )


def ba_state(state, device="cpu") -> BAState:
    """A JAX BAState -> the port's on `device`."""
    return BAState(*(_tensor(x, device) for x in state))


def odometry_config(cfg) -> OdometryConfig:
    """A JAX OdometryConfig -> the port's, field by field by name."""
    return _by_name(OdometryConfig, cfg)
