"""JAX-package state -> this package's tensors.

The inputs are the JAX package's NamedTuples (PreparedFrame, LKResult),
tuples of arrays (a Farneback pyramid) or dataclasses (FarnebackParams),
or anything with the same fields whose leaves numpy can read (np.asarray
of a jax.Array copies it to the host); this module never imports jax.
With it a test feeds both packages the same pyramid and isolates one
level."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import FarnebackParams
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
    return FarnebackParams(**{f.name: getattr(params, f.name) for f in dataclasses.fields(FarnebackParams)})
