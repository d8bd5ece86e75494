"""JAX-package state -> this package's tensors.

The inputs are the JAX package's NamedTuples (PreparedFrame, LKResult) or
anything with the same fields whose leaves numpy can read (np.asarray of
a jax.Array copies it to the host); this module never imports jax. With
it a test feeds both packages the same pyramid and isolates one level."""

from __future__ import annotations

import numpy as np
import torch

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
