"""The configuration's groups as the port's parameter objects. The port
is imported here, inside the functions, never by the reference."""

from __future__ import annotations


def grid_params(cfg: dict):
    """(LKParams, NormalizeParams, FilterParams) of a grid-flow
    configuration."""
    from hackathonopticalflow_tpu_torch.core import FilterParams, LKParams, NormalizeParams

    lk = dict(cfg["lk"])
    lk["win_size"] = tuple(lk["win_size"])
    return LKParams(**lk), NormalizeParams(**cfg["normalize"]), FilterParams(**cfg["filter"])


def farneback_params(cfg: dict, **override):
    from hackathonopticalflow_tpu_torch.core import FarnebackParams

    return FarnebackParams(**{**cfg["farneback"], **override})
