"""Distributed windowed bundle adjustment, landmarks sharded (port of
hackathonopticalflow_tpu/parallel/ba_dist.py; BASELINE.json config 5,
SURVEY.md §5.7b).

Landmarks are independent in the Schur-reduced normal equations: each
rank holds a shard of the landmark axis (its points, observation columns
and mask), computes its partial camera Hessian B, gradient v and Schur
products E C^-1 E^T, E C^-1 w, and a psum over the mesh axis assembles the
reduced (6M x 6M) camera system, which every rank then solves alike (M
is a small keyframe window) before back-substituting its own landmarks.
Communication per iteration: psums of O(M^2) 6x6 blocks and of the costs,
whatever the landmark count. nav/ba.py::bundle_adjust runs it through its
`preduce` hook.
"""

from __future__ import annotations

from ..nav.ba import BAState, BAStats, bundle_adjust
from .collectives import psum, shard_rows
from .mesh import Mesh


def shard_landmarks(state: BAState, mesh: Mesh, axis_name: str = "tile") -> BAState:
    """This rank's shard of a window: poses whole, points (L/n, 3), obs
    (M, L/n, 2) and mask (M, L/n), on the mesh's device."""
    return BAState(
        rvecs=state.rvecs.to(mesh.device),
        tvecs=state.tvecs.to(mesh.device),
        points=shard_rows(state.points, mesh, axis_name, 0),
        obs=shard_rows(state.obs, mesh, axis_name, 1),
        mask=shard_rows(state.mask, mesh, axis_name, 1),
    )


def distributed_bundle_adjust(
    state: BAState,
    mesh: Mesh,
    axis_name: str = "tile",
    iters: int = 10,
    lam: float = 1e-4,
    fix_scale: bool = True,
) -> tuple[BAState, BAStats]:
    """Windowed BA of this rank's landmark shard (shard_landmarks; the
    landmark count must divide by the axis size, pad with masked-out
    landmarks if needed). Poses are replicated and come back equal on
    every rank; points come back as this rank's shard; the stats (cost,
    initial cost, observation count) are the window's."""
    ax = mesh.axis(axis_name)
    return bundle_adjust(state, iters=iters, lam=lam, fix_scale=fix_scale, preduce=lambda x: psum(x, ax))
