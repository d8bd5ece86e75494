"""Configs of the ported stages (port of hackathonopticalflow_tpu/core/config.py).

Every field here has the JAX package's name, type and default;
tests/test_torch_core.py holds them equal field by field. The constants
come from the reference apps: LK window/criteria pathfinder_viewer.py:154-158
(SparseOF.py:6-8 for the tracker's window 15), radial normalization
:164-166, filter thresholds :173 (DenseOF.py:228 for PROTO_FILTER), grid
step :16; Farneback DenseOF.py:147-157; Shi-Tomasi SparseOF.py:10-13;
tracker SparseOF.py:15-16,37-38.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LKParams:
    """Pyramidal Lucas-Kanade parameters (cv2.calcOpticalFlowPyrLK parity).

    Without grid_step, arbitrary points (the tracker's) in one of three
    geometries: points_lanes=True is the JAX package's use_pallas=True,
    points_lanes=True (crops centred at each point's clipped init, margin
    slab_margin or 8); points_lanes=False with slab_margin set is its v1
    slab geometry (use_pallas=True without lanes, or its XLA slab path);
    slab_margin=None without points_lanes is the exact path (JAX's default
    LKParams(): each iteration samples its window straight from the
    plane). With grid_step set, the static-grid path with either grid
    kernel, "lanes" or "blocked", and any rescue_large / rescue_levels.
    The JAX package's fields that only choose between TPU implementations
    of a computation (use_pallas, pallas_block, early_exit, lanes_packed,
    carve_dma) are left out."""

    win_size: tuple[int, int] = (45, 45)  # (w, h)
    max_level: int = 2
    max_iters: int = 10
    eps: float = 0.03
    min_eig_threshold: float = 1e-4
    #: crop margin of both arbitrary-point geometries (px at the level's
    #: scale); None: 8 with points_lanes, the exact path without it
    slab_margin: int | None = None
    #: arbitrary points: init-centred crops (True) or the v1 slab (False)
    points_lanes: bool = False
    #: measurement-grid step: pts MUST be measurement_grid(h, w, grid_step)
    grid_step: int | None = None
    #: drift budget below the top level of the grid-anchored slabs (px at
    #: the level's scale): a point whose crop at its coarse init does not
    #: fit in its slab freezes there and keeps the coarse estimate
    iter_margin: int = 12
    #: the grid-anchored slab margins (slab_margin_x is (128-win-1)//2 for
    #: the blocked kernel); they also size the frame pad
    slab_margin_y: int = 36
    slab_margin_x: int = 41
    #: crop margin at the top level, around each point's grid anchor (px
    #: at that level's scale)
    iter_margin_top: int = 32
    #: per-point residual err at level 0 (mean |window - template|) on the
    #: grid path; the arbitrary-point paths always give it, as JAX's do
    compute_err: bool = True
    #: grid path: "lanes" (init-centred levels as rescue_large and
    #: rescue_levels say, grid-anchored crops elsewhere) or "blocked"
    #: (grid-anchored crops at every level, the JAX package's v2 kernel)
    grid_kernel: str = "lanes"
    #: crops below the top level centred at each point's coarse estimate
    rescue_large: bool = True
    #: None: every level below the top is init-centred; an int k: only
    #: levels < k, the others grid-anchored
    rescue_levels: int | None = None
    #: crop margin of the init-centred levels (px at the level's scale)
    rescue_margin: int = 20


#: Tracker-flavoured LK (reference SparseOF.py:6-8): window 15, init-centred
#: crops of margin 8 around each point's init.
TRACKER_LK = LKParams(
    win_size=(15, 15), max_level=2, max_iters=10, eps=0.03,
    slab_margin=8, points_lanes=True,
)


@dataclasses.dataclass(frozen=True)
class FeatureParams:
    """Shi-Tomasi corner detection (cv2.goodFeaturesToTrack parity)."""

    max_corners: int = 20
    quality_level: float = 0.3
    min_distance: float = 10.0
    block_size: int = 7
    #: NMS survivors considered by the greedy min-distance pass, strongest
    #: first
    max_candidates: int = 512


@dataclasses.dataclass(frozen=True)
class TrackerParams:
    """Forward-backward LK trajectory tracker (reference SparseOF.py)."""

    lk: LKParams = TRACKER_LK
    trajectory_len: int = 40
    detect_interval: int = 5
    fb_max_dist: float = 1.0  # forward-backward gate, SparseOF.py:37-38
    max_tracks: int = 256  # capacity of the track table
    features: FeatureParams = FeatureParams()


@dataclasses.dataclass(frozen=True)
class NormalizeParams:
    """Radial (focus-of-expansion) magnitude normalization:
    modulus <- modulus / (offset + sqrt(dist_to_center)) * gain."""

    offset: float = 5.0
    gain: float = 30.0


@dataclasses.dataclass(frozen=True)
class FilterParams:
    """Robust vector filter: keeps median*median_factor < m <
    P(upper_percentile); None drops the upper bound."""

    median_factor: float = 1.0
    upper_percentile: float | None = 99.0


#: DenseOF.py:228 variant: median*1.2 < m, no upper bound.
PROTO_FILTER = FilterParams(median_factor=1.2, upper_percentile=None)


@dataclasses.dataclass(frozen=True)
class GridParams:
    """Centered measurement grid (reference pathfinder_viewer.py:255-267)."""

    step: int = 30


@dataclasses.dataclass(frozen=True)
class FarnebackParams:
    """Farneback dense-flow parameters (cv2.calcOpticalFlowFarneback parity).

    warp_mode selects how the second frame's polynomial coefficients are
    displaced by the current flow each iteration. The port runs "exact"
    (bilinear warp of the 5 coefficient channels, OpenCV semantics: the
    `warp_bilinear` kernel on CUDA tensors, its plain version on CPU
    tensors, with the doubling box sum); "auto" (the default) means
    "exact" here. The JAX package's TPU speed modes ("packed", "pallas",
    "pallas_bf16") and re-expansion modes ("image", "hybrid") raise
    NotImplementedError naming their ROADMAP item. The JAX field
    warp_group_rows (Pallas tile geometry) is left out."""

    pyr_scale: float = 0.5
    levels: int = 3
    win_size: int = 15
    iterations: int = 3
    poly_n: int = 5
    poly_sigma: float = 1.2
    gaussian_win: bool = False  # flags=0 in the reference -> box filter
    warp_mode: str = "auto"
