"""Configs of the ported stages (port of hackathonopticalflow_tpu/core/config.py).

Every field here has the JAX package's name, type and default;
tests/test_torch_core.py holds them equal field by field. The constants
come from the reference apps: LK window/criteria pathfinder_viewer.py:154-158,
radial normalization :164-166, filter thresholds :173, grid step :16;
Farneback DenseOF.py:147-157.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LKParams:
    """Pyramidal Lucas-Kanade parameters (cv2.calcOpticalFlowPyrLK parity).

    The port runs the static-grid production configuration (grid_step set,
    grid_kernel "lanes", rescue_large with rescue_levels None, points_lanes
    and compute_err off); ops/lk.py raises NotImplementedError for the
    others. The JAX package's fields that only choose between TPU
    implementations of that computation (use_pallas, pallas_block,
    early_exit, lanes_packed, carve_dma) or serve unported paths
    (slab_margin, iter_margin) are left out."""

    win_size: tuple[int, int] = (45, 45)  # (w, h)
    max_level: int = 2
    max_iters: int = 10
    eps: float = 0.03
    min_eig_threshold: float = 1e-4
    #: the tracker's arbitrary-point path (not ported)
    points_lanes: bool = False
    #: measurement-grid step: pts MUST be measurement_grid(h, w, grid_step)
    grid_step: int | None = None
    #: the reference's static-slab margins; here they only size the
    #: frame pad, so that both packages pad identically
    slab_margin_y: int = 36
    slab_margin_x: int = 41
    #: crop margin at the top level, around each point's grid anchor (px
    #: at that level's scale)
    iter_margin_top: int = 32
    #: per-point residual err at level 0 (not ported)
    compute_err: bool = True
    grid_kernel: str = "lanes"
    #: crops below the top level centred at each point's coarse estimate
    rescue_large: bool = True
    #: None: every level below the top is init-centred (an int k: only
    #: levels < k, not ported)
    rescue_levels: int | None = None
    #: crop margin of the init-centred levels (px at the level's scale)
    rescue_margin: int = 20


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
