"""Shi-Tomasi corner detection, cv2.goodFeaturesToTrack parity (port of
hackathonopticalflow_tpu/ops/features.py; reference call SparseOF.py:69,
maxCorners 20, qualityLevel 0.3, minDistance 10, blockSize 7).

- cornerMinEigenVal: aperture-3 Sobel gradients scaled by
  1 / (4 blockSize 255), block sums of the structure tensor (reflect-101
  borders), the smaller eigenvalue at every pixel;
- quality threshold at max * quality_level, 3x3 non-max suppression
  (the frame's 1-pixel border excluded);
- the strongest max_candidates survivors, ordered by value descending and
  then by flat index ascending (lax.top_k's order for ties, which
  torch.topk does not promise on CUDA: a stable descending sort gives it);
- greedy min-distance selection, strongest first.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..core import FeatureParams
from .deriv import sobel_deriv
from .image import box_sum


class Corners(NamedTuple):
    pts: torch.Tensor  # (max_corners, 2) float32 [x, y]; zeros where not valid
    valid: torch.Tensor  # (max_corners,) bool
    count: torch.Tensor  # () int32


def min_eig_map(img: torch.Tensor, block_size: int = 7, input_u8_scale: bool = True) -> torch.Tensor:
    """cornerMinEigenVal parity: smallest eigenvalue of the block-summed
    structure tensor at every pixel of (H, W) img."""
    scale = (1 << 2) * block_size
    if input_u8_scale:
        scale *= 255
    s = 1.0 / scale
    ix, iy = sobel_deriv(img.to(torch.float32))
    ix = ix * s
    iy = iy * s
    a = box_sum(ix * ix, block_size, mode="reflect")
    b = box_sum(ix * iy, block_size, mode="reflect")
    c = box_sum(iy * iy, block_size, mode="reflect")
    d = a - c
    return ((a + c) - torch.sqrt(d * d + 4.0 * b * b)) * 0.5


def _select(cxy: torch.Tensor, cand_ok: torch.Tensor, max_corners: int, min_d2: float):
    """The JAX package's greedy pass over the candidates (in order: take a
    candidate if it is valid and at least min_distance from every corner
    taken, until max_corners are taken), in max_corners rounds instead of
    one step per candidate. Round r takes the first candidate past the
    last one taken that is valid and far from every corner taken so far.
    The set taken only grows, so a candidate the sequential pass rejected
    stays rejected, and the result is the same. No round reads a value on
    the host: the candidate is gathered by a one-element index tensor."""
    k = cxy.shape[0]
    order = torch.arange(k, device=cxy.device)
    sel = torch.zeros((max_corners, 2), dtype=torch.float32, device=cxy.device)
    valid = torch.zeros((max_corners,), dtype=torch.bool, device=cxy.device)
    avail = cand_ok
    for r in range(max_corners):
        has = avail.any()
        i = avail.to(torch.int32).argmax().reshape(1)  # the first available candidate
        p = cxy.index_select(0, i)[0]
        sel[r] = torch.where(has, p, sel[r])
        valid[r] = has
        d2 = ((cxy - p) ** 2).sum(dim=-1)
        avail = avail & (d2 >= min_d2) & (order > i)
    return sel, valid


def good_features_to_track(
    img: torch.Tensor,
    params: FeatureParams = FeatureParams(),
    mask: torch.Tensor | None = None,
) -> Corners:
    """Up to max_corners Shi-Tomasi corners of (H, W) img in [0, 255].
    mask: optional (H, W) array; corners only where it is nonzero
    (SparseOF.py:61-69 masks out live tracks)."""
    h, w = img.shape
    eig = min_eig_map(img, params.block_size)
    if mask is not None:
        eig = torch.where(mask != 0, eig, torch.zeros_like(eig))
    thresh = eig.max() * params.quality_level
    eig = torch.where(eig >= thresh, eig, torch.zeros_like(eig))

    # 3x3 non-max suppression (max_pool2d pads with -inf, as reduce_window);
    # the 1-pixel frame border is excluded
    dil = F.max_pool2d(eig[None, None], 3, stride=1, padding=1)[0, 0]
    border_ok = torch.zeros((h, w), dtype=torch.bool, device=eig.device)
    border_ok[1 : h - 1, 1 : w - 1] = True
    cand = torch.where((eig > 0) & (eig == dil) & border_ok, eig, torch.zeros_like(eig))

    k = min(params.max_candidates, h * w)
    vals, idx = torch.sort(cand.reshape(-1), descending=True, stable=True)
    vals, idx = vals[:k], idx[:k]
    cxy = torch.stack([(idx % w).to(torch.float32), (idx // w).to(torch.float32)], dim=-1)
    min_d2 = float(np.float32(params.min_distance**2))
    sel, valid = _select(cxy, vals > 0, params.max_corners, min_d2)
    return Corners(pts=sel, valid=valid, count=valid.sum(dtype=torch.int32))
