"""The plain reference of the pathfinder's grid flow: the reference's
`get_flow_lk` (pathfinder_viewer.py:144-193) at the production grid
configuration, as the port's plain path computes it.

A frozen copy of the port's plain versions (hackathonopticalflow_tpu_torch
core/grid.py, ops/pyramid.py, ops/deriv.py, ops/patch.py::
extract_grid_templates, ops/lk.py's grid path, ops/lk_level.py::
lk_level_reference, flow/lk_grid.py::_post_lk, nav/normalize.py,
nav/filter.py, ops/stats.py), cut to the one geometry the configuration
states: the lanes grid path with every level below the top init-centred
(`grid_kernel="lanes"`, `rescue_large=True`, `rescue_levels=None`), and
without OpenCV's err (`compute_err=False`). It imports nothing of the
port, of the JAX package or jax, and takes nothing the port made: it
rebuilds the grid, the pyramids and the templates from the frames.

Per pair (previous, current): backward pyramidal LK from the current
frame's templates into the previous frame; radial normalization; the
median / P99 danger mask; the reference's int32(x + 0.5) rounding. Every
LK sum is exact (1/1024 grid terms, float64), so the port's kernel and
this version agree bit for bit.

`data_dtype=torch.bfloat16` is the control: the derivative planes, the
templates and the sampled windows are rounded to bf16 (image levels are
integers, exact there), the step below float32 that would tempt a faster
kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .image import reflect101_pad, sep_conv2d

_PYR_K = [1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0]
_SCHARR_SMOOTH = [3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0]
_DIFF = [-1.0, 0.0, 1.0]
_CV_SCALE = 1.0 / 1024.0
_FLT_EPSILON = 1.1920929e-07


class GridResult(NamedTuple):
    """One pair's outputs, as flow/lk_grid.py::GridFlowResult names them."""

    raw_next_pts: torch.Tensor  # (N, 2) float32
    flow: torch.Tensor  # (N, 2) int32
    next_pts: torch.Tensor  # (N, 2) int32
    pts: torch.Tensor  # (N, 2) int32
    modulus: torch.Tensor  # (N,) float32
    ang: torch.Tensor  # (N,) float32
    good: torch.Tensor  # (N,) bool
    status: torch.Tensor  # (N,) bool


def measurement_grid(height: int, width: int, step: int) -> np.ndarray:
    """(N, 2) float32 [x, y], x-major: the reference's centred grid
    (pathfinder_viewer.py:255-267)."""
    indent_w = width % step / 2 if width // step % 2 == 1 else (width % step + step) / 2
    indent_h = height % step / 2 if height // step % 2 == 1 else (height % step + step) / 2
    xs = np.arange(indent_w, width, step).astype(int)
    ys = np.arange(indent_h, height, step).astype(int)
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    return np.stack([xx.ravel(), yy.ravel()], axis=-1).astype(np.float32)


def _init_centered_pad(win_w: int, win_h: int, margin: int) -> int:
    crop_x = win_w + 1 + 2 * margin
    slack = (-crop_x) % 8
    return max(win_w + margin + 3 + slack, win_h + margin + 3)


class LKGridReference:
    """The grid flow of one configuration (its `lk`, `normalize` and
    `filter` groups) at frames of one size, on `device`."""

    def __init__(self, cfg: dict, device, data_dtype: torch.dtype = torch.float32):
        lk = cfg["lk"]
        if lk.get("grid_kernel", "lanes") != "lanes" or not lk.get("rescue_large", True) \
                or lk.get("rescue_levels") is not None or lk.get("compute_err", True):
            raise ValueError("the reference holds the lanes grid path with every lower level init-centred "
                             "and compute_err off only")
        self.lk = lk
        self.norm = cfg["normalize"]
        self.filt = cfg["filter"]
        self.h, self.w = cfg["height"], cfg["width"]
        self.device = torch.device(device)
        self.data_dtype = data_dtype
        self.win_w, self.win_h = lk["win_size"]
        self.max_level = lk["max_level"]
        half = (max(self.win_w, self.win_h) - 1) // 2
        m = max(lk["slab_margin_x"], lk["slab_margin_y"], lk["iter_margin_top"])
        self.pad = max(max(self.win_w, self.win_h) + 2, half + m + 2,
                       _init_centered_pad(self.win_w, self.win_h, lk["rescue_margin"]))
        self.pts_np = measurement_grid(self.h, self.w, lk["grid_step"])
        self.pts = torch.from_numpy(self.pts_np).to(self.device)
        self.xs = np.unique(self.pts_np[:, 0]).astype(int)
        self.ys = np.unique(self.pts_np[:, 1]).astype(int)
        self.halfwin = torch.tensor([(self.win_w - 1) * 0.5, (self.win_h - 1) * 0.5], dtype=torch.float32,
                                    device=self.device)

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        if self.data_dtype == torch.float32:
            return x
        return x.to(self.data_dtype).to(torch.float32)

    def prepare(self, gray: torch.Tensor) -> tuple[list, list, list]:
        """Per level: the reflect-101 padded u8-rounded pyrDown level and
        its zero-padded Scharr derivatives."""
        lv = gray.to(self.device, torch.float32)
        levels = [lv]
        for _ in range(self.max_level):
            lv = sep_conv2d(lv, _PYR_K, _PYR_K)[..., ::2, ::2]
            lv = torch.clamp(torch.floor(lv + 0.5), 0.0, 255.0)
            levels.append(lv)
        p = self.pad
        imgs, dxs, dys = [], [], []
        for lv in levels:
            dx = self._q(sep_conv2d(lv, _SCHARR_SMOOTH, _DIFF))
            dy = self._q(sep_conv2d(lv, _DIFF, _SCHARR_SMOOTH))
            imgs.append(self._q(reflect101_pad(lv, p).contiguous()))
            dxs.append(torch.nn.functional.pad(dx, (p, p, p, p)))
            dys.append(torch.nn.functional.pad(dy, (p, p, p, p)))
        return imgs, dxs, dys

    def _templates(self, prep, level: int) -> torch.Tensor:
        """(N, 3, win_h, win_w) grid templates at `level`, rows blended
        in y, then x, then quantized to the 1/32 grid; x-major."""
        win_w, win_h, pad = self.win_w, self.win_h, self.pad
        planes = torch.stack([prep[0][level], prep[1][level], prep[2][level]], dim=0)
        dev = planes.device

        def bases(coords, off):
            pos = np.asarray(coords, np.float64) / (1 << level) - off
            base = np.floor(pos).astype(np.int64)
            return base, (pos - base).astype(np.float32)

        by, fy = bases(self.ys, (win_h - 1) * 0.5)
        bx, fx = bases(self.xs, (win_w - 1) * 0.5)
        ry = torch.as_tensor(by + pad, device=dev)[:, None] + torch.arange(win_h + 1, device=dev)
        cx = torch.as_tensor(bx + pad, device=dev)[:, None] + torch.arange(win_w + 1, device=dev)
        fyv = torch.as_tensor(fy, device=dev).reshape(1, -1, 1, 1)
        fxv = torch.as_tensor(fx, device=dev).reshape(1, 1, 1, -1, 1)
        rows = planes[..., ry, :]
        rows = rows[..., :win_h, :] * (1 - fyv) + rows[..., 1:, :] * fyv
        cols = rows[..., cx]
        wnd = cols[..., :win_w] * (1 - fxv) + cols[..., 1:] * fxv
        wnd = torch.floor(wnd * 32.0 + 0.5) * (1.0 / 32.0)
        out = wnd.permute(3, 1, 0, 2, 4)  # (3, Ky, win_h, Kx, win_w) -> (Kx, Ky, 3, win_h, win_w)
        return self._q(out.reshape(-1, 3, win_h, win_w).contiguous())

    def _level(self, tmpl, plane_p, tl0, crop_org, status0, m, level_w, level_h, is_level0, stats):
        """lk_level_reference in the centred geometry."""
        lk = self.lk
        win_w, win_h, pad = self.win_w, self.win_h, self.pad
        eps2 = float(max(lk["eps"], 0.0) ** 2)
        dev = tmpl.device

        def sum64(x, y):
            return (x.double() * y.double()).sum(dim=(1, 2)).float()

        iw, ixw, iyw = tmpl[:, 0], tmpl[:, 1], tmpl[:, 2]
        a11 = sum64(ixw, ixw) * _CV_SCALE
        a12 = sum64(ixw, iyw) * _CV_SCALE
        a22 = sum64(iyw, iyw) * _CV_SCALE
        det = a11 * a22 - a12 * a12
        d = a11 - a22
        min_eig = (a22 + a11 - torch.sqrt(d * d + 4.0 * a12 * a12)) / (2.0 * win_w * win_h)
        bad = (min_eig < lk["min_eig_threshold"]) | (det < _FLT_EPSILON)
        inv_det = torch.where(det > 0, 1.0 / det, torch.zeros_like(det))
        status = status0 & ~bad if is_level0 else status0.clone()
        active = ~bad
        stats["good"] = int(active.sum())
        stats["iterations"] = 0
        tlx, tly = tl0[:, 0].clone(), tl0[:, 1].clone()
        pdx = torch.zeros_like(tlx)
        pdy = torch.zeros_like(tly)
        hp, wp = plane_p.shape[-2:]
        cw, ch = win_w + 1 + 2 * m, win_h + 1 + 2 * m
        ox0 = torch.clamp(crop_org[:, 0] + pad, 0, wp - cw)
        oy0 = torch.clamp(crop_org[:, 1] + pad, 0, hp - ch)
        cbx, cby = crop_org[:, 0], crop_org[:, 1]
        rr = torch.arange(win_h + 1, device=dev)
        cc = torch.arange(win_w + 1, device=dev)
        for j in range(lk["max_iters"]):
            ixf = torch.floor(tlx)
            iyf = torch.floor(tly)
            oob = (ixf < -win_w) | (ixf >= level_w) | (iyf < -win_h) | (iyf >= level_h)
            if is_level0:
                status = status & ~(active & oob)
            active = active & ~oob
            stats["iterations"] += int(active.sum())
            ax = (tlx - ixf)[:, None, None]
            ay = (tly - iyf)[:, None, None]
            ox = torch.clamp(ixf.to(torch.int32) - cbx, 0, 2 * m)
            oy = torch.clamp(iyf.to(torch.int32) - cby, 0, 2 * m)
            rows = (oy0 + oy)[:, None] + rr
            cols = (ox0 + ox)[:, None] + cc
            raw = plane_p[rows[:, :, None], cols[:, None, :]]
            v = (raw[:, :win_h, :win_w] * (1 - ax) * (1 - ay) + raw[:, :win_h, 1:] * ax * (1 - ay)
                 + raw[:, 1:, :win_w] * (1 - ax) * ay + raw[:, 1:, 1:] * ax * ay)
            jw = self._q(torch.floor(v * 32.0 + 0.5) * (1.0 / 32.0))
            diff = jw - iw
            b1 = sum64(diff, ixw) * _CV_SCALE
            b2 = sum64(diff, iyw) * _CV_SCALE
            dx = (a12 * b2 - a22 * b1) * inv_det
            dy = (a12 * b1 - a11 * b2) * inv_det
            tlx = torch.where(active, tlx + dx, tlx)
            tly = torch.where(active, tly + dy, tly)
            converged = dx * dx + dy * dy <= eps2
            osc = (j > 0) & (torch.abs(dx + pdx) < 0.01) & (torch.abs(dy + pdy) < 0.01) & ~converged
            tlx = torch.where(active & osc, tlx - dx * 0.5, tlx)
            tly = torch.where(active & osc, tly - dy * 0.5, tly)
            active = active & ~(converged | osc)
            pdx, pdy = dx, dy
        return torch.stack([tlx, tly], dim=-1), status

    def track(self, prev_prep, cur_prep, stats: list | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """(next_pts, status): the grid points of the current frame tracked
        into the previous one (templates from the current frame). `stats`,
        if a list, receives each level's {"good", "iterations"}, top level
        first."""
        lk = self.lk
        win_w, win_h = self.win_w, self.win_h
        pts = self.pts
        status = torch.ones(pts.shape[0], dtype=torch.bool, device=self.device)
        center = pts * (1.0 / (1 << self.max_level))
        for level in range(self.max_level, -1, -1):
            if level != self.max_level:
                center = center * 2.0
            plane = prev_prep[0][level]
            h = plane.shape[-2] - 2 * self.pad
            w = plane.shape[-1] - 2 * self.pad
            tmpl = self._templates(cur_prep, level)
            tl0 = center - self.halfwin
            if level == self.max_level:
                m = lk["iter_margin_top"]
            else:
                m = lk["rescue_margin"]
                tl0 = torch.stack([torch.clamp(tl0[:, 0], -(win_w + 2.0), w + 2.0),
                                   torch.clamp(tl0[:, 1], -(win_h + 2.0), h + 2.0)], dim=-1)
            crop_org = torch.floor(tl0).to(torch.int32) - m
            level_stats: dict = {}
            tl, status = self._level(tmpl, plane, tl0.contiguous(), crop_org, status, m, w, h, level == 0,
                                     level_stats)
            if stats is not None:
                stats.append(level_stats)
            center = tl + self.halfwin
        return center, status

    def post(self, next_pts: torch.Tensor, status: torch.Tensor) -> GridResult:
        """Radial normalization, the danger mask and the reference's
        rounding (flow/lk_grid.py::_post_lk)."""
        pts = self.pts
        half_w, half_h = int(self.w / 2), int(self.h / 2)
        flow_raw = next_pts - pts
        fx, fy = flow_raw[..., 0], flow_raw[..., 1]
        x, y = pts[:, 0], pts[:, 1]
        ang = torch.atan2(fy, fx)
        modulus = torch.sqrt(fx * fx + fy * fy)
        dist = torch.sqrt((half_w - x) ** 2 + (half_h - y) ** 2)
        modulus = modulus / (self.norm["offset"] + torch.sqrt(dist)) * self.norm["gain"]
        nfx = modulus * torch.cos(ang)
        nfy = modulus * torch.sin(ang)
        nxt = torch.trunc(torch.stack([x + nfx, y + nfy], dim=-1) + 0.5).to(torch.int32)
        pts_i = torch.trunc(pts + 0.5).to(torch.int32).expand_as(nxt)
        v = torch.sort(modulus, dim=-1).values
        n = v.shape[-1]
        median = (v[..., (n - 1) // 2] + v[..., n // 2]) * 0.5
        good = modulus > median * self.filt["median_factor"]
        q = self.filt["upper_percentile"]
        if q is not None:
            pos = q / 100.0 * (n - 1)
            lo = min(max(math.floor(pos), 0), n - 1)
            hi = min(lo + 1, n - 1)
            a, b = v[..., lo].double(), v[..., hi].double()
            good = good & (modulus < (a + (b - a) * (pos - lo)).to(v.dtype))
        return GridResult(next_pts, nxt - pts_i, nxt, pts_i, modulus, ang, good, status)

    def pair(self, prev_prep, cur_prep, stats: list | None = None) -> GridResult:
        return self.post(*self.track(prev_prep, cur_prep, stats))
