"""The plain reference of the trajectory tracker: the reference's
SparseOF.py loop (:22-92, settings :6-18) as the port's plain path
computes it at `TrackerParams()`.

A frozen copy of the port's plain versions (hackathonopticalflow_tpu_torch
ops/pyramid.py, ops/deriv.py, ops/patch_bilinear.py::
patch_bilinear_reference, ops/lk.py's arbitrary-point path,
ops/lk_level.py::lk_level_reference, ops/features.py, flow/tracker.py),
cut to the one geometry the configuration states: crops centred at each
point's clipped estimate, margin `slab_margin` (`points_lanes`). Plain
PyTorch in the port's precision (float32; the LK sums exact in float64);
no kernel, no graph, no batching. It imports nothing of the port, of the
JAX package or jax.

One step, previous frame to current frame:
- every slot's head tracked forward with pyramidal LK (templates sampled
  bilinearly at the head, quantized to the 1/32 grid, zero where the
  window lies outside the frame), the result tracked back the same way;
- a track is kept where it was alive and the forward-backward distance,
  the larger of |dx| and |dy| (SparseOF.py's `d`), is under fb_max_dist;
- the kept tracks' new heads appended, the oldest point dropped at
  capacity (a roll); the others die;
- on a step whose frame index (before the step) is a multiple of
  detect_interval: Shi-Tomasi corners of the current frame away from
  r = 5 discs around the live heads (the min-eigenvalue map, the quality
  threshold, 3x3 non-max suppression, the strongest max_candidates by a
  stable descending sort, then the sequential greedy min-distance pass
  over them on the host), seeded as one-point tracks into the lowest free
  slots, strongest corner first.

Departures from SparseOF.py, which the port makes too:
- a fixed table of max_tracks slots of trajectory_len points in place of
  a Python list of lists; corners past the free slots are dropped;
- every slot, dead or alive, is tracked every frame, and the keep
  decision drops the dead ones;
- detection is seeded by one step of the first frame against itself
  (`seed`), where SparseOF.py detects on its first frame before it tracks;
- OpenCV's err and LK's status are not computed: the tracker reads only
  positions.

`data_dtype=torch.bfloat16` is the control: the derivative planes, the
templates and the sampled windows rounded to bf16 (image levels are
integers, exact there), the step below float32 that would tempt a faster
kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .image import _box1d, pad_axis, reflect101_pad, sep_conv2d

_PYR_K = [1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0]
_SCHARR_SMOOTH = [3.0 / 32.0, 10.0 / 32.0, 3.0 / 32.0]
_SOBEL_SMOOTH = [1.0, 2.0, 1.0]
_DIFF = [-1.0, 0.0, 1.0]
_CV_SCALE = 1.0 / 1024.0
_FLT_EPSILON = 1.1920929e-07
_MAX_ORIGIN = float(1 << 30)
_EXCLUSION_RADIUS = 5


class State(NamedTuple):
    """The track table, as flow/tracker.py::TrackerState holds it."""

    traj: torch.Tensor  # (T, L, 2) float32
    length: torch.Tensor  # (T,) int32
    alive: torch.Tensor  # (T,) bool
    frame_idx: int


class Prepared(NamedTuple):
    """A frame's padded pyramid levels and their zero-padded Scharr
    derivatives, finest first, and the frame itself for detection."""

    imgs: list
    dxs: list
    dys: list
    gray: torch.Tensor  # (H, W) float32


def _pad(win_w: int, win_h: int, margin: int) -> int:
    """The port's frame pad for init-centred crops (ops/lk.py::_frame_pad
    with points_lanes): the clipped init reaches win + 2 past the frame,
    the crop margin past it, and the x extent is rounded to 8."""
    crop_x = win_w + 1 + 2 * margin
    slack = (-crop_x) % 8
    return max(max(win_w, win_h) + 2, win_w + margin + 3 + slack, win_h + margin + 3)


def _fix(x: torch.Tensor) -> torch.Tensor:
    """OpenCV's W_BITS quantization: the 1/32-intensity grid."""
    return torch.floor(x * 32.0 + 0.5) * (1.0 / 32.0)


def _sum64(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-point sum of x * y over the window, exact in float64 (every
    term lies on the 1/1024 grid), rounded to float32."""
    return (x.double() * y.double()).sum(dim=(1, 2)).float()


def patch_windows(planes: torch.Tensor, tl: torch.Tensor, size_h: int, size_w: int, quantize: bool) -> torch.Tensor:
    """(N, C, size_h, size_w) bilinear windows of planes (C, Hp, Wp) at
    fractional top-lefts tl (N, 2) [x, y]: the (size_h+1, size_w+1) crop
    at the integer origin, placed as XLA's dynamic_slice places it (a
    negative start wrapped by the size, then clamped into the plane),
    weights formed first and the four products summed in order."""
    c, hp, wp = planes.shape
    dev = planes.device
    ip = torch.floor(tl)
    frac = tl - ip
    ipi = torch.clamp(ip, -_MAX_ORIGIN, _MAX_ORIGIN).to(torch.int64)

    def start(s, dim, size):
        return torch.where(s < 0, s + dim, s).clamp(0, dim - size)

    x0 = start(ipi[:, 0], wp, size_w + 1)
    y0 = start(ipi[:, 1], hp, size_h + 1)
    rows = y0[:, None] + torch.arange(size_h + 1, device=dev)
    cols = x0[:, None] + torch.arange(size_w + 1, device=dev)
    chans = torch.arange(c, device=dev)[None, :, None, None]
    raw = planes[chans, rows[:, None, :, None], cols[:, None, None, :]]
    ax = frac[:, 0].reshape(-1, 1, 1, 1)
    ay = frac[:, 1].reshape(-1, 1, 1, 1)
    w00 = (1 - ax) * (1 - ay)
    w10 = ax * (1 - ay)
    w01 = (1 - ax) * ay
    w11 = ax * ay
    out = (raw[..., :size_h, :size_w] * w00 + raw[..., :size_h, 1:] * w10
           + raw[..., 1:, :size_w] * w01 + raw[..., 1:, 1:] * w11)
    return _fix(out) if quantize else out


def min_eig_map(img: torch.Tensor, block_size: int) -> torch.Tensor:
    """cornerMinEigenVal: aperture-3 Sobel gradients scaled by
    1 / (4 block_size 255), block sums of the structure tensor with
    reflect-101 borders (x first, by doubling), the smaller eigenvalue."""
    s = 1.0 / ((1 << 2) * block_size * 255)
    ix = sep_conv2d(img, _SOBEL_SMOOTH, _DIFF) * s
    iy = sep_conv2d(img, _DIFF, _SOBEL_SMOOTH) * s
    r = block_size // 2

    def box(x):
        x = pad_axis(pad_axis(x, -2, r, r, "reflect"), -1, r, r, "reflect")
        return _box1d(_box1d(x, block_size, -1), block_size, -2)

    a, b, c = box(ix * ix), box(ix * iy), box(iy * iy)
    d = a - c
    return ((a + c) - torch.sqrt(d * d + 4.0 * b * b)) * 0.5


class TrackerReference:
    """The tracker of one configuration (its `lk`, `tracker` and
    `features` groups) at frames of one size, on `device`."""

    def __init__(self, cfg: dict, device, data_dtype: torch.dtype = torch.float32):
        lk = cfg["lk"]
        if not lk.get("points_lanes") or lk.get("slab_margin") is None:
            raise ValueError("the reference holds the init-centred point geometry (points_lanes, slab_margin) only")
        self.lk = lk
        self.tr = cfg["tracker"]
        self.feat = cfg["features"]
        self.device = torch.device(device)
        self.data_dtype = data_dtype
        self.win_w, self.win_h = lk["win_size"]
        self.max_level = lk["max_level"]
        self.m = lk["slab_margin"]
        self.pad = _pad(self.win_w, self.win_h, self.m)
        self.halfwin = torch.tensor([(self.win_w - 1) * 0.5, (self.win_h - 1) * 0.5], dtype=torch.float32,
                                    device=self.device)

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        if self.data_dtype == torch.float32:
            return x
        return x.to(self.data_dtype).to(torch.float32)

    def empty(self) -> State:
        t, n = self.tr["max_tracks"], self.tr["trajectory_len"]
        return State(torch.zeros((t, n, 2), dtype=torch.float32, device=self.device),
                     torch.zeros((t,), dtype=torch.int32, device=self.device),
                     torch.zeros((t,), dtype=torch.bool, device=self.device), 0)

    def prepare(self, frame: torch.Tensor) -> Prepared:
        """A (H, W) frame in [0, 255] (u8 welcome): the u8-rounded pyrDown
        levels, reflect-101 padded, and their zero-padded Scharr
        derivatives."""
        gray = frame.to(self.device).to(torch.float32)
        lv, levels = gray, [gray]
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
            dxs.append(F.pad(dx, (p, p, p, p)))
            dys.append(F.pad(dy, (p, p, p, p)))
        return Prepared(imgs, dxs, dys, gray)

    def _level(self, tmpl, plane_p, tl0, crop_org, level_w, level_h, stats):
        """One LK level at N points in the centred geometry: the top-lefts
        after the level's iterations."""
        lk, m, pad = self.lk, self.m, self.pad
        win_w, win_h = self.win_w, self.win_h
        eps2 = float(max(lk["eps"], 0.0) ** 2)
        dev = tmpl.device
        iw, ixw, iyw = tmpl[:, 0], tmpl[:, 1], tmpl[:, 2]
        a11 = _sum64(ixw, ixw) * _CV_SCALE
        a12 = _sum64(ixw, iyw) * _CV_SCALE
        a22 = _sum64(iyw, iyw) * _CV_SCALE
        det = a11 * a22 - a12 * a12
        d = a11 - a22
        min_eig = (a22 + a11 - torch.sqrt(d * d + 4.0 * a12 * a12)) / (2.0 * win_w * win_h)
        bad = (min_eig < lk["min_eig_threshold"]) | (det < _FLT_EPSILON)
        inv_det = torch.where(det > 0, 1.0 / det, torch.zeros_like(det))
        active = ~bad
        if stats is not None:
            stats.append({"good": int(active.sum()), "iterations": 0})
        tlx, tly = tl0[:, 0].clone(), tl0[:, 1].clone()
        pdx = torch.zeros_like(tlx)
        pdy = torch.zeros_like(tly)
        hp, wp = plane_p.shape
        cw, ch = win_w + 1 + 2 * m, win_h + 1 + 2 * m
        ox0 = torch.clamp(crop_org[:, 0] + pad, 0, wp - cw)
        oy0 = torch.clamp(crop_org[:, 1] + pad, 0, hp - ch)
        rr = torch.arange(win_h + 1, device=dev)
        cc = torch.arange(win_w + 1, device=dev)
        for j in range(lk["max_iters"]):
            ixf = torch.floor(tlx)
            iyf = torch.floor(tly)
            oob = (ixf < -win_w) | (ixf >= level_w) | (iyf < -win_h) | (iyf >= level_h)
            active = active & ~oob
            if stats is not None:
                stats[-1]["iterations"] += int(active.sum())
            ax = (tlx - ixf)[:, None, None]
            ay = (tly - iyf)[:, None, None]
            ox = torch.clamp(ixf.to(torch.int32) - crop_org[:, 0], 0, 2 * m)
            oy = torch.clamp(iyf.to(torch.int32) - crop_org[:, 1], 0, 2 * m)
            rows = (oy0 + oy)[:, None] + rr
            cols = (ox0 + ox)[:, None] + cc
            raw = plane_p[rows[:, :, None], cols[:, None, :]]
            v = (raw[:, :win_h, :win_w] * (1 - ax) * (1 - ay) + raw[:, :win_h, 1:] * ax * (1 - ay)
                 + raw[:, 1:, :win_w] * (1 - ax) * ay + raw[:, 1:, 1:] * ax * ay)
            jw = self._q(_fix(v))
            diff = jw - iw
            b1 = _sum64(diff, ixw) * _CV_SCALE
            b2 = _sum64(diff, iyw) * _CV_SCALE
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
        return torch.stack([tlx, tly], dim=-1)

    def track_points(self, prev: Prepared, nxt: Prepared, pts: torch.Tensor, stats: list | None = None) -> torch.Tensor:
        """Pyramidal LK: pts (N, 2) [x, y] of `prev` tracked into `nxt`.
        `stats`, if a list, receives each level's {"good", "iterations"}
        (templates past the spectral gate; point-iterations that sample a
        window), top level first."""
        win_w, win_h, pad = self.win_w, self.win_h, self.pad
        halfwin = self.halfwin
        center = pts * (1.0 / (1 << self.max_level))
        for level in range(self.max_level, -1, -1):
            if level != self.max_level:
                center = center * 2.0
            img_p = prev.imgs[level]
            h = img_p.shape[-2] - 2 * pad
            w = img_p.shape[-1] - 2 * pad
            tmpl_tl = pts * (1.0 / (1 << level)) - halfwin
            it = torch.floor(tmpl_tl)
            oob = (it[:, 0] < -win_w) | (it[:, 0] >= w) | (it[:, 1] < -win_h) | (it[:, 1] >= h)
            planes = torch.stack([img_p, prev.dxs[level], prev.dys[level]], dim=-3)
            tmpl = self._q(patch_windows(planes, tmpl_tl + float(pad), win_h, win_w, True))
            tmpl = torch.where(oob[:, None, None, None], torch.zeros_like(tmpl), tmpl)
            tl0 = center - halfwin
            tl0 = torch.stack([torch.clamp(tl0[:, 0], -(win_w + 2.0), w + 2.0),
                               torch.clamp(tl0[:, 1], -(win_h + 2.0), h + 2.0)], dim=-1)
            crop_org = torch.floor(tl0).to(torch.int32) - self.m
            tl = self._level(tmpl, nxt.imgs[level], tl0, crop_org, w, h, stats)
            center = tl + halfwin
        return center

    @staticmethod
    def heads(state: State) -> torch.Tensor:
        """Each slot's last valid point (its first entry where empty)."""
        idx = torch.clamp(state.length.to(torch.int64) - 1, 0, state.traj.shape[1] - 1)
        return state.traj[torch.arange(state.traj.shape[0], device=idx.device), idx]

    def _append(self, state: State, new_heads: torch.Tensor, keep: torch.Tensor) -> State:
        t, n = state.traj.shape[:2]
        at_cap = state.length >= n
        traj = torch.where((keep & at_cap)[:, None, None], torch.roll(state.traj, -1, dims=1), state.traj)
        idx = torch.clamp(torch.where(at_cap, n - 1, state.length), 0, n - 1).to(torch.int64)
        updated = traj.clone()
        updated[torch.arange(t, device=idx.device), idx] = new_heads
        traj = torch.where(keep[:, None, None], updated, traj)
        length = torch.where(keep, torch.clamp(state.length + 1, max=n), state.length)
        return state._replace(traj=traj, length=length, alive=keep)

    def _exclusion(self, state: State, h: int, w: int) -> torch.Tensor:
        """(h, w) u8: 255 except for r = 5 zero discs at the live heads,
        each centred at the head rounded half to even, clipped to the
        frame."""
        r = _EXCLUSION_RADIUS
        heads = self.heads(state)
        dev = heads.device
        dd = torch.arange(-r, r + 1, device=dev)
        dy, dx = torch.meshgrid(dd, dd, indexing="ij")
        inside = (dx * dx + dy * dy) <= r * r
        hx = torch.round(heads[:, 0]).to(torch.int64)
        hy = torch.round(heads[:, 1]).to(torch.int64)
        ys = torch.clamp(hy[:, None, None] + dy[None], 0, h - 1)
        xs = torch.clamp(hx[:, None, None] + dx[None], 0, w - 1)
        val = torch.where(state.alive[:, None, None] & inside[None], 0, 255).to(torch.int32)
        mask = torch.full((h * w,), 255, dtype=torch.int32, device=dev)
        mask = mask.scatter_reduce(0, (ys * w + xs).reshape(-1), val.reshape(-1), "amin")
        return mask.reshape(h, w).to(torch.uint8)

    def corners(self, gray: torch.Tensor, mask: torch.Tensor) -> np.ndarray:
        """(k, 2) float32 [x, y] Shi-Tomasi corners where mask is nonzero,
        strongest first (k <= max_corners), on the host."""
        f = self.feat
        h, w = gray.shape
        eig = min_eig_map(gray, f["block_size"])
        eig = torch.where(mask != 0, eig, torch.zeros_like(eig))
        thresh = eig.max() * f["quality_level"]
        eig = torch.where(eig >= thresh, eig, torch.zeros_like(eig))
        dil = F.max_pool2d(eig[None, None], 3, stride=1, padding=1)[0, 0]
        border = torch.zeros((h, w), dtype=torch.bool, device=eig.device)
        border[1:h - 1, 1:w - 1] = True
        cand = torch.where((eig > 0) & (eig == dil) & border, eig, torch.zeros_like(eig))
        k = min(f["max_candidates"], h * w)
        vals, idx = torch.sort(cand.reshape(-1), descending=True, stable=True)
        ok = (vals[:k] > 0).cpu().numpy()
        idx = idx[:k].cpu().numpy()
        cxy = np.stack([(idx % w).astype(np.float32), (idx // w).astype(np.float32)], axis=-1)
        min_d2 = np.float32(f["min_distance"] ** 2)
        taken: list = []
        for i in np.flatnonzero(ok):
            if len(taken) == f["max_corners"]:
                break
            if all(((cxy[i] - q) ** 2).sum(dtype=np.float32) >= min_d2 for q in taken):
                taken.append(cxy[i])
        return np.asarray(taken, np.float32).reshape(-1, 2)

    def _spawn(self, state: State, pts: np.ndarray) -> State:
        free = torch.nonzero(~state.alive).flatten()[: len(pts)]
        if free.numel() == 0:
            return state
        traj, length, alive = state.traj.clone(), state.length.clone(), state.alive.clone()
        traj[free, 0] = torch.from_numpy(pts[: free.numel()]).to(traj.device)
        length[free] = 1
        alive[free] = True
        return state._replace(traj=traj, length=length, alive=alive)

    def step(self, state: State, prev: Prepared, cur: Prepared, stats: list | None = None) -> State:
        """One frame: `state` after tracking from `prev` into `cur`.
        `stats`, if a list, receives the six LK levels' work, forward
        levels first."""
        heads = self.heads(state)
        p1 = self.track_points(prev, cur, heads, stats)
        p0r = self.track_points(cur, prev, p1, stats)
        d = (heads - p0r).abs().amax(dim=-1)
        keep = state.alive & (d < self.tr["fb_max_dist"])
        new = self._append(state, p1, keep)
        if state.frame_idx % self.tr["detect_interval"] == 0:
            new = self._spawn(new, self.corners(cur.gray, self._exclusion(new, *cur.gray.shape)))
        return new._replace(frame_idx=state.frame_idx + 1)

    def seed(self, frame: torch.Tensor, state: State | None = None) -> State:
        """The step of `frame` against itself, which detects the first
        corners (the JAX package's callers seed a clip so)."""
        prep = self.prepare(frame)
        return self.step(self.empty() if state is None else state, prep, prep)

    def run(self, state: State, frames: torch.Tensor) -> tuple[State, tuple]:
        """track_video's form over (F, H, W) frames: the state after the
        last one and the history (heads (F-1, T, 2), alive (F-1, T),
        length (F-1, T))."""
        prev = self.prepare(frames[0])
        heads, alive, length = [], [], []
        for t in range(1, frames.shape[0]):
            cur = self.prepare(frames[t])
            state = self.step(state, prev, cur)
            heads.append(self.heads(state))
            alive.append(state.alive)
            length.append(state.length)
            prev = cur
        return state, (torch.stack(heads), torch.stack(alive), torch.stack(length))
