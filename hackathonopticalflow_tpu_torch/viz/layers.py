"""Reference-parity visualization layers (host side, numpy in / numpy out;
the port's copy of hackathonopticalflow_tpu/viz/layers.py).

Each function mirrors one drawing routine of the reference, unified from
the duplicated copies in pathfinder_viewer.py and DenseOF.py:

- draw_flow          pathfinder_viewer.py:51-73  (dense-flow glyphs)
- draw_grid          pathfinder_viewer.py:76-121 (frame markup layer)
- draw_hsv           pathfinder_viewer.py:124-141 (dense flow -> HSV wheel)
- draw_sparse_lamps  pathfinder_viewer.py:196-223 (danger lamps)
- draw_sparse_hsv    Operations.py:106-125 (sparse flow -> HSV circles)
- draw_tracks        SparseOF.py:51-57 (trajectory polylines)
- draw_grid_vectors  pathfinder_viewer.py:177-191 (good/bad LK vectors)

Color-space conversions run through the port's ops/color.py on CPU
tensors; the rasterization itself is host work via viz/draw.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import color
from .draw import circle, line, polylines, rectangle


def _host(x) -> np.ndarray:
    """Array or tensor -> contiguous WRITABLE host array (cv2 needs a
    writable C-order buffer)."""
    a = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    if not a.flags["C_CONTIGUOUS"]:
        a = np.ascontiguousarray(a)
    if not a.flags["WRITEABLE"]:
        a = a.copy()
    return a


def hsv2bgr(hsv: np.ndarray) -> np.ndarray:
    """ops/color.py's hsv2bgr of a host array, on a CPU tensor."""
    return _host(color.hsv2bgr(torch.from_numpy(np.ascontiguousarray(hsv))))


def draw_flow(img_shape: tuple[int, int], flow: np.ndarray, step: int = 14) -> np.ndarray:
    """Dense-flow glyph layer: segments (x,y)->(x-fx, y-fy) plus origin dots
    on a step-14 mgrid (pathfinder_viewer.py:51-73)."""
    h, w = img_shape
    img = np.zeros((h, w, 3), np.uint8)
    y, x = np.mgrid[step / 2 : h : step, step / 2 : w : step].reshape(2, -1).astype(int)
    fx, fy = np.asarray(flow)[y, x].T
    lines = np.vstack([x, y, x - fx, y - fy]).T.reshape(-1, 2, 2)
    lines = np.int32(lines + 0.5)
    polylines(img, lines, (0, 255, 0))
    for (x1, y1), _ in lines:
        circle(img, (x1, y1), 1, (0, 255, 0), -1)
    return img


def draw_grid_vectors(
    img_shape: tuple[int, int],
    pts: np.ndarray,
    next_pts: np.ndarray,
    good: np.ndarray,
    draw_bad: bool = True,
) -> np.ndarray:
    """Good (red, magenta origins) and filtered-out (cyan) LK vectors
    (pathfinder_viewer.py:177-191)."""
    h, w = img_shape
    img = np.zeros((h, w, 3), np.uint8)
    pts = np.asarray(pts)
    next_pts = np.asarray(next_pts)
    good = np.asarray(good)
    g_lines = np.concatenate([pts[good], next_pts[good]], axis=1).reshape(-1, 2, 2)
    polylines(img, g_lines, (0, 0, 255))
    for (x1, y1), _ in g_lines:
        circle(img, (x1, y1), 1, (255, 0, 255), 1)
    if draw_bad:
        b_lines = np.concatenate([pts[~good], next_pts[~good]], axis=1).reshape(-1, 2, 2)
        polylines(img, b_lines, (255, 255, 0))
        for (x1, y1), _ in b_lines:
            circle(img, (x1, y1), 1, (255, 255, 0), 1)
    return img


def draw_grid(
    img_shape: tuple[int, int],
    step: int = 20,
    colored_cross: bool = False,
    viewing_angle_rect: bool = False,
    cross: bool = False,
    grid: bool = False,
    blinds: bool = False,
    viewing_angle: float = 155.0,
    viewing_angle_req: float = 60.0,
) -> np.ndarray:
    """Frame markup layer (pathfinder_viewer.py:76-121): pixel grid, center
    cross, colored edge cross, propeller blinds, FOV rectangle."""
    h, w = img_shape
    half_w, half_h = int(w / 2), int(h / 2)
    img = np.zeros((h, w, 3), np.uint8)
    if grid:
        xl = [np.int32([[i, 0], [i, h]]) for i in range(step, w, step)]
        yl = [np.int32([[0, i], [w, i]]) for i in range(step, h, step)]
        polylines(img, xl, (0, 0, 100), 1)
        polylines(img, yl, (0, 0, 100), 1)
    if cross:
        polylines(img, [np.int32([[half_w, 0], [half_w, h]])], (0, 0, 255), 1)
        polylines(img, [np.int32([[0, half_h], [w, half_h]])], (0, 0, 255), 1)
    if colored_cross:
        line(img, (0, half_h), (15, half_h), (0, 0, 255), 5)
        line(img, (half_w, 0), (half_w, 15), (0, 255, 0), 5)
        line(img, (w, half_h), (w - 15, half_h), (255, 200, 170), 5)
        line(img, (half_w, h), (half_w, h - 15), (255, 100, 100), 5)
    if blinds:
        rectangle(img, (620, h - 200), (-1, h), (0, 0, 255), 1)
        rectangle(img, (w - 620, h - 200), (w, h), (0, 0, 255), 1)
    if viewing_angle_rect:
        if viewing_angle > viewing_angle_req:
            w_res = round(w * viewing_angle_req / viewing_angle)
            h_res = round(h * viewing_angle_req / viewing_angle)
            x0 = round((w - w_res) / 2)
            y0 = round((h - h_res) / 2)
            x1, y1 = x0 + w_res, y0 + h_res
        else:
            x0 = y0 = -1
            x1, y1 = w, h
        rectangle(img, (x0, y0), (x1, y1), (255, 0, 0), 3)
    return img


def draw_hsv(flow: np.ndarray) -> np.ndarray:
    """Dense flow -> HSV wheel image (pathfinder_viewer.py:124-141):
    hue = direction, value = min(4*magnitude, 255), saturation 255."""
    flow = np.asarray(flow)
    h, w = flow.shape[:2]
    fx, fy = flow[..., 0], flow[..., 1]
    ang = np.arctan2(fy, fx) + np.pi
    v = np.sqrt(fx * fx + fy * fy)
    hsv = np.zeros((h, w, 3), np.uint8)
    hsv[..., 0] = ang * (180 / np.pi / 2)
    hsv[..., 1] = 255
    hsv[..., 2] = np.minimum(v * 4, 255)
    return hsv2bgr(hsv)


def draw_sparse_lamps(
    img_shape: tuple[int, int],
    flow: np.ndarray,
    pts: np.ndarray,
) -> np.ndarray:
    """Danger-lamp layer (pathfinder_viewer.py:196-223): red circles r=6 at
    danger points, brightness min(50 + 2*magnitude, 255)."""
    h, w = img_shape
    flow = np.asarray(flow)
    pts = np.asarray(pts)
    fx, fy = flow[:, 0], flow[:, 1]
    modulus = np.sqrt(fx * fx + fy * fy)
    hsv = np.zeros((h, w, 3), np.uint8)
    xs = np.clip(pts[:, 0], 0, w - 1).astype(int)
    ys = np.clip(pts[:, 1], 0, h - 1).astype(int)
    hsv[ys, xs, 0] = 0
    hsv[ys, xs, 1] = 255
    hsv[ys, xs, 2] = np.minimum(50 + modulus * 2, 255).astype(np.uint8)
    bgr = hsv2bgr(hsv)
    for x, y in zip(xs, ys):
        color = tuple(int(c) for c in bgr[y, x])
        circle(bgr, (x, y), 6, color, -1)
    return bgr


def draw_sparse_hsv(
    img_shape: tuple[int, int],
    flow: np.ndarray,
    pts: np.ndarray,
) -> np.ndarray:
    """Sparse flow -> HSV-coded circles (Operations.py:106-125)."""
    h, w = img_shape
    flow = np.asarray(flow)
    pts = np.asarray(pts)
    fx, fy = flow[:, 0], flow[:, 1]
    ang = np.arctan2(fy, fx) + np.pi
    modulus = np.sqrt(fx * fx + fy * fy)
    hsv = np.zeros((h, w, 3), np.uint8)
    xs = np.clip(pts[:, 0], 0, w - 1).astype(int)
    ys = np.clip(pts[:, 1], 0, h - 1).astype(int)
    hsv[ys, xs, 0] = (ang * (180 / np.pi / 2)).astype(np.uint8)
    hsv[ys, xs, 1] = 255
    hsv[ys, xs, 2] = np.minimum(modulus * 4, 255).astype(np.uint8)
    bgr = hsv2bgr(hsv)
    for x, y in zip(xs, ys):
        color = tuple(int(c) for c in bgr[y, x])
        circle(bgr, (x, y), 6, color, -1)
    return bgr


def mark_points(
    img_or_shape, points: np.ndarray, margin_assert: bool = True
) -> np.ndarray:
    """15-px crosses at points on a fresh layer (Operations.mark_points,
    Operations.py:90-103; keeps its >=7-px margin assertion)."""
    if hasattr(img_or_shape, "shape"):
        h, w = img_or_shape.shape[:2]
    else:
        h, w = img_or_shape
    layer = np.zeros((h, w, 3), np.uint8)
    for x, y in np.asarray(points):
        if margin_assert:
            assert (x - 7 > 0) and (y - 7 > 0)
        polylines(
            layer,
            np.int32([[[x - 7, y], [x + 7, y]], [[x, y - 7], [x, y + 7]]]),
            (0, 0, 255),
            1,
        )
    return layer


def draw_tracks(
    img: np.ndarray,
    traj: np.ndarray,
    lengths: np.ndarray,
    alive: np.ndarray,
) -> np.ndarray:
    """Trajectory polylines + head dots over an image (SparseOF.py:51-57)."""
    traj = np.asarray(traj)
    lengths = np.asarray(lengths)
    alive = np.asarray(alive)
    for t in range(traj.shape[0]):
        if not alive[t] or lengths[t] < 1:
            continue
        pts = traj[t, : lengths[t]]
        polylines(img, [np.int32(pts)], (0, 255, 0))
        circle(img, (int(pts[-1, 0]), int(pts[-1, 1])), 2, (0, 0, 255), -1)
    return img
