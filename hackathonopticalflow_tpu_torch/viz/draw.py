"""Host-side rasterization primitives (the port's copy of
hackathonopticalflow_tpu/viz/draw.py).

The reference leans on OpenCV's drawing stack (polylines/circle/rectangle/
line/putText/add — see pathfinder_viewer.py:51-223). Visualization is not
performance-critical and stays on the host; these primitives use cv2 when
present (pixel-identical to the reference) and fall back to a small pure-
numpy rasterizer (Bresenham lines, distance-test circles) so the framework
renders headlessly without OpenCV.
"""

from __future__ import annotations

import numpy as np

try:  # pragma: no cover
    import cv2

    HAVE_CV2 = True
except Exception:  # pragma: no cover
    cv2 = None
    HAVE_CV2 = False


def _line_np(img: np.ndarray, p0, p1, color, thickness=1) -> None:
    x0, y0 = int(round(p0[0])), int(round(p0[1]))
    x1, y1 = int(round(p1[0])), int(round(p1[1]))
    h, w = img.shape[:2]
    n = max(abs(x1 - x0), abs(y1 - y0), 1)
    xs = np.linspace(x0, x1, n + 1).round().astype(int)
    ys = np.linspace(y0, y1, n + 1).round().astype(int)
    r = thickness // 2
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            xi = np.clip(xs + dx, 0, w - 1)
            yi = np.clip(ys + dy, 0, h - 1)
            ok = (xs + dx >= 0) & (xs + dx < w) & (ys + dy >= 0) & (ys + dy < h)
            img[yi[ok], xi[ok]] = color


def line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> np.ndarray:
    if HAVE_CV2:
        cv2.line(img, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])), color, thickness)
    else:
        _line_np(img, p0, p1, color, thickness)
    return img


def polylines(img: np.ndarray, lines_arr, color, thickness: int = 1) -> np.ndarray:
    """lines_arr: iterable of (K, 2) int arrays (open polylines)."""
    if HAVE_CV2:
        cv2.polylines(img, [np.int32(l) for l in lines_arr], False, color, thickness)
        return img
    for l in lines_arr:
        l = np.asarray(l)
        for i in range(len(l) - 1):
            _line_np(img, l[i], l[i + 1], color, thickness)
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = 1) -> np.ndarray:
    if HAVE_CV2:
        cv2.circle(img, (int(center[0]), int(center[1])), radius, color, thickness)
        return img
    h, w = img.shape[:2]
    cx, cy = int(round(center[0])), int(round(center[1]))
    y0, y1 = max(cy - radius - 1, 0), min(cy + radius + 2, h)
    x0, x1 = max(cx - radius - 1, 0), min(cx + radius + 2, w)
    if y0 >= y1 or x0 >= x1:
        return img
    ys, xs = np.mgrid[y0:y1, x0:x1]
    d2 = (xs - cx) ** 2 + (ys - cy) ** 2
    if thickness < 0:
        m = d2 <= radius**2
    else:
        m = (d2 <= (radius + thickness * 0.5) ** 2) & (d2 >= (radius - thickness * 0.5) ** 2)
    img[y0:y1, x0:x1][m] = color
    return img


def rectangle(img: np.ndarray, p0, p1, color, thickness: int = 1) -> np.ndarray:
    if HAVE_CV2:
        cv2.rectangle(img, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])), color, thickness)
        return img
    x0, y0 = p0
    x1, y1 = p1
    for a, b in (((x0, y0), (x1, y0)), ((x1, y0), (x1, y1)), ((x1, y1), (x0, y1)), ((x0, y1), (x0, y0))):
        _line_np(img, a, b, color, thickness)
    return img


def put_text(img: np.ndarray, text: str, org, scale: float = 1.0, color=(0, 255, 0), thickness: int = 2) -> np.ndarray:
    """FPS/frame overlays (pathfinder_viewer.py:304-307,355-356). Without
    cv2 this is a no-op (text is cosmetic)."""
    if HAVE_CV2:
        cv2.putText(img, text, (int(org[0]), int(org[1])), cv2.FONT_HERSHEY_COMPLEX, scale, color, thickness)
    return img


def add_layers(*layers: np.ndarray) -> np.ndarray:
    """Saturating uint8 addition — cv2.add compositing
    (pathfinder_viewer.py:294-312)."""
    acc = layers[0].astype(np.int32)
    for l in layers[1:]:
        acc = acc + l.astype(np.int32)
    return np.clip(acc, 0, 255).astype(np.uint8)
