"""Scrolling metrics chart rendered to a numpy image (the port's copy of
hackathonopticalflow_tpu/viz/plotter.py, over viz/draw.py: cv2 where it
imports, else the numpy rasterizer).

Replaces Operations.Plotter (Operations.py:128-200): per-label ring
buffers, vertical autoscale around a zero axis, margins, optional value/dt
text and current-value dot — but renders into a returned BGR array
(imshow-able by apps, writable to video headlessly) instead of forcing a
GUI loop.
"""

from __future__ import annotations

import time

import numpy as np

from .draw import circle, line, put_text, rectangle


class Plotter:
    def __init__(self, width: int = 800, height: int = 400, sample_buffer: int | None = None):
        self.width = width
        self.height = height
        self.color = (255, 0, 0)
        self.margin_l = 10
        self.margin_r = 10
        self.margin_u = 10
        self.margin_d = 50
        self.sample_buffer = sample_buffer or width
        self.plots: dict[str, list[float]] = {}
        self.plot_t_last: dict[str, float] = {}

    def plot(self, val: float, label: str = "plot") -> None:
        buf = self.plots.setdefault(label, [])
        self.plot_t_last.setdefault(label, 0.0)
        buf.append(float(val))
        while len(buf) > self.sample_buffer:
            buf.pop(0)

    def render(self, label: str, time_text: bool = False) -> np.ndarray:
        canvas = np.zeros((self.height, self.width, 3), np.uint8)
        data = self.plots.get(label, [])
        mid_y = int((self.height - self.margin_d - self.margin_u) / 2) + self.margin_u
        line(canvas, (self.margin_l, mid_y), (self.width - self.margin_r, mid_y), (0, 0, 255), 1)
        if len(data) >= 2:
            scale_h = max(max(data), -min(data), 1e-9)
            scale = ((self.height - self.margin_d - self.margin_u) / 2) / scale_h
            xs = np.linspace(0, len(data) - 2, self.width - self.margin_l - self.margin_r)
            for j, i in enumerate(xs.astype(int)):
                y0 = int(mid_y - data[i] * scale)
                y1 = int(mid_y - data[i + 1] * scale)
                line(canvas, (j + self.margin_l, y0), (j + self.margin_l, y1), self.color, 1)
            circle(
                canvas,
                (self.width - self.margin_r, int(mid_y - data[-1] * scale)),
                2,
                (0, 200, 200),
                -1,
            )
        rectangle(
            canvas,
            (self.margin_l, self.margin_u),
            (self.width - self.margin_r, self.height - self.margin_d),
            (255, 255, 255),
            1,
        )
        if time_text and data:
            dt_ms = int((time.time() - self.plot_t_last[label]) * 1000)
            put_text(
                canvas,
                f" {label} : {data[-1]:.3g} , dt : {dt_ms}ms",
                (0, self.height - 20),
                0.6,
                (0, 255, 255),
                2,
            )
        self.plot_t_last[label] = time.time()
        return canvas


def draw_plot(values: list[float], label: str = "graph") -> np.ndarray:
    """Static chart from a value list (Operations.draw_plot analog)."""
    p = Plotter(max(2 * (len(values) - 1), 64), 400, sample_buffer=len(values) - 1 or 1)
    for v in values:
        p.plot(v, label)
    return p.render(label)
