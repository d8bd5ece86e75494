"""The dense-flow viewer (port of hackathonopticalflow_tpu/apps/dense_viewer.py;
the reference's DenseOF.py:443-672).

Per frame pair (device): Farneback dense flow (flow/dense.py::
farneback_flow at cfg.fb, any warp mode) and grid LK (flow/lk_grid.py::
lk_grid_flow at cfg.lk, the exact path LKParams(), with PROTO_FILTER);
(host): decode, gray conversion (io/prefetch.py's to_gray), the
prototype's display modes (gray, RGB, R, G, B, HSV, H, S, V, cycled by
`), flow glyphs, the HSV wheel, danger lamps, the contours window, an FPS
overlay, and the reference keyboard map (` modes, 1 flow, 2 HSV layer,
3 HSV window, 4 contours, 5 vectors, 6 lamps, q/esc quit).

Colour conversions run through ops/color.py, contours through
ops/image.py's threshold_binary and io/native_lib.py's border following,
drawing through viz/ (cv2 where installed, else its numpy rasterizer), so
a headless run needs no cv2. Decoding a file (the default reader), writing
an mp4 and the interactive windows do. Frames come from
`open_reader(video)`: cv2's `VideoReader` by default, or any reader with
height, width, fps, seek(i) and read().
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from ..core import PROTO_FILTER, FarnebackParams, FilterParams, LKParams, measurement_grid
from ..flow.dense import farneback_flow
from ..flow.device import resolve_device
from ..flow.lk_grid import lk_grid_flow
from ..io import native_lib
from ..io.prefetch import to_gray, upload
from ..io.video import VideoReader
from ..ops import color
from ..ops.image import threshold_binary
from ..viz.draw import add_layers, polylines, put_text
from ..viz.layers import _host, draw_flow, draw_grid, draw_grid_vectors, draw_hsv, draw_sparse_lamps
from .pathfinder import _need_cv2

#: display modes (DenseOF.py:486-488): 0 gray, 1 RGB, 2 R, 3 G, 4 B,
#: 5 HSV, 6 H, 7 S, 8 V
DEFAULT_MODES = [0, 1, 6, 7, 8]
MODE_NAMES = ["gray", "RGB", "R", "G", "B", "HSV", "H", "S", "V"]


@dataclasses.dataclass
class DenseViewerConfig:
    video: str
    add_flow: bool = False  # DenseOF.py:7
    add_sparse_flow: bool = True  # :8
    add_hsv: bool = False  # :9
    show_hsv: bool = False  # :10
    show_contours: bool = False  # :11
    add_sparse_hsv: bool = True  # :12 (rendered as lamps, like the proto)
    start_frame: int = 0
    step: int = 30
    max_frames: int | None = None
    viewing_angle: float = 155.0
    fb: FarnebackParams = FarnebackParams()
    lk: LKParams = LKParams()
    filt: FilterParams = PROTO_FILTER  # DenseOF.py:228 variant
    contour_div: int = 63  # DenseOF.py:377
    contour_length: int = 150  # DenseOF.py:323
    #: where the flow runs: the GPU unless "cpu" is asked for
    device: str = "cuda"


def render_mode(img: np.ndarray, mode: int) -> tuple[np.ndarray, str]:
    """The 9 channel views (DenseOF.py:530-570) of an (H, W, 3) uint8 BGR
    frame, through ops/color.py: the gray view is cv2's bit for bit; the
    HSV views are the JAX package's float formula, within one level of
    cv2's integer tables (a hue that rounds up to 180 is cv2's 0)."""
    name = MODE_NAMES[mode]
    if mode == 1:
        return img, name
    if mode in (2, 3, 4):
        out = np.zeros_like(img)
        ch = {2: 2, 3: 1, 4: 0}[mode]
        out[..., ch] = img[..., ch]
        return out, name
    t = torch.from_numpy(np.ascontiguousarray(img))
    if mode == 0:
        return color.gray2bgr(color.bgr2gray(t)).numpy(), name
    hsv = color.bgr2hsv(t)
    if mode == 5:
        return hsv.numpy(), name
    return color.gray2bgr(hsv[..., mode - 6]).numpy(), name


def contour_layer(gray: np.ndarray, div: int = 63, contour_length: int = 150) -> np.ndarray:
    """Obstacle-outline layer (DenseOF.py:320-440): gray quantization,
    per-level binary threshold, native border following, length filter,
    white/red contour rendering."""
    h, w = gray.shape
    layer = np.zeros((h, w, 3), np.uint8)
    levels = sorted({(p // div) * div for p in range(0, 255)})
    img_div = torch.from_numpy(((gray // div) * div).astype(np.float32))
    for level in levels:
        binary = threshold_binary(img_div, float(level)).numpy()
        contours = native_lib.trace_contours(binary.astype(np.uint8))
        long_c = [c for c in contours if len(c) > contour_length]
        short_c = [c for c in contours if contour_length * 0.8 < len(c) <= contour_length]
        polylines(layer, long_c, (255, 255, 255), 1)
        polylines(layer, short_c, (0, 0, 255), 1)
    return layer


class DenseViewerApp:
    def __init__(self, cfg: DenseViewerConfig, open_reader: Callable = VideoReader):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.reader = open_reader(cfg.video)
        h, w = self.reader.height, self.reader.width
        self.pts = measurement_grid(h, w, cfg.step)
        self._pts_dev = torch.from_numpy(self.pts).to(self.device)
        self.mode_index = 0  # into DEFAULT_MODES

    def compute_frame(self, prev_gray: np.ndarray, gray: np.ndarray):
        """Device work for one frame pair: (dense flow (H, W, 2) or None,
        GridFlowResult or None), as the layers switched on need them;
        returns without waiting for the device. uint8 frames cross to the
        device and are cast there."""
        cfg = self.cfg
        a, b = upload(prev_gray, self.device), upload(gray, self.device)
        flow = None
        if cfg.add_flow or cfg.add_hsv or cfg.show_hsv:
            flow = farneback_flow(a, b, cfg.fb, device=self.device)
        sres = None
        if cfg.add_sparse_flow or cfg.add_sparse_hsv:
            sres = lk_grid_flow(a, b, self._pts_dev, cfg.lk, filt=cfg.filt, device=self.device)
        return flow, sres

    def render_frame(self, frame: np.ndarray, flow, sres, fps: float | None = None) -> np.ndarray:
        """Host-side compositing (DenseOF.py:530-640): the display mode,
        the switched-on layers and the markup; flow and sres hold tensors
        or arrays."""
        cfg = self.cfg
        h, w = frame.shape[:2]
        out, mode_name = render_mode(frame, DEFAULT_MODES[self.mode_index])
        layers = [out]
        flow_h = None if flow is None else _host(flow)
        if cfg.add_flow and flow_h is not None:
            layers.append(draw_flow((h, w), flow_h))
        if sres is not None:
            pts, next_pts, good = _host(sres.pts), _host(sres.next_pts), _host(sres.good)
            if cfg.add_sparse_flow:
                layers.append(draw_grid_vectors((h, w), pts, next_pts, good, draw_bad=True))
        if cfg.add_hsv and flow_h is not None:
            layers.append(draw_hsv(flow_h))
        if cfg.add_sparse_hsv and sres is not None:
            layers.append(draw_sparse_lamps((h, w), _host(sres.flow)[good], pts[good]))
        out = add_layers(*layers)
        out = add_layers(
            out,
            draw_grid((h, w), 20, colored_cross=True, viewing_angle_rect=True, cross=True, blinds=True,
                      viewing_angle=cfg.viewing_angle),
        )
        put_text(out, mode_name, (20, 150))
        if fps is not None:
            put_text(out, f"{fps:.2f} FPS", (20, 30))
        return out

    def run(self, headless: bool = True, out_path: str | None = None, on_pair: Callable | None = None) -> dict:
        """Process the video one frame pair at a time; returns run metrics.
        headless=False opens the interactive cv2 windows with the
        reference's keyboard map. on_pair(flow, sres, frame_out, contours),
        if given, receives each pair's device results, its composited frame
        and its contour layer (None unless show_contours)."""
        cfg = self.cfg
        if not headless:
            _need_cv2("interactive mode")
        reader = self.reader
        if cfg.start_frame:
            reader.seek(cfg.start_frame)
        prev = reader.read()
        if prev is None:
            raise IOError("no first frame")
        prev_gray = to_gray(prev)
        writer = None
        if out_path:
            _need_cv2("out_path")
            import cv2

            writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), reader.fps or 25.0,
                                     (reader.width, reader.height))
        n = 0
        t_start = time.time()
        while cfg.max_frames is None or n < cfg.max_frames:
            frame = reader.read()
            if frame is None:
                break
            gray = to_gray(frame)
            flow, sres = self.compute_frame(prev_gray, gray)
            prev_gray = gray
            out = self.render_frame(frame, flow, sres, fps=(n + 1) / max(time.time() - t_start, 1e-9))
            contours = None
            if cfg.show_contours:
                contours = contour_layer(gray, cfg.contour_div, cfg.contour_length)
            if on_pair is not None:
                on_pair(flow, sres, out, contours)
            if writer is not None:
                writer.write(out)
            n += 1
            if not headless and not self._show(out, flow, contours):
                break
        if writer is not None:
            writer.release()
        wall = time.time() - t_start
        return {"frames": n, "wall_s": wall, "fps": n / max(wall, 1e-9)}

    def _show(self, out: np.ndarray, flow, contours) -> bool:
        """The interactive windows and the reference keyboard map
        (DenseOF.py:600-672); False to quit."""
        import cv2

        cfg = self.cfg
        if contours is not None:
            cv2.imshow("contours", contours)
        if cfg.show_hsv and flow is not None:
            cv2.imshow("flow HSV", draw_hsv(_host(flow)))
        cv2.imshow("flow", out)
        key = cv2.waitKey(1) & 0xFF
        if key in (ord("q"), 27):
            return False
        if key == ord("`"):
            self.mode_index = (self.mode_index + 1) % len(DEFAULT_MODES)
        toggles = {"1": "add_flow", "2": "add_hsv", "3": "show_hsv", "4": "show_contours",
                   "5": "add_sparse_flow", "6": "add_sparse_hsv"}
        for k, field in toggles.items():
            if key == ord(k):
                setattr(cfg, field, not getattr(cfg, field))
        return True


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description="dense-flow viewer on PyTorch (GPU unless --device cpu)")
    p.add_argument("video")
    p.add_argument("--out", default=None, help="render target mp4 (needs cv2)")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--start-frame", type=int, default=0)
    p.add_argument("--dense", action="store_true", help="enable the Farneback flow and HSV layers")
    p.add_argument("--contours", action="store_true")
    p.add_argument("--interactive", action="store_true", help="cv2 windows (needs cv2)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cfg = DenseViewerConfig(
        video=args.video,
        max_frames=args.max_frames,
        start_frame=args.start_frame,
        add_flow=args.dense,
        add_hsv=args.dense,
        show_contours=args.contours,
        device=args.device,
    )
    print(DenseViewerApp(cfg).run(headless=not args.interactive, out_path=args.out))


if __name__ == "__main__":
    main()
