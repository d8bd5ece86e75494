"""Synthetic flight clips and the readers that hand them to the port.

The clip is a frozen copy of chip_smoke.py's zoom clip: a seeded smooth
random texture, stored as u8, each frame zoomed by `zoom` about the centre
as in forward flight, made on the device from the seed (a torch.Generator
on that device, a few large calls). A run is longer than any clip the card
could hold, so a stream plays its clip of N frames forwards, then
backwards, over and over (`loop_index`): every consecutive pair is a real
zoom in or out, never a repeated frame and never a jump between unrelated
frames, and a run sees only 2 (N - 1) distinct pairs, which the reference
can check one by one.

The readers have io/video.py's VideoReader interface (height, width, fps,
length, seek, read, release) over host (N, H, W, 3) u8 BGR frames: decode
is bypassed, and the port's own gray conversion still runs on what read()
returns. `LoopReader` serves as fast as it is read (a closed loop) until a
deadline; `PacedReader` releases frame i at t0 + i / fps (an open loop, a
camera) until a deadline. read() returns a view of the clip: it costs
nothing and holds no lock.
"""

from __future__ import annotations

import math
import time
from typing import Callable

import numpy as np
import torch


def stream_seed(seed: int, stream: int) -> int:
    """The clip seed of `stream` in a run of `seed` (any whole number up
    to 2**63): 63 bits from numpy's SeedSequence."""
    return int(np.random.SeedSequence([int(seed), int(stream)]).generate_state(1, np.uint64)[0] >> np.uint64(1))


def smooth_texture(gen: torch.Generator, device, h: int, w: int, cell: int) -> torch.Tensor:
    """Random lattice (spacing `cell` px, wide enough for the whole clip),
    blurred by four [1/4, 1/2, 1/4] passes, scaled to [10, 245]."""
    ly, lx = h // cell + 8, w // cell + 8
    lat = torch.rand((ly, lx), generator=gen, dtype=torch.float64, device=device)
    k = (0.25, 0.5, 0.25)
    for _ in range(4):
        p = torch.nn.functional.pad(lat[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
        lat = k[0] * p[:-2, 1:-1] + k[1] * p[1:-1, 1:-1] + k[2] * p[2:, 1:-1]
        p = torch.nn.functional.pad(lat[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
        lat = k[0] * p[1:-1, :-2] + k[1] * p[1:-1, 1:-1] + k[2] * p[1:-1, 2:]
    lat = (lat - lat.min()) / (lat.max() - lat.min())
    return 10.0 + 235.0 * lat


def sample_texture(lat: torch.Tensor, x: torch.Tensor, y: torch.Tensor, cell: int) -> torch.Tensor:
    """The texture at float64 pixel coordinates: bilinear in the lattice,
    whose node (0, 0) sits at pixel (-4 cell, -4 cell)."""
    u = x / cell + 4.0
    v = y / cell + 4.0
    u0 = torch.floor(u).clamp(0, lat.shape[1] - 2)
    v0 = torch.floor(v).clamp(0, lat.shape[0] - 2)
    fu, fv = u - u0, v - v0
    iu, iv = u0.long(), v0.long()
    return (
        lat[iv, iu] * (1 - fu) * (1 - fv)
        + lat[iv, iu + 1] * fu * (1 - fv)
        + lat[iv + 1, iu] * (1 - fu) * fv
        + lat[iv + 1, iu + 1] * fu * fv
    )


def make_clip(device, h: int, w: int, n: int, cell: int, seed: int, zoom: float) -> torch.Tensor:
    """(n, h, w) uint8 on `device`: frame t is the texture (lattice
    spacing `cell` px, drawn from `seed`) zoomed by zoom**t about the
    centre (content expands outwards, as in forward flight)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    lat = smooth_texture(gen, device, h, w, cell)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=device),
        torch.arange(w, dtype=torch.float64, device=device),
        indexing="ij",
    )
    frames = torch.empty((n, h, w), dtype=torch.uint8, device=device)
    for t in range(n):
        s = zoom**t
        img = sample_texture(lat, cx + (xx - cx) / s, cy + (yy - cy) / s, cell)
        frames[t] = torch.floor(img + 0.5).to(torch.uint8)
    return frames


def host_bgr(gray: torch.Tensor) -> np.ndarray:
    """(n, h, w) uint8 gray frames -> host (n, h, w, 3) uint8 BGR, the
    gray value in every channel."""
    return np.ascontiguousarray(gray.unsqueeze(-1).expand(*gray.shape, 3).cpu().numpy())


def loop_index(pos: int, n: int) -> int:
    """The clip frame shown at playback position `pos` of a clip of n
    frames played forwards, then backwards, over and over."""
    if n < 2:
        raise ValueError("a looping clip needs at least 2 frames")
    period = 2 * (n - 1)
    q = pos % period
    return q if q < n else period - q


def pair_at(k: int, n: int) -> tuple[int, int]:
    """The clip frames (previous, current) of the k-th pair (k >= 1) of a
    stream read from position 0: positions k - 1 and k."""
    return loop_index(k - 1, n), loop_index(k, n)


class LoopReader:
    """VideoReader interface over a looping clip, read as fast as the
    caller reads (a closed loop); read() returns None once `deadline`
    (on `clock`) has passed or `limit` frames were served."""

    def __init__(self, bgr: np.ndarray, deadline: float = math.inf, limit: int | None = None,
                 clock: Callable[[], float] = time.perf_counter, fps: float = 60.0):
        self.bgr = bgr
        self.n, self.height, self.width = bgr.shape[:3]
        self.length = limit if limit is not None else 2**31 - 1
        self.fps = fps
        self.deadline = deadline
        self.limit = limit
        self.clock = clock
        self.pos = 0  # frames served

    def seek(self, frame_idx: int) -> None:
        self.pos = frame_idx

    def read(self) -> np.ndarray | None:
        if (self.limit is not None and self.pos >= self.limit) or self.clock() >= self.deadline:
            return None
        frame = self.bgr[loop_index(self.pos, self.n)]
        self.pos += 1
        return frame

    def release(self) -> None:
        pass


class PacedReader(LoopReader):
    """A camera: frame i of the loop is due at t0 + i / fps; read() waits
    until the next frame is due (or returns it at once if it is overdue)
    and returns None for a frame due at or after `deadline`. `due` and
    `released` keep each served frame's due and release times."""

    def __init__(self, bgr: np.ndarray, t0: float, fps: float, deadline: float,
                 clock: Callable[[], float] = time.perf_counter, sleep: Callable[[float], None] = time.sleep):
        super().__init__(bgr, deadline=deadline, clock=clock, fps=fps)
        self.t0 = t0
        self.sleep = sleep
        self.due: list[float] = []
        self.released: list[float] = []

    def read(self) -> np.ndarray | None:
        due = self.t0 + self.pos / self.fps
        if due >= self.deadline:
            return None
        wait = due - self.clock()
        if wait > 0:
            self.sleep(wait)
        self.due.append(due)
        self.released.append(self.clock())
        frame = self.bgr[loop_index(self.pos, self.n)]
        self.pos += 1
        return frame


class Opener:
    """An `open_reader` for the port's apps: open_reader(name) returns the
    reader the harness set for that video name."""

    def __init__(self):
        self.readers: dict[str, LoopReader] = {}

    def __call__(self, name: str) -> LoopReader:
        return self.readers[name]
