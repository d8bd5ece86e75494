"""The reference's answers for the pairs a window produced, computed once
per distinct pair from the frames the harness handed to the port, after
the window has closed and the port's state is freed."""

from __future__ import annotations

import numpy as np
import torch

from ..reference.farneback import FarnebackReference
from ..reference.image import bgr2gray_u8
from ..reference.lk_grid import GridResult, LKGridReference


class LKPairs:
    """Grid-flow results and per-level work of (previous, current) clip
    frame pairs of one stream; frames are prepared once each."""

    def __init__(self, cfg: dict, bgr: np.ndarray, device, data_dtype=torch.float32):
        self.ref = LKGridReference(cfg, device, data_dtype)
        self.bgr = bgr
        self._prep: dict[int, tuple] = {}
        self._res: dict[tuple, GridResult] = {}
        self._stats: dict[tuple, list] = {}

    def _prepared(self, i: int):
        if i not in self._prep:
            gray = torch.from_numpy(bgr2gray_u8(self.bgr[i]))
            self._prep[i] = self.ref.prepare(gray)
        return self._prep[i]

    def result(self, a: int, b: int) -> GridResult:
        if (a, b) not in self._res:
            stats: list = []
            self._res[(a, b)] = self.ref.pair(self._prepared(a), self._prepared(b), stats)
            self._stats[(a, b)] = stats
        return self._res[(a, b)]

    def stats(self, a: int, b: int) -> list[dict]:
        """Per level, top first: {"good", "iterations"} of the pair."""
        self.result(a, b)
        return self._stats[(a, b)]

    def host(self, a: int, b: int) -> list[np.ndarray]:
        return [t.cpu().numpy() for t in self.result(a, b)]


class FarnebackPairs:
    """Farneback flows of (previous, current) clip frame pairs of one
    stream of gray frames."""

    def __init__(self, cfg: dict, gray: np.ndarray, device):
        self.ref = FarnebackReference(cfg, device)
        self.gray = gray
        self._prep: dict[int, list] = {}
        self._flow: dict[tuple, torch.Tensor] = {}

    def _prepared(self, i: int):
        if i not in self._prep:
            self._prep[i] = self.ref.prepare(torch.from_numpy(self.gray[i]))
        return self._prep[i]

    def flow(self, a: int, b: int) -> torch.Tensor:
        if (a, b) not in self._flow:
            self._flow[(a, b)] = self.ref.pair(self._prepared(a), self._prepared(b))
        return self._flow[(a, b)]
