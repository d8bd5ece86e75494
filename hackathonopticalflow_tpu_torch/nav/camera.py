"""Pinhole camera model (port of hackathonopticalflow_tpu/nav/camera.py).

The reference carries a per-video horizontal viewing angle (155 deg for
the FPV clips, DenseOF.py:443-460) but no intrinsics matrix; the pose and
BA stages need one: a pinhole from the horizontal FOV.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Pinhole:
    fx: float
    fy: float
    cx: float
    cy: float

    @classmethod
    def from_fov(cls, width: int, height: int, h_fov_deg: float = 155.0) -> "Pinhole":
        f = (width / 2.0) / math.tan(math.radians(h_fov_deg) / 2.0)
        return cls(fx=f, fy=f, cx=width / 2.0, cy=height / 2.0)

    def normalize(self, pts: torch.Tensor | np.ndarray) -> torch.Tensor:
        """Pixel (..., 2) -> normalized camera coords (..., 2), a float32
        tensor on the input's device (an ndarray's is the CPU)."""
        p = torch.as_tensor(pts).to(torch.float32)
        x = (p[..., 0] - self.cx) / self.fx
        y = (p[..., 1] - self.cy) / self.fy
        return torch.stack([x, y], dim=-1)

    def sq_norm_thresh(self, px: float = 1.0) -> float:
        """Squared normalized-coordinate threshold equivalent to a pixel
        tolerance (cv2.findEssentialMat's `threshold`), for
        estimate_relative_pose's inlier_thresh."""
        return float((px / self.fx) ** 2)

    def project(self, xyz: torch.Tensor) -> torch.Tensor:
        """Camera-frame 3D (..., 3) -> pixel (..., 2)."""
        z = xyz[..., 2]
        x = xyz[..., 0] / z * self.fx + self.cx
        y = xyz[..., 1] / z * self.fy + self.cy
        return torch.stack([x, y], dim=-1)
