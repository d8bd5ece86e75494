"""The port's CUDA kernels against their plain versions on the GPU.

These tests need a CUDA GPU and nvcc; elsewhere they skip. The file
imports no jax, so on a machine without jax it runs without the suite's
conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from hackathonopticalflow_tpu_torch.core import LKParams, measurement_grid
from hackathonopticalflow_tpu_torch.ops import lk as tlk
from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level, lk_level_reference

PARAMS = LKParams(grid_step=30, compute_err=False)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _pair(h=270, w=480, dx=5, dy=3):
    """u8 frames a, b of a smoothed noise texture, b(x, y) = a(x+dx, y+dy)."""
    sm = np.random.RandomState(7).uniform(0, 255, (h + 100, w + 100))
    for _ in range(4):
        p = np.pad(sm, 1, mode="reflect")
        sm = 0.25 * p[:-2, 1:-1] + 0.5 * p[1:-1, 1:-1] + 0.25 * p[2:, 1:-1]
        sm = 0.25 * sm[:, :-2] + 0.5 * sm[:, 1:-1] + 0.25 * sm[:, 2:]
    sm = np.clip(np.floor(sm + 0.5), 0, 255).astype(np.uint8)
    return sm[50 : 50 + h, 50 : 50 + w], sm[50 + dy : 50 + dy + h, 50 + dx : 50 + dx + w]


@pytest.mark.cuda
@pytest.mark.parametrize("level", [2, 1, 0])
def test_lk_level_kernel_matches_plain(cuda_device, level):
    """Status and top-lefts identical: both sum exactly in float64 and
    blend without FMA contraction, so any difference is a fault."""
    a, b = _pair()
    pts = measurement_grid(*a.shape, PARAMS.grid_step)
    grid_xy = (np.unique(pts[:, 0]).astype(int), np.unique(pts[:, 1]).astype(int))
    prev = tlk.prepare_frame(torch.from_numpy(a).to(cuda_device), PARAMS)
    nxt = tlk.prepare_frame(torch.from_numpy(b).to(cuda_device), PARAMS)
    center = torch.from_numpy(pts).to(cuda_device) * float(2.0 ** (level - PARAMS.max_level))
    args, statics = tlk.level_inputs(prev, nxt, grid_xy, center, level, PARAMS)
    status = torch.ones(pts.shape[0], dtype=torch.bool, device=cuda_device)
    before = lk_level.launches
    tl_k, st_k = lk_level(*args, status, **statics)
    torch.cuda.synchronize()
    assert lk_level.launches == before + 1
    tl_p, st_p = lk_level_reference(*args, status, **statics)
    assert torch.equal(st_k, st_p)
    assert torch.equal(tl_k, tl_p)
