"""The port imports without jax and without the JAX package, and its kernel
wrappers take the plain path on CPU tensors."""

import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib, pkgutil, sys
BLOCKED = ("jax", "hackathonopticalflow_tpu")
def blocked_mods():
    return {k for k, v in sys.modules.items() if v is not None and k.split(".")[0] in BLOCKED}
before = blocked_mods()
for name in BLOCKED:
    sys.modules[name] = None  # any import of it now raises ImportError
import torch
import hackathonopticalflow_tpu_torch as pkg
names = set()
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
    names.add(m.name[len(pkg.__name__) + 1:])
assert {"ops.farneback", "ops.warp_bilinear", "ops.warp", "flow.dense", "ops.features",
        "ops.patch_bilinear", "flow.tracker", "ops.gather_rects", "apps.pathfinder", "nav.danger",
        "ops.color", "io.prefetch", "io.native_lib", "viz.layers", "utils.checkpoint"} <= names, names
from hackathonopticalflow_tpu_torch.core import FeatureParams, TrackerParams
from hackathonopticalflow_tpu_torch.ops.lk_level import lk_level, lk_level_reference
from hackathonopticalflow_tpu_torch.ops.gather_rects import gather_rects, gather_rects_reference
from hackathonopticalflow_tpu_torch.ops.patch_bilinear import patch_bilinear, patch_bilinear_reference
from hackathonopticalflow_tpu_torch.ops.warp_bilinear import warp_bilinear, warp_bilinear_reference
from hackathonopticalflow_tpu_torch.flow.dense import farneback_flow_video
from hackathonopticalflow_tpu_torch.flow.tracker import track_video

g = torch.Generator().manual_seed(0)
n, win, m = 3, 5, 2
tmpl = torch.floor(torch.rand((n, 3, win, win), generator=g) * 32 * 50) / 32
plane = torch.floor(torch.rand((30, 30), generator=g) * 255)
kw = dict(m=m, win_w=win, win_h=win, level_w=20, level_h=20, max_iters=4,
          eps2=9e-4, is_level0=True, min_eig_threshold=1e-4)
tl0 = torch.full((n, 2), 7.25)
org = torch.floor(tl0).to(torch.int32) - m
st = torch.ones(n, dtype=torch.bool)
out = lk_level(tmpl, plane, 5, tl0, org, st, **kw)
ref = lk_level_reference(tmpl, plane, 5, tl0, org, st, **kw)
assert lk_level.launches == 0
assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])

src = torch.rand((5, 6, 7), generator=g)
fx = torch.rand((6, 7), generator=g) * 9 - 1
fy = torch.rand((6, 7), generator=g) * 8 - 1
assert torch.equal(warp_bilinear(src, fx, fy), warp_bilinear_reference(src, fx, fy))
flows = farneback_flow_video(
    torch.floor(torch.rand((3, 32, 48), generator=g) * 255).to(torch.uint8), device="cpu"
)
assert warp_bilinear.launches == 0
assert flows.shape == (2, 32, 48, 2) and bool(torch.isfinite(flows).all())

planes = torch.rand((3, 20, 24), generator=g)
tl = torch.rand((4, 2), generator=g) * 10
assert torch.equal(patch_bilinear(planes, tl, 5, 5, True), patch_bilinear_reference(planes, tl, 5, 5, True))
org = torch.tensor([[3, -2], [30, 4]], dtype=torch.int32)
assert torch.equal(gather_rects(planes, org, 6, 7), gather_rects_reference(planes, org, 6, 7))
assert gather_rects.launches == 0
params = TrackerParams(max_tracks=16, features=FeatureParams(max_corners=8, max_candidates=64))
state, (heads, alive, length) = track_video(
    torch.floor(torch.rand((3, 48, 64), generator=g) * 255).to(torch.uint8), params, device="cpu"
)
assert patch_bilinear.launches == 0 and lk_level.launches == 0
assert heads.shape == (2, 16, 2) and state.frame_idx == 2

from chip_smoke import ClipReader
from hackathonopticalflow_tpu_torch.apps.pathfinder import PathfinderApp, PathfinderConfig
from hackathonopticalflow_tpu_torch.core import LKParams
gray = torch.floor(torch.rand((5, 64, 96), generator=g) * 255).to(torch.uint8).numpy()
app = PathfinderApp(PathfinderConfig(video="clip", max_frames=4, lk=LKParams(grid_step=30, compute_err=False),
                                     device="cpu"), open_reader=lambda path: ClipReader(gray))
batched = app.run_batched(chunk=3)
assert app.run(render=False)["danger_counts"] == batched["danger_counts"] and batched["frames"] == 4
assert lk_level.launches == 0
assert blocked_mods() <= before
print("OK")
"""


def test_port_imports_without_jax():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")
