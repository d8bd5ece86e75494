"""The least times of the tracker's two kernels over a window's steps,
for the roofline readers (metrics/lk_level_tracker.roofline.py,
metrics/patch_bilinear.roofline.py).

A tracker step launches `lk_level` six times (three levels forward, then
three backward) and `patch_bilinear` eight times (a level's templates,
image and two derivatives, in each direction, and the level-0 err
windows in each), every launch over all max_tracks slots, dead ones
included. The readers take the mean least time of a launch over the
window's steps times the launches the trace holds."""

from __future__ import annotations

from .roofline import bound_s, lk_level_work
from .tracker_check import alive_before


def _level_planes(cfg: dict) -> list[int]:
    """Elements of one padded plane of each pyramid level, finest first
    (the port's frame pad for the init-centred crops, ops/lk.py::
    _frame_pad)."""
    from ..reference.tracker import _pad

    lk = cfg["lk"]
    win_w, win_h = lk["win_size"]
    pad = _pad(win_w, win_h, lk["slab_margin"])
    out = []
    for level in range(lk["max_level"] + 1):
        h = -(-cfg["height"] // (1 << level))
        w = -(-cfg["width"] // (1 << level))
        out.append((h + 2 * pad) * (w + 2 * pad))
    return out


def patch_work(n: int, c: int, win_h: int, win_w: int, plane_numel: int, quantize: bool) -> tuple[float, float]:
    """(bytes, float32 ops) of one patch_bilinear launch: each point's
    (win_h+1) x (win_w+1) crop of c planes read once (at most the planes),
    its top-left read and its windows written; 7 ops per output value (the
    blend), 4 more for the 1/32 rounding, 12 per point (origin, fraction,
    weights)."""
    out = n * c * win_h * win_w
    n_bytes = min(c * plane_numel, n * c * (win_h + 1) * (win_w + 1)) * 4 + n * 8 + out * 4
    return n_bytes, out * (11 if quantize else 7) + 12 * n


def patch_bound_per_launch_s(cfg: dict) -> float:
    """The mean least seconds of a step's eight patch_bilinear launches;
    their work does not depend on the data."""
    lk = cfg["lk"]
    win_w, win_h = lk["win_size"]
    n = cfg["tracker"]["max_tracks"]
    planes = _level_planes(cfg)
    total = 2 * sum(bound_s(*patch_work(n, 3, win_h, win_w, p, True)) for p in planes)
    total += 2 * bound_s(*patch_work(n, 1, win_h, win_w, planes[0], False))
    return total / (2 * len(planes) + 2)


def lk_level_bound_per_launch_s(r) -> float | None:
    """The mean least seconds of an lk_level launch over the window's
    steps. Each launch covers every slot; its crops and iterations are
    counted from the reference's replay where the check replayed the step
    (the points past the spectral gate and the point-iterations that
    sampled a window), else as a floor: the slots alive before the step,
    one iteration each."""
    win, cfg = r.win, r.ctx.cfg
    if not win.data["chunks"]:
        return None
    lk = cfg["lk"]
    win_w, win_h = lk["win_size"]
    n = cfg["tracker"]["max_tracks"]
    planes = _level_planes(cfg)[::-1]  # top level first, as the launches run
    ref_stats = win.data.get("ref_stats", {})
    chunk = len(win.data["chunks"][0].alive)
    total, launches = 0.0, 0
    for k, alive in enumerate(alive_before(win)):
        stats = ref_stats.get((k // chunk, k % chunk))
        live = int(alive.sum())
        for i in range(2 * len(planes)):
            good, iters = (stats[i]["good"], stats[i]["iterations"]) if stats else (live, live)
            total += bound_s(*lk_level_work(n, win_w, win_h, lk["slab_margin"], planes[i % len(planes)], good, iters))
            launches += 1
    return total / launches
