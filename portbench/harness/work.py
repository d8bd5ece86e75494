"""The kernels' least times over a window's device steps, for the
roofline readers (metrics/*.roofline.py)."""

from __future__ import annotations

from .roofline import bound_s, lk_level_work, warp_work


def lk_level_bound_s(r) -> float:
    """Sum over the window's steps and their levels of one lk_level
    launch's least time: a step's launch covers all its pairs' points,
    each pair's live points and iterations read from the reference on
    that pair."""
    ctx = r.ctx
    lk = ctx.cfg["lk"]
    win_w, win_h = lk["win_size"]
    total = 0.0
    for step in r.win.steps:
        per_pair = [ctx.lk_pairs(stream).stats(a, b) for stream, a, b in step]
        ref = ctx.lk_pairs(step[0][0]).ref
        n_pts = ref.pts.shape[0]
        for li, level in enumerate(range(ref.max_level, -1, -1)):
            h = -(-ctx.cfg["height"] // (1 << level))
            w = -(-ctx.cfg["width"] // (1 << level))
            m = lk["iter_margin_top"] if level == ref.max_level else lk["rescue_margin"]
            good = sum(s[li]["good"] for s in per_pair)
            iters = sum(s[li]["iterations"] for s in per_pair)
            plane = len(step) * (h + 2 * ref.pad) * (w + 2 * ref.pad)
            total += bound_s(*lk_level_work(len(step) * n_pts, win_w, win_h, m, plane, good, iters))
    return total


def warp_bound_per_pair_s(cfg: dict) -> tuple[float, int]:
    """(least seconds of one pair's warp launches, launches a pair): the
    warp runs `iterations` times at each of the levels + 1 sizes."""
    fb = cfg["farneback"]
    mode = fb.get("warp_mode", "auto")
    geometry = "slab" if mode in ("pallas", "pallas_bf16") else "gather"
    src_bytes = 2 if mode == "pallas_bf16" else 4
    total, launches = 0.0, 0
    for k in range(fb["levels"], -1, -1):
        scale = fb["pyr_scale"] ** k
        hk, wk = int(round(cfg["height"] * scale)), int(round(cfg["width"] * scale))
        total += fb["iterations"] * bound_s(*warp_work(5, hk, wk, geometry, src_bytes))
        launches += fb["iterations"]
    return total, launches
