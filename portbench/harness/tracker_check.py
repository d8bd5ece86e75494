"""The tracker cell's parameters, the state snapshots of its kept chunks,
the check that replays them through the reference, and the counters the
result line's notes carry.

The tracker's state carries from step to step, so a wrong keep or spawn
decision changes every later step: a kept chunk is replayed from a clone
of the state the port started it from, and every one of its steps is
compared with the reference's, exactly."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..reference.tracker import State, TrackerReference
from .clip import loop_index


def tracker_params(cfg: dict):
    """The configuration's TrackerParams (its `tracker`, `lk` and
    `features` groups)."""
    from hackathonopticalflow_tpu_torch.core import FeatureParams, LKParams, TrackerParams

    lk = dict(cfg["lk"])
    lk["win_size"] = tuple(lk["win_size"])
    return TrackerParams(lk=LKParams(**lk), features=FeatureParams(**cfg["features"]), **cfg["tracker"])


def chunk_frames(gray: np.ndarray, pos: int, chunk: int) -> np.ndarray:
    """The chunk + 1 clip frames shown at playback positions pos ..
    pos + chunk."""
    return gray[[loop_index(pos + j, gray.shape[0]) for j in range(chunk + 1)]]


def snapshot(state) -> State:
    """A clone of a tracker state's tables on their device, and its frame
    index."""
    return State(state.traj.clone(), state.length.clone(), state.alive.clone(), int(state.frame_idx))


class Chunk(NamedTuple):
    """What the host fetched of one chunk: the playback position of its
    first frame and its history, one row a step."""

    pos: int
    alive: np.ndarray  # (chunk, T) bool
    length: np.ndarray  # (chunk, T) int32


def alive_before(win) -> list[np.ndarray]:
    """The (T,) alive mask that each step of the window started from, in
    order: the state the window began with, then each step's result."""
    rows = [win.data["start_alive"]]
    for c in win.data["chunks"]:
        rows.extend(c.alive)
    return rows[:-1]


def counters(win) -> dict:
    """Live tracks a step after it (min, median, max), births (slots
    seeded by a detection) and deaths at the forward-backward gate (slots
    alive before a step and not carried through it), over the window's
    steps."""
    chunks = win.data["chunks"]
    if not chunks:
        return {}
    alive = np.concatenate([c.alive for c in chunks])
    length = np.concatenate([c.length for c in chunks])
    before = np.stack(alive_before(win))
    live = alive.sum(axis=1)
    born = alive & (length == 1)
    died = before & ~(alive & (length >= 2))
    return {"live_tracks_min": int(live.min()), "live_tracks_median": float(np.median(live)),
            "live_tracks_max": int(live.max()), "births": int(born.sum()), "deaths": int(died.sum())}


def _replay(ref: TrackerReference, prepared: dict, gray: np.ndarray, pos: int, chunk: int, state: State,
            stats: list | None = None):
    """The reference's history of a chunk from `state`: (heads, alive,
    length) a step, on the host; `stats` receives each step's LK work."""
    n = gray.shape[0]

    def prep(k):
        i = loop_index(k, n)
        if i not in prepared:
            prepared[i] = ref.prepare(torch.from_numpy(gray[i]))
        return prepared[i]

    out = []
    for j in range(chunk):
        st = [] if stats is not None else None
        state = ref.step(state, prep(pos + j), prep(pos + j + 1), st)
        if stats is not None:
            stats.append(st)
        out.append((ref.heads(state).cpu().numpy(), state.alive.cpu().numpy(), state.length.cpu().numpy()))
    return out


def compare(ctx, win) -> tuple[dict, int]:
    """Each kept chunk replayed through the reference from its snapshot,
    step by step. bad_steps: the steps whose alive or length differs from
    the reference's, or whose live heads (the slots alive in either) do,
    and every step a kept chunk is missing; heads_max_px: the largest gap
    between the port's live heads and the reference's. With `control`,
    the reference in bf16 stands in for the port. The reference's LK work
    on each replayed step goes to win.data["ref_stats"][(chunk, step)]."""
    gray = ctx.streams[0].gray
    chunk = int(ctx.traffic["chunk"])
    ref = TrackerReference(ctx.cfg, ctx.device)
    ctl = TrackerReference(ctx.cfg, ctx.device, torch.bfloat16) if ctx.control else None
    prepared: dict = {}
    ctl_prepared: dict = {}
    chunks = win.data["chunks"]
    ref_stats = win.data.setdefault("ref_stats", {})
    bad, worst = 0, 0.0
    for ci, (snap, heads) in sorted(win.data["kept"].items()):
        c = chunks[ci]
        stats: list = []
        want = _replay(ref, prepared, gray, c.pos, chunk, snap, stats)
        ref_stats.update({(ci, j): st for j, st in enumerate(stats)})
        if ctl is not None:
            got = _replay(ctl, ctl_prepared, gray, c.pos, chunk, snap)
        else:
            got = list(zip(heads, c.alive, c.length))
        bad += abs(len(want) - len(got))
        if len(want) != len(got):
            worst = float("inf")
        for (gh, ga, gl), (wh, wa, wl) in zip(got, want):
            if gh.shape != wh.shape or ga.shape != wa.shape or gl.shape != wl.shape:
                bad, worst = bad + 1, float("inf")
                continue
            live = ga | wa
            d = np.abs(gh[live].astype(np.float64) - wh[live].astype(np.float64))
            gap = float(np.nan_to_num(d, nan=np.inf).max()) if d.size else 0.0
            worst = max(worst, gap)
            bad += int(gap > 0 or not np.array_equal(ga, wa) or not np.array_equal(gl, wl))
    return {"bad_steps": bad, "heads_max_px": worst}, bad
