"""The port's captured steps (utils/graphs.py) on the CPU.

On the GPU each step below runs as a replayed CUDA graph, which refuses a
host sync and a tensor built from host data. Here, where `graphed` calls
its function itself, the steps are audited under a TorchDispatchMode at
144x256 on seeded numpy frames: after one warm-up call (which fills the
per-device index caches), a step calls no `_local_scalar_dense`,
`nonzero`, `masked_select`, `unique*` (nor an index with a boolean mask,
which is a nonzero) and reads no tensor that no op made, apart from its
arguments, what the warm-up made and 0-d fill values. The restructured
loops (the carried pyramid copied through the step's outputs, the
tracker's two steps keyed by detection) equal the loops written out with
the eager pieces, exactly. The GPU side (replay equal to `__wrapped__`,
one graph per shape, a capture failure raising) is in
tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from hackathonopticalflow_tpu_torch.flow import dense as tdense
from hackathonopticalflow_tpu_torch.flow import lk_grid as tgrid
from hackathonopticalflow_tpu_torch.flow import tracker as ttr
from hackathonopticalflow_tpu_torch.ops import lk as tlk
from hackathonopticalflow_tpu_torch.utils import graphs
from torch_graph_steps import SPARSE, STEPS, TRACKER, FarnebackParams, batch_step, frames, grid, tfb, tracker_state

torch.set_num_threads(1)

SYNC_OPS = {"_local_scalar_dense", "nonzero", "masked_select", "is_nonzero", "equal", "repeat_interleave"}
# advanced indexing, whose boolean index is a nonzero
INDEX_OPS = {"index", "index_put", "index_put_", "_index_put_impl_"}
# ops that copy a tensor's values into another: a host scalar there (x[i] =
# 1) is a host-to-device copy on the GPU, where fill_ and arithmetic take it
# as a kernel argument
COPY_OPS = INDEX_OPS | {"copy_", "_to_copy", "index_copy", "index_copy_", "scatter", "scatter_"}


class Audit(TorchDispatchMode):
    """Records a call's host syncs and the tensors it reads that no op
    made: a tensor is known once an op made it or read it while not
    recording (the arguments, the warm-up's caches), and every op's
    outputs are kept, so no storage address is reused. A Python scalar
    lifted to a tensor (lift_fresh) counts as host data where a COPY_OPS
    op reads it."""

    def __init__(self):
        super().__init__()
        self.recording = False
        self.known: set = set()
        self.lifted: set = set()
        self.kept: list = []
        self.syncs: list = []
        self.host: list = []

    def learn(self, tree) -> None:
        for x in pytree.tree_leaves(tree):
            if isinstance(x, torch.Tensor):
                self.known.add(x.untyped_storage().data_ptr())
                self.kept.append(x)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name.split("::")[-1]
        if self.recording:
            if name in SYNC_OPS or name.startswith("unique") or name.startswith("_unique"):
                self.syncs.append(name)
            if name in INDEX_OPS and any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1]):
                self.syncs.append(f"{name} (boolean mask)")
            for x in pytree.tree_leaves((args, kwargs)):
                if not isinstance(x, torch.Tensor):
                    continue
                ptr = x.untyped_storage().data_ptr()
                if (x.dim() > 0 and ptr not in self.known) or (name in COPY_OPS and ptr in self.lifted):
                    self.host.append((name, tuple(x.shape)))
                    self.learn(x)
        else:
            self.learn((args, kwargs))
        out = func(*args, **kwargs)
        if name == "lift_fresh":
            self.lifted.add(out.untyped_storage().data_ptr())
        self.learn(out)
        return out


def audit(fn, *args) -> Audit:
    """fn(*args) once to warm up, then once recorded."""
    a = Audit()
    with a:
        a.learn(args)
        fn(*args)
        a.recording = True
        fn(*args)
    return a


def test_audit_sees_syncs_and_host_tensors():
    """The harness itself: an item(), a boolean mask, a scalar written at
    an index tensor and a tensor made from a numpy array in the recorded
    call are all seen; a scalar filled into a slice and one in where() are
    not."""
    x = torch.arange(6.0)

    def fn(x):
        y = x[x > 2.0].sum() + float(x.max())
        z = x.clone()
        z[torch.arange(2)] = 1.0
        z[2:4] = 5.0
        return y + torch.from_numpy(np.ones(6, np.float32)) + torch.where(x > 1.0, z, 0.0)

    a = audit(fn, x)
    assert "_local_scalar_dense" in a.syncs
    assert any("boolean mask" in s or s == "nonzero" for s in a.syncs)
    assert [shape for _, shape in a.host] == [(), (6,)]


@pytest.mark.parametrize("step", list(STEPS))
def test_step_is_capture_ready(step):
    """After a warm-up call the step reads nothing on the host and builds
    no tensor from host data: what a CUDA graph capture requires."""
    fn, args = STEPS[step]("cpu")
    fn = fn.__wrapped__
    a = audit(fn, *args)
    assert a.syncs == [], a.syncs
    assert a.host == [], a.host


def test_sparse_scan_equals_eager_loop():
    """lk_grid_flow_video (the step's pyramid carried through its outputs)
    equals the loop written out with prepare_frame and
    lk_grid_flow_prepared."""
    f = torch.from_numpy(frames(4))
    pts = grid("cpu")
    got = tgrid.lk_grid_flow_video(f, pts, SPARSE, device="cpu")
    prev = tlk.prepare_frame(f[0], SPARSE)
    for t in range(1, f.shape[0]):
        cur = tlk.prepare_frame(f[t], SPARSE)
        want = tgrid.lk_grid_flow_prepared(prev, cur, pts, SPARSE)
        for name, g in got._asdict().items():
            assert torch.equal(g[t - 1], getattr(want, name)), name
        prev = cur


@pytest.mark.parametrize("mode", tfb.COEF_MODES)
def test_dense_scan_equals_eager_loop(mode):
    params = FarnebackParams(warp_mode=mode)
    f = torch.from_numpy(frames(3, dx=1))
    got = tdense.farneback_flow_video(f, params, device="cpu")
    prev = tfb.prepare_frame(f[0], params)
    for t in range(1, f.shape[0]):
        cur = tfb.prepare_frame(f[t], params)
        assert torch.equal(got[t - 1], tfb.farneback_prepared(prev, cur, params))
        prev = cur


def _eager_track_step(state, prev_prep, cur_prep, gray, params):
    """The tracker's step as one function with the detection branch on
    frame_idx, as it was written before the two captured steps."""
    heads = ttr._heads(state)
    p1 = tlk.pyr_lk_prepared(prev_prep, cur_prep, heads, params.lk).next_pts
    p0r = tlk.pyr_lk_prepared(cur_prep, prev_prep, p1, params.lk).next_pts
    keep = state.alive & ((heads - p0r).abs().amax(dim=-1) < params.fb_max_dist)
    state = ttr._append(state, p1, keep)
    if state.frame_idx % params.detect_interval == 0:
        mask = ttr._detect_mask(ttr._heads(state), state.alive, *gray.shape)
        state = ttr._spawn(state, ttr.good_features_to_track(gray, params.features, mask=mask))
    return state._replace(frame_idx=state.frame_idx + 1)


@pytest.mark.parametrize("interval", [2, 5])
def test_track_video_equals_eager_loop(interval):
    """track_video (track_frame: a detect and a no-detect step keyed by
    frame_idx) equals the eager loop over 7 frames, seeding included,
    state and history."""
    params = dataclasses.replace(TRACKER, detect_interval=interval)
    f = torch.from_numpy(frames(7))
    got, (heads, alive, length) = ttr.track_video(f, params, device="cpu")
    s = ttr.init_tracker(params, device="cpu")
    prev = tlk.prepare_frame(f[0].float(), params.lk)
    for t in range(1, f.shape[0]):
        cur = tlk.prepare_frame(f[t].float(), params.lk)
        s = _eager_track_step(s, prev, cur, f[t].float(), params)
        assert torch.equal(ttr._heads(s), heads[t - 1])
        assert torch.equal(s.alive, alive[t - 1]) and torch.equal(s.length, length[t - 1])
        prev = cur
    for name in ("traj", "length", "alive"):
        assert torch.equal(getattr(got, name), getattr(s, name)), name
    assert got.frame_idx == s.frame_idx == 6
    assert int(s.alive.sum()) > 0


@pytest.mark.parametrize("frame_idx", [0, 1])
def test_track_step_prepared_equals_eager_step(frame_idx):
    s, prev, frame = tracker_state("cpu")
    s = s._replace(frame_idx=frame_idx)
    cur = tlk.prepare_frame(frame.float(), TRACKER.lk)
    got = ttr.track_step_prepared(s, prev, cur, frame.float(), TRACKER)
    want = _eager_track_step(s, prev, cur, frame.float(), TRACKER)
    for name in ("traj", "length", "alive"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert got.frame_idx == want.frame_idx == frame_idx + 1


def test_batch_step_equals_eager():
    """The batch runner's step: each stream's result packed (its `good`
    count among them) and the frames' image levels, as prepare_frame and
    lk_grid_flow_prepared on the whole pyramids give them."""
    fn, args = batch_step("cpu")
    packed, cur = fn(*args)
    cur_frames, pts = args[1:3]
    prev = tlk.prepare_frame(torch.from_numpy(np.stack([frames(2, seed=s)[0] for s in (0, 1)])), SPARSE)
    want_prep = tlk.prepare_frame(cur_frames, SPARSE)
    want = tgrid.lk_grid_flow_prepared(prev, want_prep, pts, SPARSE)
    assert torch.equal(packed, tgrid.pack_grid_result(want))
    good = tgrid.unpack_grid_result(packed.numpy(), np.trunc(pts.numpy() + 0.5).astype(np.int32)).good
    assert good.shape == (2, pts.shape[0]) and np.array_equal(good.sum(-1), want.good.sum(-1).numpy())
    assert int(good.sum(-1).min()) > 0
    assert len(cur) == len(want_prep.img_p) and all(torch.equal(g, w) for g, w in zip(cur, want_prep.img_p))


def test_graphed_on_cpu_calls_the_function():
    """On the CPU a graphed function is its function: same result object,
    no graph, nothing counted; __wrapped__ is the function."""
    calls = []

    def fn(x, k):
        calls.append(k)
        return x * k

    g = graphs.graphed(fn)
    x = torch.arange(4.0)
    assert g.__wrapped__ is fn and g.__name__ == "fn"
    graphs.reset_stats()
    assert torch.equal(g(x, 3), x * 3) and calls == [3]
    assert g._entries == {} and graphs.launch_stats() == {"captured": {}, "replayed": {}}
    graphs.clear_caches()


def test_reset_stats_zeroes_the_kernel_wrappers_counts():
    """reset_stats() zeroes the five kernel wrappers' `launches` counters
    with the graphs' counts, as chip_smoke.py's counted runs need."""
    wrappers = graphs._kernel_wrappers()
    saved = [w.launches for w in wrappers]
    try:
        for i, w in enumerate(wrappers):
            w.launches = i + 3
        graphs._captured.update({"lk_level": 2})
        graphs._replayed.update({"warp_bilinear": 5})
        graphs.reset_stats()
        assert [w.launches for w in wrappers] == [0, 0, 0, 0, 0]
        assert [w.__name__ for w in wrappers] == list(graphs.KERNELS)
        assert graphs.launch_stats() == {"captured": {}, "replayed": {}}
    finally:
        for w, n in zip(wrappers, saved):
            w.launches = n
