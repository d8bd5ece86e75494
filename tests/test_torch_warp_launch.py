"""The warp_bilinear kernel's launch shapes, without a card.

`launch_shapes` lists every launch csrc/warp_bilinear.cu takes for a call
and `launch_shape` picks one of them from the call's shape; the kernel
maps a block and a thread to the pixels and channels it writes as
`_written` below does. These tests hold every launch to cover every
output exactly once, and each slab block to write inside one (8, 128)
tile whose minima it reads whole, and the pick to fill the card's SMs at
the coarsest level. The kernel itself runs only on the GPU
(tests/test_torch_cuda.py holds every launch to the plain version).
"""

import numpy as np
import pytest

from hackathonopticalflow_tpu_torch.ops.warp_bilinear import (
    ALL_CHANNELS,
    SMS,
    TH,
    THREADS,
    TW,
    blocks_per_plane,
    launch_shape,
    launch_shapes,
)

# (b, c, h, w): the 720p dense path's four level sizes, the ragged shape,
# a stream axis of 4, and the other channel counts the wrapper takes
SHAPES = [(1, 5, 90, 160), (1, 5, 180, 320), (1, 5, 360, 640), (1, 5, 720, 1280), (1, 5, 20, 200),
          (4, 5, 90, 160), (1, 1, 20, 200), (1, 3, 90, 160)]
IDS = ["x".join(map(str, s)) for s in SHAPES]
GEOMETRIES = ["gather", "slab"]
LAUNCHES = [(bchw, geometry, shape) for bchw in SHAPES for geometry in GEOMETRIES
            for shape in launch_shapes(*bchw, geometry)]
LAUNCH_IDS = ["x".join(map(str, bchw)) + f"-{geometry}-g{shape.groups}s{shape.splits}"
              for bchw, geometry, shape in LAUNCHES]


def _written(b, c, h, w, geometry, shape):
    """Per (block, thread, pixel of the thread, channel of the block): the
    output element's flat index in (b, c, h, w) and whether it lies in the
    image (the kernel stores only those); in the slab geometry also each
    block's tile (b, row, column) and the tile pixels (row * 128 + column)
    each of its threads reads for the minima. The kernel's index
    arithmetic (csrc/warp_bilinear.cu): gather, a thread a pixel; slab,
    `splits` blocks a tile, block `part` its rows part * R + warp (R = 8 /
    splits), lane l its columns l, l + 32, l + 64, l + 96, and warp w
    reading rows q * R + w for the minima."""
    grid, groups, splits = shape
    cpb = ALL_CHANNELS if groups == 1 and c == ALL_CHANNELS else 1
    pixels = 1 if geometry == "gather" else TH * TW // THREADS
    bid = np.arange(grid, dtype=np.int64)[:, None, None, None]
    t = np.arange(THREADS // splits, dtype=np.int64)[None, :, None, None]
    i = np.arange(pixels, dtype=np.int64)[None, None, :, None]
    j = np.arange(cpb, dtype=np.int64)[None, None, None, :]
    hw = h * w
    g, rest = bid % groups, bid // groups
    if geometry == "gather":
        per_plane = -(-hw // THREADS)
        p = (rest % per_plane) * THREADS + t + 0 * i
        idx = ((rest // per_plane) * c + g * cpb + j) * hw + p
        return idx, np.broadcast_to(p < hw, idx.shape), None
    part, rest = rest % splits, rest // splits
    ntx, nty = -(-w // TW), -(-h // TH)
    tx, ty, bb = rest % ntx, (rest // ntx) % nty, rest // (ntx * nty)
    rows = TH // splits
    warp, jl = t // 32, t % 32 + 32 * i
    il = part * rows + warp
    r, col = ty * TH + il, tx * TW + jl
    idx = (bb * c + g * cpb + j) * hw + r * w + col
    q = np.arange(splits, dtype=np.int64).reshape(1, 1, 1, 1, -1)
    read = (q * rows + warp[..., None]) * TW + jl[..., None]  # (1, threads, pixels, 1, splits)
    return idx, np.broadcast_to((r < h) & (col < w), idx.shape), ((bb, ty, tx), read)


@pytest.mark.parametrize("bchw,geometry,shape", LAUNCHES, ids=LAUNCH_IDS)
def test_launch_covers_every_output_once(bchw, geometry, shape):
    """Every launch the kernel takes stores every output pixel and channel
    exactly once."""
    b, c, h, w = bchw
    assert shape.grid == blocks_per_plane(h, w, geometry, shape.splits) * b * shape.groups
    idx, live, _ = _written(b, c, h, w, geometry, shape)
    counts = np.bincount(idx[live].ravel(), minlength=b * c * h * w)
    assert counts.shape == (b * c * h * w,)
    assert (counts == 1).all(), (int((counts == 0).sum()), int((counts > 1).sum()))


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("bchw", SHAPES, ids=IDS)
def test_launch_is_one_the_kernel_takes(bchw, geometry):
    """The chooser's launch is one of launch_shapes, and those differ."""
    shapes = launch_shapes(*bchw, geometry)
    assert launch_shape(*bchw, geometry) in shapes
    assert len(set(shapes)) == len(shapes)


@pytest.mark.parametrize("bchw,geometry,shape", [x for x in LAUNCHES if x[1] == "slab"],
                         ids=[i for i, x in zip(LAUNCH_IDS, LAUNCHES) if x[1] == "slab"])
def test_slab_block_stays_in_one_tile(bchw, geometry, shape):
    """Every slab block writes inside one (8, 128) tile of one plane, every
    tile holds a pixel of the image (a block of a split tile may lie past
    it), and each block's threads read each of the tile's 8 x 128 pixels
    once for the minima."""
    b, c, h, w = bchw
    idx, live, ((bb, ty, tx), read) = _written(b, c, h, w, geometry, shape)
    idx, live = idx.reshape(shape.grid, -1), live.reshape(shape.grid, -1)
    pix = idx % (h * w)
    for got, want in ((idx // (h * w) // c, bb), (pix // w // TH, ty), (pix % w // TW, tx)):
        assert (got == want.reshape(-1, 1))[live].all()
    tile = ((bb * -(-h // TH) + ty) * -(-w // TW) + tx).ravel()
    assert (np.bincount(tile, weights=live.any(axis=1)) > 0).all()
    assert np.array_equal(np.sort(read.ravel()), np.arange(TH * TW))


# launch_shape's pick at the 720p dense path's levels: the fastest launch
# in chip_smoke.py's phases 6 and 18 on an H100 (PERF.md section 6)
PICKS = {("gather", 90): (285, 5, 1), ("gather", 180): (225, 1, 1), ("gather", 360): (900, 1, 1),
         ("gather", 720): (3600, 1, 1), ("slab", 90): (120, 5, 1), ("slab", 180): (345, 5, 1),
         ("slab", 360): (450, 1, 2), ("slab", 720): (900, 1, 1)}


@pytest.mark.parametrize("geometry,h", list(PICKS), ids=[f"{g}-{h}" for g, h in PICKS])
def test_launch_shape_at_the_dense_levels(geometry, h):
    """The pick at each (h, 16 h / 9) level of the 720p dense path."""
    assert launch_shape(1, 5, h, h * 16 // 9, geometry) == PICKS[geometry, h]


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_launch_fills_the_card_at_the_coarsest_level(geometry):
    """At 90x160, the 720p path's coarsest level, blocks of all five
    channels (57 pixel blocks, 24 tiles) would leave most of the H100's
    132 SMs idle, so a block blends one channel: 285 blocks in the gather
    geometry, more than one an SM; 120 in the slab one, a block per tile
    and channel. 132 or more slab blocks there split each tile into 2
    blocks, each re-reading the whole tile's fx and fy for its minima:
    that launch (240 blocks) is in launch_shapes and measured slower than
    120 (chip_smoke.py phase 18, PERF.md section 6). At 720x1280 every
    block blends all five channels."""
    all_five = blocks_per_plane(90, 160, geometry)
    shape = launch_shape(1, 5, 90, 160, geometry)
    assert all_five < SMS
    assert shape == (5 * all_five, 5, 1)
    if geometry == "gather":
        assert shape.grid >= SMS
    else:
        assert shape.grid == 120
        assert sorted(s.grid for s in launch_shapes(1, 5, 90, 160, geometry) if s.groups == 5) == [120, 240]
    assert launch_shape(1, 5, 720, 1280, geometry).groups == 1
