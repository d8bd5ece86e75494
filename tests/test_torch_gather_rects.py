"""PyTorch port vs the JAX package: integer-origin rect gathers
(ops/patch.py's extract_slabs_rect and extract_slabs, the plain version of
the `gather_rects` kernel; the JAX package's Pallas gather_rects in
interpret mode).

A gather copies: every case is held IDENTICAL (np.array_equal), origins
off the plane included, which XLA's dynamic_slice wraps (negative starts)
and clamps."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hackathonopticalflow_tpu.ops import carve_pallas as jcarve
from hackathonopticalflow_tpu.ops import patch as jpatch
from hackathonopticalflow_tpu_torch.ops import patch as tpatch
from hackathonopticalflow_tpu_torch.ops.gather_rects import gather_rects, gather_rects_reference

torch.set_num_threads(1)


def _plane(seed, shape):
    return np.floor(np.random.RandomState(seed).uniform(0, 255, shape)).astype(np.float32)


def _origins(seed, n, h, w, ry, rx, spill):
    """n [x, y] int32 origins, up to `spill` px beyond the plane's edges."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-spill, w - rx + spill + 1, n)
    y = rng.randint(-spill, h - ry + spill + 1, n)
    return np.stack([x, y], -1).astype(np.int32)


EDGE_ORIGINS = np.array(
    [[-1, 0], [0, -1], [-130, 5], [7, -90], [-500, -500], [300, 10], [10, 300], [1000, 1000], [0, 0]],
    np.int32,
)


@pytest.mark.parametrize("ry,rx", [(118, 128), (41, 34), (9, 9)])
@pytest.mark.parametrize("spill", [0, 60])
def test_extract_slabs_rect_matches_jax(ry, rx, spill):
    """(N, ry, rx) slabs equal JAX's vmap(dynamic_slice), in bounds and
    with origins up to 60 px off the plane."""
    h, w = 150, 260
    img = _plane(ry + rx, (h, w))
    tl = np.concatenate([_origins(spill + rx, 64, h, w, ry, rx, spill), EDGE_ORIGINS])
    want = np.asarray(jpatch.extract_slabs_rect(jnp.asarray(img), jnp.asarray(tl), ry, rx))
    got = tpatch.extract_slabs_rect(torch.from_numpy(img), torch.from_numpy(tl), ry, rx).numpy()
    assert got.shape == (tl.shape[0], ry, rx)
    assert np.array_equal(got, want)


def test_extract_slabs_matches_jax():
    h, w, size = 120, 90, 20
    img = _plane(1, (h, w))
    tl = np.concatenate([_origins(2, 32, h, w, size, size, 25), EDGE_ORIGINS])
    want = np.asarray(jpatch.extract_slabs(jnp.asarray(img), jnp.asarray(tl), size))
    got = tpatch.extract_slabs(torch.from_numpy(img), torch.from_numpy(tl), size).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("channels", [None, 3])
def test_gather_rects_matches_jax_pallas(channels):
    """The port's gather_rects vs the JAX package's Pallas gather_rects (in
    interpret mode) on in-bounds origins, the TPU kernel's contract, for a
    plane and a plane stack."""
    h, w, ry, rx = 96, 140, 17, 30
    shape = (h, w) if channels is None else (channels, h, w)
    img = _plane(5, shape)
    tl = _origins(6, 32, h, w, ry, rx, 0)
    want = np.asarray(jcarve.gather_rects(jnp.asarray(img), jnp.asarray(tl), ry=ry, rx=rx, block=32))
    got = gather_rects(torch.from_numpy(img), torch.from_numpy(tl), ry, rx).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def test_gather_rects_cpu_runs_plain_version():
    """On CPU tensors the wrapper IS the plain version and launches no
    kernel; a plane stack gathers each plane at the same origins."""
    img = torch.from_numpy(_plane(7, (2, 40, 50)))
    tl = torch.from_numpy(np.concatenate([_origins(8, 16, 40, 50, 6, 9, 12), EDGE_ORIGINS]))
    before = gather_rects.launches
    got = gather_rects(img, tl, 6, 9)
    assert gather_rects.launches == before
    assert torch.equal(got, gather_rects_reference(img, tl, 6, 9))
    for k in range(2):
        assert torch.equal(got[:, k], gather_rects(img[k].contiguous(), tl, 6, 9))


@pytest.mark.parametrize("bad", ["img_dtype", "img_1d", "tl_shape", "tl_dtype", "noncontig", "rect_too_big"])
def test_gather_rects_rejects_bad_inputs(bad):
    img = torch.zeros(30, 40)
    tl = torch.zeros(4, 2, dtype=torch.int32)
    ry = rx = 5
    if bad == "img_dtype":
        img = img.double()
    elif bad == "img_1d":
        img = img[0]
    elif bad == "tl_shape":
        tl = torch.zeros(4, 3, dtype=torch.int32)
    elif bad == "tl_dtype":
        tl = tl.long()
    elif bad == "noncontig":
        img = torch.zeros(30, 80)[:, ::2]
    else:
        ry = 31
    with pytest.raises((TypeError, ValueError)):
        gather_rects(img, tl, ry, rx)
