"""The port's danger values, masked statistics and masked robust filter
against the JAX package's, on seeded inputs: identical booleans, values to
1e-6 relative (the same float32 rank arithmetic; infinities and the nan of
an empty percentile included)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hackathonopticalflow_tpu.core.config import PROTO_FILTER as J_PROTO_FILTER
from hackathonopticalflow_tpu.core.config import FilterParams as JFilterParams
from hackathonopticalflow_tpu.nav import danger as jdanger
from hackathonopticalflow_tpu.nav import filter as jfilter
from hackathonopticalflow_tpu.ops import stats as jstats
from hackathonopticalflow_tpu_torch.core import PROTO_FILTER, FilterParams
from hackathonopticalflow_tpu_torch.nav import danger as tdanger
from hackathonopticalflow_tpu_torch.nav import filter as tfilter
from hackathonopticalflow_tpu_torch.ops import stats as tstats

torch.set_num_threads(1)

N = 2304  # the 1080p grid's points


def _modulus(seed, n=N):
    """Normalized flow magnitudes: mostly small, a heavy tail, ties."""
    rng = np.random.RandomState(seed)
    m = np.abs(rng.standard_cauchy(n)).astype(np.float32) * 3.0
    m[: n // 50] = m[n // 2]
    return m


def _mask(kind, seed, n=N):
    """All false, all true, or a random mask with an odd or even count."""
    rng = np.random.RandomState(seed + 100)
    if kind == "none":
        return np.zeros(n, bool)
    if kind == "all":
        return np.ones(n, bool)
    m = rng.rand(n) < 0.6
    want_odd = kind == "odd"
    if (m.sum() % 2 == 1) != want_odd:
        m[np.flatnonzero(~m)[0]] = True
    assert (m.sum() % 2 == 1) == want_odd
    return m


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, equal_nan=True)


@pytest.mark.parametrize("kind", ["odd", "even", "none", "all"])
@pytest.mark.parametrize("seed", [0, 1])
def test_masked_median_matches_jax(kind, seed):
    x, m = _modulus(seed), _mask(kind, seed)
    _close(tstats.masked_median(torch.from_numpy(x), torch.from_numpy(m)),
           jstats.masked_median(jnp.asarray(x), jnp.asarray(m)))


@pytest.mark.parametrize("q", [99.0, 50.0, 0.0, 100.0])
@pytest.mark.parametrize("kind", ["odd", "even", "none", "all"])
def test_masked_percentile_matches_jax(kind, q):
    x, m = _modulus(2), _mask(kind, 2)
    got = tstats.masked_percentile(torch.from_numpy(x), torch.from_numpy(m), q)
    want = jstats.masked_percentile(jnp.asarray(x), jnp.asarray(m), q)
    _close(got, want)
    if kind != "none":
        np.testing.assert_allclose(got.numpy(), np.percentile(x[m], q), rtol=1e-6)


@pytest.mark.parametrize("filt", ["viewer", "proto"])
@pytest.mark.parametrize("kind", ["odd", "even", "none", "all"])
def test_robust_mask_masked_matches_jax(kind, filt):
    x, m = _modulus(3), _mask(kind, 3)
    tp, jp = (FilterParams(), JFilterParams()) if filt == "viewer" else (PROTO_FILTER, J_PROTO_FILTER)
    got = tfilter.robust_mask_masked(torch.from_numpy(x), torch.from_numpy(m), tp).numpy()
    want = np.asarray(jfilter.robust_mask_masked(jnp.asarray(x), jnp.asarray(m), jp))
    assert np.array_equal(got, want)
    if kind == "all":
        assert np.array_equal(got, tfilter.robust_mask(torch.from_numpy(x), tp).numpy())
    if kind != "none":
        assert got.any()


def test_danger_values_match_jax():
    x = np.concatenate([_modulus(4), [0.0, 102.5, 103.0, 1e9]]).astype(np.float32)
    got = tdanger.danger_values(torch.from_numpy(x))
    want = np.asarray(jdanger.danger_values(jnp.asarray(x)))
    _close(got, want)
    assert float(got.max()) == 255.0


def test_danger_image_matches_jax():
    """Points off the frame clip to its edge; where points share a pixel
    the largest good value wins; bad points add nothing."""
    rng = np.random.RandomState(5)
    h, w = 40, 64
    pts = np.stack([rng.randint(-10, w + 10, 300), rng.randint(-10, h + 10, 300)], -1).astype(np.int32)
    pts[:20] = pts[20]
    vals = np.array(jdanger.danger_values(jnp.asarray(_modulus(6, 300))))
    good = rng.rand(300) < 0.7
    got = tdanger.danger_image(torch.from_numpy(pts), torch.from_numpy(vals), torch.from_numpy(good), h, w)
    want = np.asarray(jdanger.danger_image(jnp.asarray(pts), jnp.asarray(vals), jnp.asarray(good), h, w))
    assert got.shape == (h, w) and got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)
