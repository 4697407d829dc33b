"""Device histogram == host numpy histogram.

The bincount is one XLA scatter-add (ops.histogram.fixed_bincount).
Unweighted counts are integers below 2**24 per bin, so they must equal
the host result exactly whatever order the adds land in; weighted sums
agree to f32 rounding.  The host side is PdfStack's own reference
(_host_histogram), run per segment.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sxmc_jax.ops import histogram as hist_ops
from sxmc_jax.pdf.stack import _host_histogram

# Per-axis bin counts whose product is the listed total.
AXES = {
    1: {1: (1,), 7: (7,), 128: (128,), 1000: (1000,)},
    2: {1: (1, 1), 7: (7, 1), 128: (16, 8), 1000: (40, 25)},
    3: {1: (1, 1, 1), 7: (1, 7, 1), 128: (8, 4, 4), 1000: (10, 10, 10)},
}


def _samples(rng, n, lower, upper):
    """Samples that overflow the domain on both sides of every axis."""
    cols = []
    for lo, up in zip(lower, upper):
        span = up - lo
        cols.append(rng.uniform(lo - 0.2 * span, up + 0.2 * span, n))
    return np.stack(cols, axis=1).astype(np.float32)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("nseg", [1, 29])
@pytest.mark.parametrize("total", [1, 7, 128, 1000])
@pytest.mark.parametrize("nobs", [1, 2, 3])
def test_segmented_matches_host(nobs, total, nseg, weighted):
    rng = np.random.default_rng(100 * nobs + total + nseg)
    nbins = AXES[nobs][total]
    lower = tuple(float(x) for x in rng.uniform(-3, 0, nobs))
    upper = tuple(lo + float(rng.uniform(1, 5)) for lo in lower)
    # Ragged segments, some empty-ish.
    sizes = rng.integers(1, 400, nseg)
    seg = np.repeat(np.arange(nseg, dtype=np.int32), sizes)
    samples = _samples(rng, int(sizes.sum()), lower, upper)
    w = (rng.uniform(0.5, 1.5, samples.shape[0]).astype(np.float32)
         if weighted else None)

    hists, norms = hist_ops.segmented_histogram(
        jnp.asarray(samples), jnp.asarray(seg),
        jnp.ones(samples.shape[0], bool), jnp.asarray(lower, jnp.float32),
        jnp.asarray(upper, jnp.float32), nbins, nseg,
        weights=None if w is None else jnp.asarray(w))
    hists = np.asarray(hists)
    assert hists.shape == (nseg, total)
    for j in range(nseg):
        sel = seg == j
        want = _host_histogram(samples[sel], lower, upper, nbins,
                               weights=None if w is None else w[sel])
        if weighted:
            np.testing.assert_allclose(hists[j], want, rtol=1e-6,
                                       atol=1e-5)
        else:
            np.testing.assert_array_equal(hists[j], want)
    np.testing.assert_allclose(np.asarray(norms), hists.sum(axis=1),
                               rtol=1e-6)


def test_out_of_domain_samples_are_dropped():
    """[lower, upper) per axis: the lower edge is in, the upper edge and
    anything outside any axis is out — in no bin and not in the norm."""
    lower, upper, nbins = (0.0, 0.0), (1.0, 2.0), (4, 2)
    pts = np.asarray([
        [0.0, 0.0],     # lower corner: in, bin 0
        [1.0, 0.5],     # upper edge of axis 0: out
        [0.5, 2.0],     # upper edge of axis 1: out
        [-1e-7, 1.0],   # just below axis 0: out
        [0.99, 1.99],   # last bin
        [np.nan, 0.5],  # NaN: out
    ], np.float32)
    hists, norms = hist_ops.segmented_histogram(
        jnp.asarray(pts), jnp.zeros(len(pts), jnp.int32),
        jnp.ones(len(pts), bool), jnp.asarray(lower), jnp.asarray(upper),
        nbins, 1)
    want = np.zeros(8, np.float32)
    want[0] = 1.0
    want[7] = 1.0
    np.testing.assert_array_equal(np.asarray(hists)[0], want)
    assert float(norms[0]) == 2.0
    np.testing.assert_array_equal(
        np.asarray(hists)[0], _host_histogram(pts, lower, upper, nbins))


def test_fixed_bincount_is_a_scatter_add():
    ids = jnp.asarray([0, 2, 2, 5, 2], jnp.int32)
    w = jnp.asarray([1.0, 0.5, 0.25, 2.0, 1.0], jnp.float32)
    np.testing.assert_array_equal(
        np.asarray(hist_ops.fixed_bincount(ids, w, 6)),
        np.asarray([1.0, 0.0, 1.75, 0.0, 0.0, 2.0], np.float32))
