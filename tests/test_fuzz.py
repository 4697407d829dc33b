"""Property/fuzz tests: randomized fit geometries through the device ops.

The hand-written suites pin specific shapes; these sweep randomized
(nobs, bins, systematics, segment, weight) combinations and assert the
invariants that must hold for EVERY geometry:

  * device histogram == host numpy histogram, exactly;
  * every in-domain sample lands in exactly one bin (counts conserve);
  * the device LUT equals the host hist[rb]/(norm*binvol) with the
    -1/-2 sentinels, exactly;
  * the NLL is finite and its barrier fires iff a rate is negative.

Seeded RNG: failures are reproducible by case index.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sxmc_jax.ops import histogram as hist_ops
from sxmc_jax.ops import transforms
from sxmc_jax.ops.transforms import (CTSCALE, RESOLUTION_SCALE, SCALE,
                                     SHIFT, SystematicDesc)
from sxmc_jax.pdf.stack import _host_histogram

N_CASES = 12


def random_geometry(rng):
    nobs = int(rng.integers(1, 4))
    nbins = tuple(int(rng.integers(2, 14)) for _ in range(nobs))
    lower = tuple(float(rng.uniform(-5, 0)) for _ in range(nobs))
    upper = tuple(lo + float(rng.uniform(0.5, 8)) for lo in lower)
    # Optional truth field for resolution systematics.
    nfields = nobs + int(rng.integers(0, 2))
    n = int(rng.integers(200, 4000))
    cols = []
    for i in range(nobs):
        span = upper[i] - lower[i]
        # Deliberately overflow the domain on both sides.
        cols.append(rng.uniform(lower[i] - 0.3 * span,
                                upper[i] + 0.3 * span, n))
    for _ in range(nobs, nfields):
        cols.append(rng.uniform(-1, 1, n))
    samples = np.stack(cols, axis=1).astype(np.float32)

    systs = []
    npars = 0
    for _ in range(int(rng.integers(0, 3))):
        typ = int(rng.choice([SHIFT, SCALE, CTSCALE, RESOLUTION_SCALE]))
        obs = int(rng.integers(0, nobs))
        extra = nobs if (typ == RESOLUTION_SCALE and nfields > nobs) \
            else 0
        if typ == RESOLUTION_SCALE and nfields == nobs:
            typ = SHIFT
        k = int(rng.integers(1, 3))
        systs.append(SystematicDesc(typ, obs=obs,
                                    par_indices=tuple(
                                        range(npars, npars + k)),
                                    extra_field=extra))
        npars += k
    theta = rng.normal(0, 0.05, max(npars, 1)).astype(np.float32)
    return samples, nobs, nfields, tuple(systs), theta, lower, upper, \
        nbins


@pytest.mark.parametrize("case", range(N_CASES))
def test_device_histogram_matches_host_random_geometry(case):
    rng = np.random.default_rng(1000 + case)
    (samples, nobs, nfields, systs, theta, lower, upper,
     nbins) = random_geometry(rng)
    theta_j = jnp.asarray(theta)

    transformed = transforms.apply_systematics(
        jnp.asarray(samples), theta_j, systs)
    ids, valid = hist_ops.compute_bin_ids(
        transformed[:, :nobs], jnp.asarray(lower), jnp.asarray(upper),
        nbins)
    total = hist_ops.total_bins(nbins)
    got = hist_ops.fixed_bincount(ids, valid.astype(jnp.float32), total)

    want = _host_histogram(np.asarray(transformed)[:, :nobs], lower,
                           upper, nbins)
    np.testing.assert_array_equal(np.asarray(got), want)
    # Conservation: in-domain samples each land in exactly one bin.
    assert float(np.asarray(got).sum()) == float(
        np.asarray(valid).sum())


@pytest.mark.parametrize("case", range(N_CASES))
def test_eval_lut_random_geometry(case):
    from sxmc_jax.pdf.evalhist import eval_from_bins

    rng = np.random.default_rng(2000 + case)
    nseg = int(rng.integers(1, 5))
    total = int(rng.integers(4, 400))
    hists = rng.integers(0, 30, (nseg, total)).astype(np.float32)
    norms = np.maximum(hists.sum(axis=1), 1.0)
    npts = int(rng.integers(16, 700))
    rb = rng.integers(-2, total, (nseg, npts)).astype(np.int32)
    bin_volume = float(rng.uniform(0.01, 2.0))

    got = jax.vmap(eval_from_bins, in_axes=(0, 0, None, 0))(
        jnp.asarray(hists), jnp.asarray(norms), bin_volume,
        jnp.asarray(rb))
    denom = norms[:, None] * np.float32(bin_volume)
    want = np.take_along_axis(hists, np.clip(rb, 0, total - 1),
                              axis=1) / denom
    want = np.where(rb == -2, np.float32(0.0), want)
    want = np.where(rb == -1, np.float32(np.nan), want)
    np.testing.assert_array_equal(np.asarray(got),
                                  want.astype(np.float32))


@pytest.mark.parametrize("case", range(N_CASES))
def test_nll_invariants_random(case):
    from sxmc_jax.ops.nll import BARRIER, NLLStatic, nll

    rng = np.random.default_rng(3000 + case)
    nsig = int(rng.integers(1, 6))
    nsrc = int(rng.integers(1, nsig + 1))
    nev = int(rng.integers(8, 2000))
    lut = rng.uniform(0, 2, (nsig, nev)).astype(np.float32)
    # Sprinkle the NaN (out-of-domain) sentinel rows the LUT carries.
    lut[rng.uniform(size=lut.shape) < 0.05] = np.nan
    norms = rng.uniform(10, 1000, nsig).astype(np.float32)
    st = NLLStatic(
        nexpected=rng.uniform(1, 100, nsig).astype(np.float32),
        n_mc=rng.uniform(100, 10000, nsig).astype(np.float32),
        source_id=rng.integers(0, nsrc, nsig).astype(np.int32),
        means=np.ones(nsrc + 1, np.float32),
        sigmas=rng.uniform(0, 0.5, nsrc + 1).astype(np.float32),
        nsources=nsrc)
    pars = np.abs(rng.normal(1, 0.3, nsrc + 1)).astype(np.float32)

    val = float(nll(jnp.asarray(pars), jnp.asarray(lut),
                    jnp.asarray(norms), st))
    assert np.isfinite(val) and val < BARRIER / 2

    bad = pars.copy()
    bad[int(rng.integers(0, nsrc))] = -0.1
    val_bad = float(nll(jnp.asarray(bad), jnp.asarray(lut),
                        jnp.asarray(norms), st))
    assert val_bad == float(np.float32(BARRIER))
