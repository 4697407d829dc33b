"""Static-segment skip: signals no systematic touches are built once.

PdfStack partitions signals into dynamic (>=1 attached systematic) and
static (none).  Static histograms are precomputed on the host with
bit-matching bin-id math (stack._host_histogram) and scattered into the
per-step output, so every per-step kernel only processes dynamic MC
samples.  These tests pin exact equality with the full (all-segment)
build. Reference behavior: the reference rebuilds every PDF per step
(mcmc.cpp:207-209); skipping invariant ones is a pure optimization and
must be invisible in the outputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sxmc_jax.pdf.stack import PdfStack, _stack_histograms
from sxmc_jax.signal import Observable, Signal, Source, Systematic

FIELDS = ["energy", "DATASET"]


def _obs(bins=16):
    return Observable(name="energy", field="energy", bins=bins,
                      lower=0.0, upper=10.0, field_index=0)


def _shift():
    return Systematic(name="shift", type=0, observable_field="energy",
                      means=[0.0], sigmas=[0.1],
                      observable_field_index=0, pidx=[0])


def _signal(name, idx, mc, systs, weights=None):
    src = Source(name=name, index=idx, mean=1.0)
    sig = Signal.from_table(
        name, name, mc, ["energy"], 0, src, 100.0, FIELDS, [_obs()],
        [], systs)
    if weights is not None:
        sig.histogram.weights = np.asarray(weights, np.float32)
    return sig


def _full_reference(stack, arrays, theta, weights=None):
    """All-segment jnp build (the pre-optimization path)."""
    samples = jnp.asarray(np.concatenate(arrays))
    seg = jnp.asarray(np.concatenate([
        np.full(a.shape[0], i, np.int32) for i, a in enumerate(arrays)]))
    w = jnp.asarray(np.concatenate(weights)) if weights else None
    return _stack_histograms(
        samples, seg, jnp.asarray(theta, jnp.float32), stack.lower_host,
        stack.upper_host, stack.nbins, len(arrays), stack.systematics, w)


@pytest.fixture
def mixed():
    rng = np.random.default_rng(11)
    mc_dyn = rng.normal(5, 1.5, (4000, 1)).astype(np.float32)
    mc_sta = rng.uniform(0, 10, (6000, 1)).astype(np.float32)
    syst = _shift()
    sig = _signal("sig", 0, mc_dyn, [syst])
    bkg = _signal("bkg", 1, mc_sta, [])
    stack = PdfStack([sig, bkg], [_obs()], [syst])
    return stack, [mc_dyn, mc_sta]


def test_partition(mixed):
    stack, _ = mixed
    assert stack._dyn_idx == (0,)
    assert stack._static_idx == (1,)
    # The per-step device arrays hold ONLY the dynamic samples.
    assert stack.samples.shape[0] == 4000


def test_mixed_exact_vs_full_build(mixed):
    stack, arrays = mixed
    for theta in ([0.0], [0.7], [-0.3]):
        h_ref, n_ref = _full_reference(stack, arrays, theta)
        h, n = stack.histograms(jnp.asarray(theta, jnp.float32))
        np.testing.assert_array_equal(np.asarray(h_ref), np.asarray(h))
        np.testing.assert_array_equal(np.asarray(n_ref), np.asarray(n))


def test_mixed_batch_exact(mixed):
    stack, arrays = mixed
    thetas = jnp.asarray([[0.0], [0.4], [-0.2]], jnp.float32)
    hb, nb = stack.histograms_batch(thetas)
    for c in range(3):
        h_ref, n_ref = _full_reference(stack, arrays, thetas[c])
        np.testing.assert_array_equal(np.asarray(h_ref),
                                      np.asarray(hb[c]))
        np.testing.assert_array_equal(np.asarray(n_ref),
                                      np.asarray(nb[c]))


def test_evaluate_lut_with_static(mixed):
    stack, arrays = mixed
    rng = np.random.default_rng(3)
    data = np.stack([rng.uniform(0, 10, 500).astype(np.float32),
                     np.zeros(500, np.float32)], axis=1)
    stack.set_data(data)
    lut, norms = stack.evaluate(jnp.asarray([0.25], jnp.float32))
    assert lut.shape == (2, 500)
    # Static row integrates to its efficiency-weighted density.
    assert np.isfinite(np.asarray(lut)).all()
    np.testing.assert_allclose(np.asarray(norms)[1], 6000.0)


def test_all_static_no_systematics():
    rng = np.random.default_rng(5)
    arrays = [rng.normal(5, 2, (3000, 1)).astype(np.float32),
              rng.uniform(0, 10, (2000, 1)).astype(np.float32)]
    sigs = [_signal(f"s{i}", i, a, []) for i, a in enumerate(arrays)]
    stack = PdfStack(sigs, [_obs()], [])
    assert stack._ndyn == 0
    theta = jnp.zeros(0, jnp.float32)
    h, n = stack.histograms(theta)
    h_ref, n_ref = _full_reference(stack, arrays, theta)
    np.testing.assert_array_equal(np.asarray(h_ref), np.asarray(h))
    np.testing.assert_array_equal(np.asarray(n_ref), np.asarray(n))
    hb, nb = stack.histograms_batch(jnp.zeros((4, 0), jnp.float32))
    assert hb.shape == (4, 2, 16)
    np.testing.assert_array_equal(np.asarray(hb[2]), np.asarray(h))


def test_weighted_static_signal():
    rng = np.random.default_rng(7)
    mc_dyn = rng.normal(5, 1.5, (2000, 1)).astype(np.float32)
    mc_sta = rng.uniform(0, 10, (3000, 1)).astype(np.float32)
    w_sta = rng.uniform(0.5, 2.0, 3000).astype(np.float32)
    syst = _shift()
    sig = _signal("sig", 0, mc_dyn, [syst])
    bkg = _signal("bkg", 1, mc_sta, [], weights=w_sta)
    stack = PdfStack([sig, bkg], [_obs()], [syst])
    assert stack._static_idx == (1,)
    # Dynamic kernel runs unweighted (the only weighted signal is
    # static) — weights never ride the per-step path.
    assert not stack._dyn_has_weights
    h, n = stack.histograms(jnp.asarray([0.3], jnp.float32))
    h_ref, n_ref = _full_reference(
        stack, [mc_dyn, mc_sta], [0.3],
        weights=[np.ones(2000, np.float32), w_sta])
    np.testing.assert_allclose(np.asarray(h_ref), np.asarray(h),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(n_ref), np.asarray(n),
                               rtol=1e-6)


def test_syst_on_all_signals_keeps_everything_dynamic():
    rng = np.random.default_rng(9)
    arrays = [rng.normal(5, 1, (1000, 1)).astype(np.float32),
              rng.uniform(0, 10, (1500, 1)).astype(np.float32)]
    syst = _shift()
    sigs = [_signal(f"s{i}", i, a, [syst]) for i, a in enumerate(arrays)]
    stack = PdfStack(sigs, [_obs()], [syst])
    assert stack._ndyn == 2 and not stack._static_idx
    h, _ = stack.histograms(jnp.asarray([0.5], jnp.float32))
    h_ref, _ = _full_reference(stack, arrays, [0.5])
    np.testing.assert_array_equal(np.asarray(h_ref), np.asarray(h))


def test_mcmc_fit_with_static_background():
    """End-to-end: a fit whose background PDF is static recovers rates
    identically shaped to the all-dynamic config."""
    from sxmc_jax.mcmc.metropolis import MCMC

    rng = np.random.default_rng(13)
    mc_sig = rng.normal(5, 1, (20000, 1)).astype(np.float32)
    mc_bkg = rng.uniform(0, 10, (20000, 1)).astype(np.float32)
    syst = _shift()
    src_s = Source(name="s", index=0, mean=1.0)
    src_b = Source(name="b", index=1, mean=1.0, sigma=0.2)
    sig = Signal.from_table("sig", "s", mc_sig, ["energy"], 0, src_s,
                            300.0, FIELDS, [_obs(32)], [], [syst])
    bkg = Signal.from_table("bkg", "b", mc_bkg, ["energy"], 0, src_b,
                            700.0, FIELDS, [_obs(32)], [], [])
    mcmc = MCMC([src_s, src_b], [sig, bkg], [syst], [_obs(32)])
    assert mcmc.stack._static_idx == (1,)
    nev = 1000
    data = np.stack([
        np.concatenate([rng.normal(5, 1, 300),
                        rng.uniform(0, 10, 700)]).astype(np.float32),
        np.zeros(nev, np.float32)], axis=1)
    ls = mcmc(data, nsteps=3000, seed=2)
    best = ls.get_best_fit()
    assert 0.5 < best["s"].point_estimate < 1.6
    assert 0.6 < best["b"].point_estimate < 1.5
