"""Goodness-of-fit tests (saturated chi2 + posterior-predictive toys).

The reference has no GOF machinery; these pin the new module against
known-good and known-bad fits.
"""

import jax
import numpy as np

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.signal import Observable, Signal, Source, Systematic
from sxmc_jax.stats.gof import baker_cousins_chi2, goodness_of_fit


def make_fixture(seed=1):
    rng = np.random.default_rng(seed)
    obs = Observable(name="energy", field="energy", bins=20, lower=5.0,
                     upper=15.0, field_index=0)
    syst = Systematic(
        name="energy_shift", type=0, observable_field="energy",
        means=[0.0], sigmas=[0.05], observable_field_index=0, pidx=[0])
    sample_fields = ["energy", "DATASET"]
    sig_mc = rng.normal(10, 1, (50000, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (50000, 1)).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0, sigma=0.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    sig = Signal.from_table("sig", "Signal", sig_mc, ["energy"], 0,
                            src_s, 500.0, sample_fields, [obs], [],
                            [syst])
    bkg = Signal.from_table("bkg", "Bkg", bkg_mc, ["energy"], 0, src_b,
                            1000.0, sample_fields, [obs], [], [])
    return obs, [syst], [src_s, src_b], [sig, bkg]


class TestBakerCousins:
    def test_perfect_fit_is_zero(self):
        n = np.array([3.0, 7.0, 0.0, 2.0])
        assert baker_cousins_chi2(n, n) == 0.0

    def test_known_value(self):
        # Single bin: mu=4, n=9 -> 2*(4 - 9 + 9*ln(9/4)).
        expect = 2.0 * (4.0 - 9.0 + 9.0 * np.log(9.0 / 4.0))
        assert abs(baker_cousins_chi2([9.0], [4.0]) - expect) < 1e-12

    def test_empty_model_bin_with_data_is_huge(self):
        assert baker_cousins_chi2([5.0], [0.0]) > 1e2


class TestGoodnessOfFit:
    def test_good_fit_passes(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=True)
        # Truth parameters: rates 1, shift 0.
        params = np.array([1.0, 1.0, 0.0], np.float32)
        res = goodness_of_fit(sources, signals, systs, [obs], data,
                              params, ntoys=200,
                              key=jax.random.PRNGKey(8))
        assert res.ndof == 20 - 3
        assert 0.01 < res.p_asymptotic < 0.99, res
        assert 0.01 < res.p_toys < 0.995, res
        assert res.chi2_toys.shape == (200,)

    def test_bad_fit_fails(self):
        obs, systs, sources, signals = make_fixture()
        # Data drawn at a large shift the model (pinned at 0) ignores.
        data = make_fake_dataset(
            jax.random.PRNGKey(4), signals, systs, [obs], poisson=True,
            theta=np.array([1.5], np.float32))
        params = np.array([1.0, 1.0, 0.0], np.float32)
        res = goodness_of_fit(sources, signals, systs, [obs], data,
                              params, ntoys=100,
                              key=jax.random.PRNGKey(8))
        assert res.chi2 / res.ndof > 3.0, res
        assert res.p_asymptotic < 1e-3, res
        assert res.p_toys <= 0.01, res

    def test_observed_counts_match_events(self):
        from sxmc_jax.pdf.stack import PdfStack
        from sxmc_jax.stats.gof import _observed_counts

        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        stack = PdfStack(signals, [obs], systs)
        counts = _observed_counts(data, stack, [0])
        in_domain = ((data[:, 0] >= 5.0) & (data[:, 0] < 15.0)
                     & (data[:, 1] == 0)).sum()
        assert counts.sum() == in_domain

    def test_refit_bootstrap(self):
        """The full parametric bootstrap (per-toy refitted rates) must
        still discriminate, and its p-value sits at or below the
        conservative plug-in's (refitting absorbs statistical slack)."""
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=True)
        params = np.array([1.0, 1.0, 0.0], np.float32)
        plug = goodness_of_fit(sources, signals, systs, [obs], data,
                               params, ntoys=150,
                               key=jax.random.PRNGKey(8))
        boot = goodness_of_fit(sources, signals, systs, [obs], data,
                               params, ntoys=150,
                               key=jax.random.PRNGKey(8), refit=True)
        assert boot.chi2 == plug.chi2  # data statistic unchanged
        assert 0.01 < boot.p_toys < 0.99
        assert boot.p_toys <= plug.p_toys + 0.05, (boot, plug)

        data_bad = make_fake_dataset(
            jax.random.PRNGKey(4), signals, systs, [obs], poisson=True,
            theta=np.array([1.5], np.float32))
        bad = goodness_of_fit(sources, signals, systs, [obs], data_bad,
                              params, ntoys=100,
                              key=jax.random.PRNGKey(8), refit=True)
        assert bad.p_toys <= 0.01

    def test_str_roundtrip(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=True)
        params = np.array([1.0, 1.0, 0.0], np.float32)
        res = goodness_of_fit(sources, signals, systs, [obs], data,
                              params)
        assert "chi2/ndof" in str(res)
