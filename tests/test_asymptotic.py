"""Weighted-event NLL, Asimov datasets, and asymptotic CLs/discovery."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sxmc_jax.ops.histogram import compute_bin_ids
from sxmc_jax.ops.nll import NLLStatic, nll
from sxmc_jax.signal import Observable, Signal, Source
from sxmc_jax.stats.asimov import asimov_dataset, bin_centers
from sxmc_jax.stats.hypotest import HypoTest
from sxmc_jax.stats.mle import MLE


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(3)
    obs = Observable(name="energy", field="energy", bins=20, lower=5.0,
                     upper=15.0, field_index=0)
    sig_mc = rng.normal(10, 1, (20000, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (20000, 1)).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0, sigma=0.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    fields = ["energy", "DATASET"]
    sig = Signal.from_table("sig", "S", sig_mc, ["energy"], 0, src_s,
                            80.0, fields, [obs], [], [])
    bkg = Signal.from_table("bkg", "B", bkg_mc, ["energy"], 0, src_b,
                            400.0, fields, [obs], [], [])
    return obs, [src_s, src_b], [sig, bkg]


def bkg_only_data(n=400, seed=5):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(5, 15, n).astype(np.float32),
                     np.zeros(n, np.float32)], axis=1)


class TestWeightedNLL:
    def test_weight_k_equals_k_copies(self):
        """sum_i w_i log s_i: weight 3 == the event appearing 3 times."""
        st = NLLStatic(
            nexpected=np.asarray([10.0], np.float32),
            n_mc=np.asarray([100.0], np.float32),
            source_id=np.asarray([0], np.int32),
            means=np.asarray([1.0], np.float32),
            sigmas=np.asarray([0.0], np.float32),
            nsources=1)
        pars = jnp.asarray([1.3], jnp.float32)
        norms = jnp.asarray([90.0], jnp.float32)
        lut_rep = jnp.asarray([[0.2, 0.2, 0.2, 0.5]], jnp.float32)
        lut_w = jnp.asarray([[0.2, 0.5]], jnp.float32)
        w = jnp.asarray([3.0, 1.0], jnp.float32)
        a = float(nll(pars, lut_rep, norms, st))
        b = float(nll(pars, lut_w, norms, st, w))
        assert a == pytest.approx(b, abs=1e-5)

    def test_none_weights_is_default(self):
        st = NLLStatic(
            nexpected=np.asarray([10.0], np.float32),
            n_mc=np.asarray([100.0], np.float32),
            source_id=np.asarray([0], np.int32),
            means=np.asarray([1.0], np.float32),
            sigmas=np.asarray([0.0], np.float32),
            nsources=1)
        pars = jnp.asarray([0.7], jnp.float32)
        norms = jnp.asarray([90.0], jnp.float32)
        lut = jnp.asarray([[0.1, 0.4]], jnp.float32)
        ones = jnp.ones(2, jnp.float32)
        assert float(nll(pars, lut, norms, st)) == pytest.approx(
            float(nll(pars, lut, norms, st, ones)), abs=1e-6)


class TestAsimovDataset:
    def test_bin_centers_land_in_their_bin(self, model):
        obs, sources, signals = model
        mle = MLE(sources, signals, [], [obs])
        centers = bin_centers(mle.stack)
        assert centers.shape == (20, 1)
        ids, valid = compute_bin_ids(
            jnp.asarray(centers), mle.stack.lower, mle.stack.upper,
            mle.stack.nbins)
        assert bool(jnp.all(valid))
        assert np.array_equal(np.asarray(ids), np.arange(20))

    def test_total_weight_is_expected_count(self, model):
        obs, sources, signals = model
        mle = MLE(sources, signals, [], [obs])
        data, w = asimov_dataset(mle)
        effs = np.asarray(mle.stack.efficiencies(
            np.zeros(0, np.float32)))
        expected = 80.0 * effs[0] + 400.0 * effs[1]
        assert w.sum() == pytest.approx(expected, rel=1e-5)
        assert data.shape[1] == 2
        assert np.all(data[:, 1] == 0.0)  # dataset tag

    def test_fit_recovers_generating_rates(self, model):
        """The MLE on the Asimov dataset equals the generation point
        (exactly, when constrained parameters generate at their
        constraint centers — else the Gaussian pull shifts the
        minimum, which is correct behavior, not a bug)."""
        obs, sources, signals = model
        mle = MLE(sources, signals, [], [obs])
        data, w = asimov_dataset(mle, overrides={"sig": 0.6})
        res = mle.fit(data, weights=w)
        assert res.value("sig") == pytest.approx(0.6, abs=0.02)
        assert res.value("bkg") == pytest.approx(1.0, abs=0.02)

    def test_override_zero_drops_signal(self, model):
        obs, sources, signals = model
        mle = MLE(sources, signals, [], [obs])
        full_w = asimov_dataset(mle)[1].sum()
        b_w = asimov_dataset(mle, overrides={"sig": 0.0})[1].sum()
        assert b_w < full_w
        effs = np.asarray(mle.stack.efficiencies(
            np.zeros(0, np.float32)))
        assert b_w == pytest.approx(400.0 * effs[1], rel=1e-5)


class TestAsymptoticDiscovery:
    def test_expected_significance_scales_with_rate(self, model):
        obs, sources, signals = model
        ht = HypoTest(MLE(sources, signals, [], [obs]), "sig")
        z1 = ht.asymptotic_significance(1.0).z_asymptotic
        z2 = ht.asymptotic_significance(2.0).z_asymptotic
        assert z1 > 2.0          # 80 peaked events over 400 flat
        assert z2 > z1 * 1.5     # roughly linear in s/sqrt(b)
        # s/sqrt(b) ballpark within the 10-15 window (~3 sigma of peak):
        # s ~ 80, b ~ 400/2 -> Z ~ 5.7; Asimov should be within ~2.
        assert 3.0 < z1 < 9.0

    def test_zero_rate_gives_zero(self, model):
        obs, sources, signals = model
        ht = HypoTest(MLE(sources, signals, [], [obs]), "sig")
        res = ht.asymptotic_significance(0.0)
        assert res.q0 == pytest.approx(0.0, abs=1e-3)


class TestAsymptoticCLs:
    def test_background_only_limit_and_band(self, model):
        obs, sources, signals = model
        ht = HypoTest(MLE(sources, signals, [], [obs]), "sig")
        grid = np.linspace(0.05, 2.0, 12)
        res = ht.asymptotic_upper_limit(bkg_only_data(), grid, cl=0.95)
        assert 0.05 < res.limit < 2.0, res
        # Band ordering is exact (no toy noise) and strict.
        assert (res.expected[-2] <= res.expected[-1] <= res.expected[0]
                <= res.expected[1] <= res.expected[2]), res.expected
        # Background-only data: the observed limit sits inside the
        # central band.
        assert res.expected[-2] <= res.limit <= res.expected[2] * 1.5
        assert "asymptotic CLs" in str(res)

    def test_matches_toy_cls(self, model):
        """Asymptotic and toy CLs limits agree on background-only data
        (within toy-MC resolution)."""
        obs, sources, signals = model
        ht = HypoTest(MLE(sources, signals, [], [obs]), "sig")
        grid = np.linspace(0.1, 2.0, 6)
        data = bkg_only_data()
        asym = ht.asymptotic_upper_limit(data, grid, cl=0.95)
        toy_limit, _, _ = ht.cls_upper_limit(
            jax.random.PRNGKey(4), data, grid, ntoys=150, cl=0.95)
        assert asym.limit == pytest.approx(toy_limit, rel=0.5), \
            (asym.limit, toy_limit)

    def test_observed_state_preserved(self, model):
        """The Asimov side-fit must not clobber the observed fit."""
        obs, sources, signals = model
        mle = MLE(sources, signals, [], [obs])
        ht = HypoTest(mle, "sig")
        data = bkg_only_data()
        result = mle.fit(data)
        nll_before = result.nll
        ht.asymptotic_upper_limit(data, np.linspace(0.1, 2.0, 4))
        res2, _, _, w = mle._ensure_fit(None)
        assert w is None                       # observed data unweighted
        assert res2.nll == pytest.approx(nll_before, abs=1e-4)


class TestConstrainedPOIWarning:
    def test_warns_on_constrained_signal(self, model):
        obs, sources, signals = model
        import copy

        from sxmc_jax.signal import Source

        src_s = Source(name="sig", index=0, mean=1.0, sigma=0.1)
        sigs = [copy.copy(signals[0]), signals[1]]
        sigs[0].source = src_s
        mle = MLE([src_s, sources[1]], sigs, [], [obs])
        with pytest.warns(UserWarning, match="UNCONSTRAINED"):
            HypoTest(mle, "sig")

    def test_no_warning_unconstrained(self, model):
        import warnings

        obs, sources, signals = model
        mle = MLE(sources, signals, [], [obs])
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            HypoTest(mle, "sig")
