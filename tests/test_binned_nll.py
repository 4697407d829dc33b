"""Binned-likelihood equivalence tests.

With histogram PDFs the unbinned extended NLL regroups EXACTLY by
(dataset, bin): sum_i log s(x_i) == sum_{d,b} n_{d,b} log s_{d,b}.
These tests pin that identity against the event-wise path
(ops/nll.nll_pair) across datasets, systematics, sentinels and
weighted (Asimov) data.  The reference has no binned mode — its LUT
walk is always per-event (pdfz.cpp:411-436) — so the binned path is a
pure speedup with no semantic delta to validate against C++.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.ops.nll import NLLStatic, BARRIER, binned_nll, nll
from sxmc_jax.pdf.stack import PdfStack
from sxmc_jax.signal import Observable, Signal, Source, Systematic


def make_fixture(with_systematic=True, seed=3):
    rng = np.random.default_rng(seed)
    obs = Observable(name="energy", field="energy", bins=24, lower=5.0,
                     upper=15.0, field_index=0)
    systs = []
    if with_systematic:
        systs = [Systematic(
            name="energy_shift", type=0, observable_field="energy",
            means=[0.0], sigmas=[0.05], observable_field_index=0,
            pidx=[0])]
    sample_fields = ["energy", "DATASET"]
    src_s = Source(name="sig", index=0, mean=1.0, sigma=0.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    sig0 = Signal.from_table(
        "sig0", "S0", rng.normal(10, 1, (8000, 1)).astype(np.float32),
        ["energy"], 0, src_s, 200.0, sample_fields, [obs], [], systs)
    bkg0 = Signal.from_table(
        "bkg0", "B0", rng.uniform(5, 15, (8000, 1)).astype(np.float32),
        ["energy"], 0, src_b, 400.0, sample_fields, [obs], [], [])
    sig1 = Signal.from_table(
        "sig1", "S1", rng.normal(9, 2, (8000, 1)).astype(np.float32),
        ["energy"], 1, src_s, 100.0, sample_fields, [obs], [], systs)
    signals = [sig0, bkg0, sig1]
    stack = PdfStack(signals, [obs], systs)
    st = NLLStatic(
        nexpected=np.asarray([s.nexpected for s in signals], np.float32),
        n_mc=np.asarray([s.n_mc for s in signals], np.float32),
        source_id=np.asarray([0, 1, 0], np.int32),
        means=np.asarray([1.0, 1.0, 0.0], np.float32),
        sigmas=np.asarray([0.0, 0.1, 0.05], np.float32),
        nsources=2)
    return stack, st, systs


def make_data(rng, n=3000):
    """Events in datasets 0/1 + out-of-domain rows + unknown tags."""
    e = np.concatenate([
        rng.normal(10, 1.5, n),
        rng.uniform(5, 15, n),
        rng.uniform(3, 5, 40),        # out of domain (-1 sentinel)
        rng.uniform(5, 15, 30),       # unknown dataset tag (-2)
    ]).astype(np.float32)
    tags = np.concatenate([
        rng.integers(0, 2, n), rng.integers(0, 2, n),
        rng.integers(0, 2, 40), np.full(30, 7),
    ]).astype(np.float32)
    return np.stack([e, tags], axis=1)


def unbinned(stack, st, data, pars, weights=None):
    rb = stack.compute_read_bins(data)
    lut, norms = stack.evaluate(jnp.asarray(pars[st.nsources:]), rb)
    return float(nll(jnp.asarray(pars), lut, norms, st,
                     None if weights is None else jnp.asarray(weights)))


def binned(stack, st, data, pars, weights=None):
    hists, norms = stack.histograms(jnp.asarray(pars[st.nsources:]))
    counts = stack.data_bin_counts(data, weights)
    return float(binned_nll(jnp.asarray(pars), hists, norms, st, counts,
                            stack.dataset_mask, stack.bin_volume))


class TestBinnedEquivalence:
    def test_matches_unbinned_across_parameter_points(self):
        stack, st, _ = make_fixture()
        data = make_data(np.random.default_rng(11))
        for pars in ([1.0, 1.0, 0.0], [0.7, 1.3, 0.08],
                     [2.0, 0.5, -0.12], [1.0, 1.0, 0.2]):
            a = unbinned(stack, st, data, np.asarray(pars, np.float32))
            b = binned(stack, st, data, np.asarray(pars, np.float32))
            np.testing.assert_allclose(b, a, rtol=2e-6, atol=2e-3)

    def test_no_systematics(self):
        stack, st, _ = make_fixture(with_systematic=False)
        st = st._replace(means=st.means[:2], sigmas=st.sigmas[:2])
        data = make_data(np.random.default_rng(12))
        for pars in ([1.0, 1.0], [0.4, 1.8]):
            a = unbinned(stack, st, data, np.asarray(pars, np.float32))
            b = binned(stack, st, data, np.asarray(pars, np.float32))
            np.testing.assert_allclose(b, a, rtol=2e-6, atol=2e-3)

    def test_weighted_asimov_data(self):
        stack, st, _ = make_fixture()
        data = make_data(np.random.default_rng(13), n=500)
        w = np.random.default_rng(14).uniform(
            0.2, 3.0, data.shape[0]).astype(np.float32)
        pars = np.asarray([1.1, 0.9, 0.03], np.float32)
        a = unbinned(stack, st, data, pars, w)
        b = binned(stack, st, data, pars, w)
        np.testing.assert_allclose(b, a, rtol=2e-6, atol=2e-3)

    def test_barrier_on_negative_rate(self):
        stack, st, _ = make_fixture()
        data = make_data(np.random.default_rng(15), n=200)
        v = binned(stack, st, data, np.asarray([-0.1, 1.0, 0.0],
                                               np.float32))
        assert v == float(np.float32(BARRIER))

    def test_batched_data_counts(self):
        stack, st, _ = make_fixture()
        rng = np.random.default_rng(16)
        batch = np.stack([make_data(rng, n=300) for _ in range(4)])
        counts = stack.data_bin_counts(batch)
        assert counts.shape == (4, 2, stack.total_nbins)
        one = stack.data_bin_counts(batch[2])
        np.testing.assert_allclose(np.asarray(counts[2]), np.asarray(one))

    def test_sentinel_events_invisible(self):
        # Appending out-of-domain / unknown-tag rows changes nothing.
        stack, st, _ = make_fixture()
        rng = np.random.default_rng(17)
        data = make_data(rng, n=400)
        pad = np.stack([
            np.full(25, -1.0, np.float32),        # out of domain
            np.full(25, -1.0, np.float32)],       # unknown tag too
            axis=1)
        a = binned(stack, st, data, np.asarray([1.0, 1.0, 0.05],
                                               np.float32))
        b = binned(stack, st, np.concatenate([data, pad]),
                   np.asarray([1.0, 1.0, 0.05], np.float32))
        np.testing.assert_allclose(b, a, rtol=0, atol=0)

    def test_gradients_match(self):
        stack, st, _ = make_fixture()
        data = make_data(np.random.default_rng(18), n=800)
        rb = stack.compute_read_bins(data)
        counts = stack.data_bin_counts(data)
        mask = stack.dataset_mask

        def f_unb(p):
            lut, norms = stack.evaluate(p[st.nsources:], rb)
            return nll(p, lut, norms, st)

        def f_bin(p):
            hists, norms = stack.histograms(p[st.nsources:])
            return binned_nll(p, hists, norms, st, counts, mask,
                              stack.bin_volume)

        p = jnp.asarray([1.2, 0.8, 0.04], jnp.float32)
        ga = jax.grad(f_unb)(p)
        gb = jax.grad(f_bin)(p)
        np.testing.assert_allclose(np.asarray(gb), np.asarray(ga),
                                   rtol=5e-4, atol=5e-3)

    def test_counts_from_read_bins_matches_data_bin_counts(self):
        stack, st, _ = make_fixture()
        data = make_data(np.random.default_rng(19), n=700)
        a = stack.data_bin_counts(data)
        b = stack.counts_from_read_bins(stack.compute_read_bins(data))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def mcmc_fixture(binned, seed=1):
    rng = np.random.default_rng(seed)
    obs = Observable(name="energy", field="energy", bins=20, lower=5.0,
                     upper=15.0, field_index=0)
    systs = [Systematic(
        name="energy_shift", type=0, observable_field="energy",
        means=[0.0], sigmas=[0.05], observable_field_index=0, pidx=[0])]
    sample_fields = ["energy", "DATASET"]
    src_s = Source(name="sig", index=0, mean=1.0, sigma=0.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    sig = Signal.from_table(
        "sig", "S", rng.normal(10, 1, (20000, 1)).astype(np.float32),
        ["energy"], 0, src_s, 200.0, sample_fields, [obs], [], systs)
    bkg = Signal.from_table(
        "bkg", "B", rng.uniform(5, 15, (20000, 1)).astype(np.float32),
        ["energy"], 0, src_b, 400.0, sample_fields, [obs], [], [])
    m = MCMC([src_s, src_b], [sig, bkg], systs, [obs], binned=binned)
    e = np.concatenate([rng.normal(10, 1, 200),
                        rng.uniform(5, 15, 400)]).astype(np.float32)
    data = np.stack([e, np.zeros_like(e)], axis=1)
    return m, data


class TestBinnedSampler:
    """Debug mode accepts every proposal, so binned and unbinned runs
    with the same key produce IDENTICAL parameter trajectories — the
    NLL histories must then agree to compensated-f32 accuracy, which
    pins the whole sampler plumbing (stepper, batched, blocked)."""

    def _histories(self, binned, **kw):
        m, data = mcmc_fixture(binned)
        ls = m(data, nsteps=120, burnin_fraction=0.2, debug_mode=True,
               seed=7, **kw)
        return ls.samples, ls.nll_values

    @pytest.mark.parametrize("kw", [
        {}, {"nchains": 3}, {"rate_substeps": 2},
        {"nchains": 2, "rate_substeps": 2}, {"proposal": "full_cov"},
    ])
    def test_debug_trajectories_identical(self, kw):
        s_u, n_u = self._histories(False, **kw)
        s_b, n_b = self._histories(True, **kw)
        np.testing.assert_array_equal(s_b, s_u)
        np.testing.assert_allclose(n_b, n_u, rtol=3e-6, atol=2e-3)

    def test_binned_posterior_recovery(self):
        m, data = mcmc_fixture(True)
        ls = m(data, nsteps=6000, burnin_fraction=0.2, seed=5)
        bf = ls.get_best_fit()
        assert abs(bf["sig"].point_estimate - 1.0) < 0.6
        assert abs(bf["bkg"].point_estimate - 1.0) < 0.5

    def test_exact_kde_refused(self):
        rng = np.random.default_rng(2)
        obs = Observable(name="x", field="x", bins=10, lower=0.0,
                         upper=1.0, field_index=0)
        src = Source(name="s", index=0, mean=1.0, sigma=0.0)
        sig = Signal.from_table(
            "s", "S", rng.uniform(0, 1, (500, 1)).astype(np.float32),
            ["x"], 0, src, 50.0, ["x", "DATASET"], [obs], [], [],
            kde=True, kde_exact=True)
        with pytest.raises(ValueError, match="binned"):
            MCMC([src], [sig], [], [obs], binned=True)


class TestBinnedMLE:
    def test_fit_matches_unbinned(self):
        from sxmc_jax.stats.mle import MLE

        rng = np.random.default_rng(21)
        obs = Observable(name="energy", field="energy", bins=20,
                         lower=5.0, upper=15.0, field_index=0)
        systs = [Systematic(
            name="energy_shift", type=0, observable_field="energy",
            means=[0.0], sigmas=[0.05], observable_field_index=0,
            pidx=[0])]
        sf = ["energy", "DATASET"]
        src_s = Source(name="sig", index=0, mean=1.0, sigma=0.0)
        src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
        sig = Signal.from_table(
            "sig", "S", rng.normal(10, 1, (20000, 1)).astype(np.float32),
            ["energy"], 0, src_s, 200.0, sf, [obs], [], systs)
        bkg = Signal.from_table(
            "bkg", "B", rng.uniform(5, 15, (20000, 1)).astype(np.float32),
            ["energy"], 0, src_b, 400.0, sf, [obs], [], [])
        e = np.concatenate([rng.normal(10, 1, 200),
                            rng.uniform(5, 15, 400)]).astype(np.float32)
        data = np.stack([e, np.zeros_like(e)], axis=1)

        res_u = MLE([src_s, src_b], [sig, bkg], systs, [obs],
                    binned=False).fit(data)
        res_b = MLE([src_s, src_b], [sig, bkg], systs, [obs],
                    binned=True).fit(data)
        # Same likelihood surface to ~1e-6: identical optimum.
        np.testing.assert_allclose(res_b.nll, res_u.nll,
                                   rtol=1e-5, atol=5e-3)
        for name in ("sig", "bkg"):
            np.testing.assert_allclose(
                res_b.value(name), res_u.value(name),
                rtol=5e-4, atol=5e-4)
            np.testing.assert_allclose(
                res_b.error(name), res_u.error(name),
                rtol=2e-2, atol=1e-3)


class TestBinnedHMC:
    def test_hmc_binned_runs(self):
        from sxmc_jax.mcmc.hmc import HMC

        rng = np.random.default_rng(8)
        obs = Observable(name="energy", field="energy", bins=20,
                         lower=5.0, upper=15.0, field_index=0)
        src_s = Source(name="sig", index=0, mean=1.0, sigma=0.0)
        src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
        sf = ["energy", "DATASET"]
        sig = Signal.from_table(
            "sig", "S", rng.normal(10, 1, (8000, 1)).astype(np.float32),
            ["energy"], 0, src_s, 200.0, sf, [obs], [], [])
        bkg = Signal.from_table(
            "bkg", "B", rng.uniform(5, 15, (8000, 1)).astype(np.float32),
            ["energy"], 0, src_b, 400.0, sf, [obs], [], [])
        e = np.concatenate([rng.normal(10, 1, 200),
                            rng.uniform(5, 15, 400)]).astype(np.float32)
        data = np.stack([e, np.zeros_like(e)], axis=1)
        h = HMC([src_s, src_b], [sig, bkg], [], [obs], binned=True)
        ls = h(data, nsteps=300, burnin_fraction=0.3, seed=3)
        bf = ls.get_best_fit()
        assert abs(bf["sig"].point_estimate - 1.0) < 0.8
