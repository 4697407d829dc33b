"""MCMC posterior-recovery tests on analytic targets.

The reference ships no MCMC tests (SURVEY.md section 4); these validate
the sampler against known posteriors.
"""

import numpy as np
import jax
import pytest

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.signal import Observable, Signal, Source, Systematic


def make_fixture(with_systematic=False, seed=1):
    rng = np.random.default_rng(seed)
    obs = Observable(name="energy", field="energy", bins=20, lower=5.0,
                     upper=15.0, field_index=0)
    systs = []
    if with_systematic:
        syst = Systematic(
            name="energy_shift", type=0, observable_field="energy",
            means=[0.0], sigmas=[0.05], observable_field_index=0,
            pidx=[0])
        systs = [syst]
    sample_fields = ["energy", "DATASET"]

    sig_mc = rng.normal(10, 1, (20000, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (20000, 1)).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0, sigma=0.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    sig = Signal.from_table("sig", "Signal", sig_mc, ["energy"], 0, src_s,
                            200.0, sample_fields, [obs], [], systs)
    bkg = Signal.from_table("bkg", "Bkg", bkg_mc, ["energy"], 0, src_b,
                            400.0, sample_fields, [obs], [], [])
    return obs, systs, [src_s, src_b], [sig, bkg]


class TestMetropolis:
    def test_posterior_recovery(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])
        ls = mcmc(data, nsteps=20000, burnin_fraction=0.2, seed=5)
        bf = ls.get_best_fit()
        # ~200 signal events: sqrt(200)/200 ~ 7% stat error; allow 4 sigma.
        assert abs(bf["sig"].point_estimate - 1.0) < 0.3, bf["sig"]
        assert abs(bf["bkg"].point_estimate - 1.0) < 0.2, bf["bkg"]
        # Interval widths are sane (neither collapsed nor huge).
        width = bf["sig"].upper - bf["sig"].lower
        assert 0.05 < width < 1.0

    def test_debug_mode_accepts_everything(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])
        mcmc(data, nsteps=500, burnin_fraction=0.0, debug_mode=True, seed=5)
        assert mcmc.last_accept_rate == 1.0

    def test_fixed_parameter_pinned(self):
        obs, systs, sources, signals = make_fixture()
        sources[1].fixed = True
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])
        ls = mcmc(data, nsteps=2000, burnin_fraction=0.1, seed=5)
        np.testing.assert_array_equal(ls.column("bkg"), 1.0)

    def test_floating_systematic_runs(self):
        obs, systs, sources, signals = make_fixture(with_systematic=True)
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])
        assert not mcmc.systematics_fixed
        ls = mcmc(data, nsteps=3000, burnin_fraction=0.1, seed=5)
        bf = ls.get_best_fit()
        # The shift is constrained at 0 +- 0.05 and truth is 0.
        assert abs(bf["energy_shift_0"].point_estimate) < 0.15
        assert abs(bf["sig"].point_estimate - 1.0) < 0.4

    def test_multichain_pools_samples(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])
        ls1 = mcmc(data, nsteps=1000, burnin_fraction=0.2, seed=5)
        ls4 = mcmc(data, nsteps=1000, burnin_fraction=0.2, seed=5,
                   nchains=4)
        assert ls4.samples.shape[0] == 4 * ls1.samples.shape[0]

    def test_jump_width_heuristics(self):
        obs, systs, sources, signals = make_fixture(with_systematic=True)
        sources[0].sigma = 0.0
        sources[0].mean = 100.0
        mcmc = MCMC(sources, signals, systs, [obs])
        w = mcmc.initial_jump_widths()
        sf = 2.4 ** 2 / mcmc.nfloat
        # Unconstrained rate: sqrt(max(mean,10))/max(mean,10)
        np.testing.assert_allclose(w[0], 0.1 * (np.sqrt(100) / 100) * sf,
                                   rtol=1e-5)
        # Constrained: width = sigma
        np.testing.assert_allclose(w[1], 0.1 * 0.1 * sf, rtol=1e-5)
        # Constrained systematic: width = sigma
        np.testing.assert_allclose(w[2], 0.1 * 0.05 * sf, rtol=1e-5)

    def test_nll_initial_point(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])
        v = mcmc.nll(data, [1.0, 1.0])
        assert np.isfinite(v)
        # Barrier at negative rate.
        assert mcmc.nll(data, [-1.0, 1.0]) == float(np.float32(1e18))


class TestPooledAdaptation:
    def test_pooled_widths_recover_posterior(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])
        ls = mcmc(data, nsteps=6000, burnin_fraction=0.2, seed=5,
                  nchains=4, pool_adaptation=True)
        bf = ls.get_best_fit()
        assert abs(bf["sig"].point_estimate - 1.0) < 0.3
        assert abs(bf["bkg"].point_estimate - 1.0) < 0.2
        # 4 chains x (6000 - 2*1200) kept steps pooled.
        assert ls.samples.shape[0] == 4 * (6000 - 2400)
        assert 0.05 < mcmc.last_accept_rate < 0.9

    def test_pooled_matches_independent_statistics(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])
        ls_pool = mcmc(data, nsteps=8000, burnin_fraction=0.2, seed=5,
                       nchains=4, pool_adaptation=True)
        ls_ind = mcmc(data, nsteps=8000, burnin_fraction=0.2, seed=5,
                      nchains=4)
        sp = ls_pool.column("sig").std()
        si = ls_ind.column("sig").std()
        assert abs(sp - si) < 0.5 * si, (sp, si)
