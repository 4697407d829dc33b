"""NUTS sampler tests: posterior recovery and agreement with Metropolis."""

import numpy as np
import jax
import pytest

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.mcmc.nuts import NUTS
from tests.test_mcmc import make_fixture


class TestNUTS:
    def test_posterior_recovery(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        nuts = NUTS(sources, signals, systs, [obs], max_depth=6)
        ls = nuts(data, nsteps=1500, burnin_fraction=0.3, seed=6)
        bf = ls.get_best_fit()
        assert abs(bf["sig"].point_estimate - 1.0) < 0.3, bf["sig"]
        assert abs(bf["bkg"].point_estimate - 1.0) < 0.2, bf["bkg"]
        # alpha statistic should be near the 0.8 target.
        assert nuts.last_accept_rate > 0.4

    def test_matches_metropolis_posterior(self):
        obs, systs, sources, signals = make_fixture(seed=3)
        data = make_fake_dataset(jax.random.PRNGKey(8), signals, systs,
                                 [obs], poisson=False)
        met = MCMC(sources, signals, systs, [obs])
        ls_m = met(data, nsteps=20000, burnin_fraction=0.2, seed=9)
        nuts = NUTS(sources, signals, systs, [obs], max_depth=6)
        ls_n = nuts(data, nsteps=2000, burnin_fraction=0.3, seed=9)

        for name in ["sig", "bkg"]:
            m_mean = ls_m.column(name).mean()
            n_mean = ls_n.column(name).mean()
            m_std = ls_m.column(name).std()
            n_std = ls_n.column(name).std()
            assert abs(m_mean - n_mean) < 5 * m_std / np.sqrt(100), \
                (name, m_mean, n_mean)
            assert 0.5 < n_std / m_std < 2.0, (name, m_std, n_std)

    def test_low_autocorrelation(self):
        """NUTS samples should decorrelate much faster than Metropolis."""
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        nuts = NUTS(sources, signals, systs, [obs], max_depth=6)
        ls = nuts(data, nsteps=1200, burnin_fraction=0.3, seed=3)
        x = ls.column("sig")
        x = x - x.mean()
        ac1 = float((x[:-1] * x[1:]).mean() / (x * x).mean())
        assert ac1 < 0.9  # Metropolis lag-1 is typically ~0.98+

    def test_rates_stay_positive(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        nuts = NUTS(sources, signals, systs, [obs], max_depth=5)
        ls = nuts(data, nsteps=400, burnin_fraction=0.3, seed=2)
        assert (ls.column("sig") > 0).all()
        assert (ls.column("bkg") > 0).all()

    def test_fixed_parameter_pinned(self):
        obs, systs, sources, signals = make_fixture()
        sources[1].fixed = True
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        nuts = NUTS(sources, signals, systs, [obs], max_depth=5)
        ls = nuts(data, nsteps=300, burnin_fraction=0.3, seed=2)
        np.testing.assert_allclose(ls.column("bkg"), 1.0, rtol=1e-6)


class TestNUTSBinned:
    def test_binned_matches_unbinned_posterior(self):
        """Binned likelihood through NUTS (r5): identical posterior
        to the unbinned form (exact regrouping)."""
        obs, systs, sources, signals = make_fixture(seed=3)
        data = make_fake_dataset(jax.random.PRNGKey(8), signals, systs,
                                 [obs], poisson=False)
        n_u = NUTS(sources, signals, systs, [obs], binned=False)
        ls_u = n_u(data, nsteps=1500, burnin_fraction=0.3, seed=9)
        n_b = NUTS(sources, signals, systs, [obs], binned=True)
        ls_b = n_b(data, nsteps=1500, burnin_fraction=0.3, seed=9)
        for name in ["sig", "bkg"]:
            u_mean = ls_u.column(name).mean()
            b_mean = ls_b.column(name).mean()
            u_std = ls_u.column(name).std()
            assert abs(u_mean - b_mean) < 4 * u_std / np.sqrt(50), \
                (name, u_mean, b_mean)
