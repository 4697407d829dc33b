"""HMC sampler tests: posterior recovery vs the Metropolis reference."""

import numpy as np
import jax
import pytest

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.mcmc.hmc import HMC
from sxmc_jax.mcmc.metropolis import MCMC
from tests.test_mcmc import make_fixture


class TestHMC:
    def test_posterior_recovery(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        hmc = HMC(sources, signals, systs, [obs])
        ls = hmc(data, nsteps=3000, burnin_fraction=0.3, seed=6)
        bf = ls.get_best_fit()
        assert abs(bf["sig"].point_estimate - 1.0) < 0.3, bf["sig"]
        assert abs(bf["bkg"].point_estimate - 1.0) < 0.2, bf["bkg"]
        assert hmc.last_accept_rate > 0.4

    def test_matches_metropolis_posterior(self):
        obs, systs, sources, signals = make_fixture(seed=3)
        data = make_fake_dataset(jax.random.PRNGKey(8), signals, systs,
                                 [obs], poisson=False)
        met = MCMC(sources, signals, systs, [obs])
        ls_m = met(data, nsteps=20000, burnin_fraction=0.2, seed=9)
        hmc = HMC(sources, signals, systs, [obs])
        ls_h = hmc(data, nsteps=4000, burnin_fraction=0.3, seed=9)

        # Posterior means and widths agree within MC error.
        for name in ["sig", "bkg"]:
            m_mean = ls_m.column(name).mean()
            h_mean = ls_h.column(name).mean()
            m_std = ls_m.column(name).std()
            h_std = ls_h.column(name).std()
            assert abs(m_mean - h_mean) < 4 * m_std / np.sqrt(100), \
                (name, m_mean, h_mean)
            assert 0.5 < h_std / m_std < 2.0, (name, m_std, h_std)

    def test_rates_stay_positive(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        hmc = HMC(sources, signals, systs, [obs])
        ls = hmc(data, nsteps=1000, burnin_fraction=0.3, seed=2)
        assert (ls.column("sig") > 0).all()
        assert (ls.column("bkg") > 0).all()

    def test_fixed_parameter_pinned(self):
        obs, systs, sources, signals = make_fixture()
        sources[1].fixed = True
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        hmc = HMC(sources, signals, systs, [obs])
        ls = hmc(data, nsteps=600, burnin_fraction=0.3, seed=2)
        np.testing.assert_allclose(ls.column("bkg"), 1.0, rtol=1e-6)

    def test_floating_systematic(self):
        obs, systs, sources, signals = make_fixture(with_systematic=True)
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        hmc = HMC(sources, signals, systs, [obs])
        ls = hmc(data, nsteps=1500, burnin_fraction=0.3, seed=2)
        bf = ls.get_best_fit()
        assert abs(bf["energy_shift_0"].point_estimate) < 0.2


class TestHMCBinned:
    """Binned likelihood through the gradient sampler (r5): the
    regrouped NLL is algebraically equal to the unbinned one with
    histogram PDFs, and differentiable in the rates, so HMC targets
    the identical posterior."""

    def test_binned_matches_unbinned_posterior(self):
        obs, systs, sources, signals = make_fixture(seed=3)
        data = make_fake_dataset(jax.random.PRNGKey(8), signals, systs,
                                 [obs], poisson=False)
        h_u = HMC(sources, signals, systs, [obs], binned=False)
        ls_u = h_u(data, nsteps=3000, burnin_fraction=0.3, seed=9)
        h_b = HMC(sources, signals, systs, [obs], binned=True)
        ls_b = h_b(data, nsteps=3000, burnin_fraction=0.3, seed=9)
        for name in ["sig", "bkg"]:
            u_mean = ls_u.column(name).mean()
            b_mean = ls_b.column(name).mean()
            u_std = ls_u.column(name).std()
            b_std = ls_b.column(name).std()
            assert u_std > 1e-4, (name, "unbinned chain stuck")
            assert abs(u_mean - b_mean) < 4 * u_std / np.sqrt(50), \
                (name, u_mean, b_mean)
            assert 0.5 < b_std / u_std < 2.0, (name, u_std, b_std)
        assert h_b.last_accept_rate > 0.4

    def test_binned_nll_values_match_unbinned(self):
        """The recorded NLL history itself must regroup exactly: same
        params -> same NLL (to compensated-pair precision) whether
        evaluated binned or unbinned."""
        from sxmc_jax.mcmc.metropolis import _nll_backend

        obs, systs, sources, signals = make_fixture(
            with_systematic=True, seed=3)
        data = make_fake_dataset(jax.random.PRNGKey(8), signals, systs,
                                 [obs], poisson=False)
        h_u = HMC(sources, signals, systs, [obs], binned=False)
        h_u.stack.set_data(data)
        h_b = HMC(sources, signals, systs, [obs], binned=True)
        h_b.stack.set_data(data)
        params = np.asarray(h_u.parameter_means, np.float32)
        params[:2] *= [1.1, 0.93]
        for h in (h_u, h_b):
            ev, _, pair = _nll_backend(h, h.stack._read_bins,
                                       h.stack.device_data)
            lut, norms = ev(params[h.nsources:])
            hi, lo = pair(params, lut, norms, h.static)
            h._probe = float(hi) + float(lo)
        assert abs(h_u._probe - h_b._probe) < 5e-3 * abs(h_u._probe)
