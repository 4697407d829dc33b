"""Affine-invariant stretch sampler: posterior recovery + invariances."""

import numpy as np
import jax

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.mcmc.stretch import StretchSampler

from test_mcmc import make_fixture


class TestStretch:
    def test_posterior_recovery(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        s = StretchSampler(sources, signals, systs, [obs])
        ls = s(data, nsteps=1500, burnin_fraction=0.3, seed=5)
        bf = ls.get_best_fit()
        assert abs(bf["sig"].point_estimate - 1.0) < 0.3, bf["sig"]
        assert abs(bf["bkg"].point_estimate - 1.0) < 0.2, bf["bkg"]
        # Healthy ensemble acceptance (emcee-like fits sit ~0.2-0.7).
        assert 0.1 < s.last_accept_rate < 0.95

    def test_matches_metropolis_widths(self):
        """Stretch and Metropolis agree on the posterior width with NO
        jump-width tuning on the stretch side."""
        from sxmc_jax.mcmc.metropolis import MCMC

        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        s = StretchSampler(sources, signals, systs, [obs])
        ls_s = s(data, nsteps=2500, burnin_fraction=0.3, seed=5)
        m = MCMC(sources, signals, systs, [obs])
        ls_m = m(data, nsteps=20000, burnin_fraction=0.2, seed=5)
        std_s = ls_s.column("sig").std()
        std_m = ls_m.column("sig").std()
        assert abs(std_s - std_m) < 0.5 * std_m, (std_s, std_m)

    def test_fixed_parameter_pinned(self):
        obs, systs, sources, signals = make_fixture()
        sources[1].fixed = True
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        s = StretchSampler(sources, signals, systs, [obs])
        ls = s(data, nsteps=400, burnin_fraction=0.25, seed=5)
        np.testing.assert_array_equal(ls.column("bkg"), 1.0)

    def test_debug_mode_accepts_everything(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        s = StretchSampler(sources, signals, systs, [obs])
        s(data, nsteps=100, burnin_fraction=0.0, debug_mode=True, seed=5)
        assert s.last_accept_rate == 1.0

    def test_multi_ensemble_vmap(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        s = StretchSampler(sources, signals, systs, [obs], nwalkers=8)
        ls = s(data, nsteps=300, burnin_fraction=0.3, seed=5, nchains=3)
        # 3 ensembles x 8 walkers x 210 kept steps.
        assert ls.samples.shape == (3 * 8 * 210, s.nparameters)

    def test_floating_systematic(self):
        obs, systs, sources, signals = make_fixture(with_systematic=True)
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        s = StretchSampler(sources, signals, systs, [obs])
        ls = s(data, nsteps=1200, burnin_fraction=0.3, seed=5)
        bf = ls.get_best_fit()
        assert abs(bf["energy_shift_0"].point_estimate) < 0.1
