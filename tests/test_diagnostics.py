"""Diagnostics tests + rigorous posterior validation against numerical
integration (evidence the samplers target the exact posterior)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sxmc_jax.ops.nll import NLLStatic, nll
from sxmc_jax.stats.diagnostics import ess, split_rhat, summarize
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.mcmc.nuts import NUTS
from sxmc_jax.signal import Observable, Signal, Source


class TestDiagnostics:
    def test_rhat_converged(self):
        rng = np.random.default_rng(0)
        chains = rng.normal(0, 1, (4, 4000))
        assert abs(split_rhat(chains) - 1.0) < 0.02

    def test_rhat_diverged(self):
        rng = np.random.default_rng(0)
        chains = rng.normal(0, 1, (4, 4000))
        chains[0] += 5.0  # one stuck chain
        assert split_rhat(chains) > 1.5

    def test_ess_iid_vs_correlated(self):
        rng = np.random.default_rng(1)
        iid = rng.normal(size=20000)
        assert ess(iid) > 10000
        # AR(1) with rho=0.95 -> ESS ~ n*(1-rho)/(1+rho) ~ n/39
        ar = np.empty(20000)
        ar[0] = 0
        noise = rng.normal(size=20000)
        for i in range(1, 20000):
            ar[i] = 0.95 * ar[i - 1] + noise[i]
        assert ess(ar) < 2000

    def test_summarize(self):
        rng = np.random.default_rng(2)
        s = rng.normal(size=(8000, 2))
        out = summarize(s, ["a", "b"], nchains=4)
        assert set(out) == {"a", "b"}
        assert abs(out["a"]["rhat"] - 1.0) < 0.05


class TestPosteriorExactness:
    """Compare MCMC posterior moments against brute-force numerical
    integration of exp(-NLL) for a 1-parameter model."""

    def make_problem(self):
        rng = np.random.default_rng(7)
        obs = Observable(name="x", field="x", bins=10, lower=0.0,
                         upper=1.0, field_index=0)
        mc = rng.uniform(0, 1, (50000, 1)).astype(np.float32)
        src = Source(name="r", index=0, mean=1.0, sigma=0.0)
        sig = Signal.from_table("r", "R", mc, ["x"], 0, src, 100.0,
                                ["x", "DATASET"], [obs], [], [])
        data_x = rng.uniform(0, 1, 80).astype(np.float32)
        data = np.stack([data_x, np.zeros_like(data_x)], axis=1)
        return obs, src, sig, data

    def grid_posterior(self, mcmc, data):
        mcmc.stack.set_data(data)
        rs = np.linspace(1e-3, 3.0, 4000)
        lut, norms = mcmc.stack.evaluate(jnp.zeros(0, jnp.float32))
        nlls = np.array([
            float(nll(jnp.array([r], jnp.float32), lut, norms,
                      mcmc.static)) for r in rs[::40]])
        # Fine grid via interpolation of the (smooth) NLL.
        nll_fine = np.interp(rs, rs[::40], nlls)
        w = np.exp(-(nll_fine - nll_fine.min()))
        w /= np.trapezoid(w, rs)
        mean = np.trapezoid(rs * w, rs)
        var = np.trapezoid((rs - mean) ** 2 * w, rs)
        return mean, np.sqrt(var)

    def test_metropolis_matches_grid(self):
        obs, src, sig, data = self.make_problem()
        mcmc = MCMC([src], [sig], [], [obs])
        g_mean, g_std = self.grid_posterior(mcmc, data)

        ls = mcmc(data, nsteps=40000, burnin_fraction=0.2, seed=4)
        m = ls.column("r").mean()
        s = ls.column("r").std()
        n_eff = ess(ls.column("r"))
        assert abs(m - g_mean) < 5 * g_std / np.sqrt(max(n_eff, 10)), \
            (m, g_mean, g_std, n_eff)
        assert abs(s - g_std) / g_std < 0.15, (s, g_std)

    def test_nuts_matches_grid(self):
        obs, src, sig, data = self.make_problem()
        nuts = NUTS([src], [sig], [], [obs], max_depth=6)
        g_mean, g_std = self.grid_posterior(nuts, data)

        ls = nuts(data, nsteps=3000, burnin_fraction=0.3, seed=4)
        m = ls.column("r").mean()
        s = ls.column("r").std()
        n_eff = ess(ls.column("r"))
        assert abs(m - g_mean) < 5 * g_std / np.sqrt(max(n_eff, 10)), \
            (m, g_mean, g_std, n_eff)
        assert abs(s - g_std) / g_std < 0.15, (s, g_std)
