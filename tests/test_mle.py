"""Gradient MLE: closed-form recovery, Hessian errors, profiles, limits.

The reference has no optimizer at all (best fit = min-NLL MCMC sample,
likelihood.cpp:104-137); these tests validate the gradient tier against
exact Poisson counting results and against the samplers.
"""

import numpy as np
import jax
import pytest

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.signal import Observable, Signal, Source, Systematic
from sxmc_jax.stats.mle import MLE

from test_mcmc import make_fixture


def make_counting_fixture(nevents=400, nexpected=500.0):
    """One flat-PDF signal: a pure Poisson counting experiment.

    NLL(r) = r*E - n*log(r*E*p) + const with p the flat density, so
    r_hat = n/E exactly and sigma_r = r_hat/sqrt(n).
    """
    rng = np.random.default_rng(7)
    obs = Observable(name="x", field="x", bins=10, lower=0.0, upper=1.0,
                     field_index=0)
    mc = rng.uniform(0, 1, (50000, 1)).astype(np.float32)
    src = Source(name="sig", index=0, mean=1.0, sigma=0.0)
    sig = Signal.from_table("sig", "Signal", mc, ["x"], 0, src,
                            nexpected, ["x", "DATASET"], [obs], [], [])
    data = np.stack([rng.uniform(0, 1, nevents).astype(np.float32),
                     np.zeros(nevents, np.float32)], axis=1)
    return obs, [src], [sig], data


class TestCountingClosedForm:
    def test_rate_and_error(self):
        obs, sources, signals, data = make_counting_fixture()
        mle = MLE(sources, signals, [], [obs])
        res = mle.fit(data)
        n, e = len(data), signals[0].nexpected
        # Efficiency: all 50k MC samples in-domain -> eff = 1.
        rhat = n / e
        assert res.converged
        assert abs(res.value("sig") - rhat) < 1e-3 * rhat, res
        sigma = rhat / np.sqrt(n)
        assert abs(res.error("sig") - sigma) < 0.05 * sigma, res

    def test_profile_matches_hessian(self):
        obs, sources, signals, data = make_counting_fixture()
        mle = MLE(sources, signals, [], [obs])
        res = mle.fit(data)
        iv = mle.profile_interval("sig", cl=0.683)
        # Poisson with n=400 is very Gaussian: MINOS ~ Hessian.
        e = res.error("sig")
        assert abs((iv.upper - iv.point_estimate) - e) < 0.15 * e
        assert abs((iv.point_estimate - iv.lower) - e) < 0.15 * e
        assert abs(iv.point_estimate - res.value("sig")) < 0.2 * e

    def test_profile_curve_is_parabola(self):
        obs, sources, signals, data = make_counting_fixture()
        mle = MLE(sources, signals, [], [obs])
        res = mle.fit(data)
        rhat, e = res.value("sig"), res.error("sig")
        grid = np.linspace(rhat - 2 * e, rhat + 2 * e, 9)
        pnll = mle.profile("sig", grid)
        dn = pnll - pnll.min()
        expect = 0.5 * ((grid - rhat) / e) ** 2
        assert np.all(np.abs(dn - expect) < 0.2 + 0.1 * expect)


class TestTwoSignal:
    def test_matches_sampler(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mle = MLE(sources, signals, systs, [obs])
        res = mle.fit(data)
        assert res.converged
        assert abs(res.value("sig") - 1.0) < 0.3
        assert abs(res.value("bkg") - 1.0) < 0.2
        # Errors in the plausible statistical range.
        assert 0.02 < res.error("sig") < 0.5
        assert 0.01 < res.error("bkg") < 0.3

    def test_fixed_parameter_pinned(self):
        obs, systs, sources, signals = make_fixture()
        sources[1].fixed = True
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mle = MLE(sources, signals, systs, [obs])
        res = mle.fit(data)
        assert res.value("bkg") == 1.0
        assert not np.isfinite(res.error("bkg"))

    def test_intervals_export(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mle = MLE(sources, signals, systs, [obs])
        res = mle.fit(data)
        ivs = res.to_intervals(cl=0.683)
        assert set(ivs) == {"sig", "bkg"}
        assert ivs["sig"].lower < res.value("sig") < ivs["sig"].upper
        assert "+-" in str(res) or "+" in str(res)


class TestFloatingSystematic:
    def test_shift_profiled(self):
        obs, systs, sources, signals = make_fixture(with_systematic=True)
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mle = MLE(sources, signals, systs, [obs])
        res = mle.fit(data)
        assert res.converged
        # Truth shift is 0, constrained at 0 +- 0.05.
        assert abs(res.value("energy_shift_0")) < 0.1
        assert abs(res.value("sig") - 1.0) < 0.3
        # Profile over the systematic grid runs and is minimized near 0.
        grid = np.linspace(-0.1, 0.1, 11)
        pnll = mle.profile("energy_shift_0", grid, res)
        assert np.isfinite(pnll).all()
        assert abs(grid[int(np.argmin(pnll))]) <= 0.06


class TestSystProfilingAccuracy:
    def test_grid_descent_matches_dense_scan(self):
        """Quantify the coordinate-grid systematic descent
        (_fit_systematics): its optimum must land within 0.05 sigma of
        the TRUE constrained profile optimum from a dense brute-force
        scan (481 points over +-3 sigma, rates re-profiled per point).
        FC/hypotest inherit this optimizer, so this bounds their
        profiled-NLL bias too."""
        import jax.numpy as jnp

        from sxmc_jax.stats.mle import _profile_syst_grid

        obs, systs, sources, signals = make_fixture(
            with_systematic=True)
        data = make_fake_dataset(jax.random.PRNGKey(6), signals, systs,
                                 [obs], poisson=False)
        mle = MLE(sources, signals, systs, [obs])
        res = mle.fit(data)
        assert res.converged
        sigma = systs[0].sigmas[0]
        theta_hat = res.value("energy_shift_0")

        # Dense brute-force profile scan around the constraint.
        rb, dd, w = mle._last[1], mle._last[2], mle._last[3]
        q0 = mle._initial_q()
        theta0 = np.zeros(1, np.float32)
        dense = np.linspace(-3 * sigma, 3 * sigma, 481
                            ).astype(np.float32)
        pnll = np.asarray(_profile_syst_grid(
            mle, jnp.asarray(dense), 0, tuple(mle._free_rates),
            jnp.asarray(q0), jnp.asarray(theta0), rb, dd,
            mle.maxiter, w))
        theta_star = float(dense[int(np.argmin(pnll))])
        assert abs(theta_hat - theta_star) <= 0.05 * sigma, \
            (theta_hat, theta_star, sigma)


class TestUpperLimit:
    def test_null_signal_limit(self):
        """Background-only data: signal MLE ~ 0, finite upper limit."""
        rng = np.random.default_rng(11)
        obs = Observable(name="energy", field="energy", bins=20,
                         lower=5.0, upper=15.0, field_index=0)
        sig_mc = rng.normal(10, 1, (20000, 1)).astype(np.float32)
        bkg_mc = rng.uniform(5, 15, (20000, 1)).astype(np.float32)
        src_s = Source(name="sig", index=0, mean=0.5, sigma=0.0)
        src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
        fields = ["energy", "DATASET"]
        sig = Signal.from_table("sig", "S", sig_mc, ["energy"], 0, src_s,
                                100.0, fields, [obs], [], [])
        bkg = Signal.from_table("bkg", "B", bkg_mc, ["energy"], 0, src_b,
                                400.0, fields, [obs], [], [])
        # Data drawn from background only.
        n = 400
        data = np.stack([
            rng.uniform(5, 15, n).astype(np.float32),
            np.zeros(n, np.float32)], axis=1)
        mle = MLE([src_s, src_b], [sig, bkg], [], [obs])
        res = mle.fit(data)
        assert res.value("sig") < 0.2
        ul = mle.upper_limit("sig", cl=0.9)
        assert 0.0 < ul < 1.0
        # Tighter CL -> tighter limit.
        ul68 = mle.upper_limit("sig", cl=0.68)
        assert ul68 < ul


class TestProfile2D:
    def test_map_minimum_at_best_fit(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mle = MLE(sources, signals, systs, [obs])
        res = mle.fit(data)
        v1 = np.linspace(max(res.value("sig") - 3 * res.error("sig"),
                             0.01),
                         res.value("sig") + 3 * res.error("sig"), 9)
        v2 = np.linspace(max(res.value("bkg") - 3 * res.error("bkg"),
                             0.01),
                         res.value("bkg") + 3 * res.error("bkg"), 9)
        pnll = mle.profile2d("sig", "bkg", v1, v2, res)
        assert pnll.shape == (9, 9)
        # Grid minimum sits at the node nearest the best fit, and its
        # value is >= the unconditional minimum (profiling can't win).
        i, j = np.unravel_index(np.argmin(pnll), pnll.shape)
        assert abs(v1[i] - res.value("sig")) <= (v1[1] - v1[0]) + 1e-6
        assert abs(v2[j] - res.value("bkg")) <= (v2[1] - v2[0]) + 1e-6
        assert pnll.min() >= res.nll - 0.05

    def test_axis_min_matches_1d_profile(self):
        """min over one axis of the 2-D map == the 1-D profile (both
        re-optimize everything else)."""
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mle = MLE(sources, signals, [], [obs])
        res = mle.fit(data)
        v1 = np.linspace(0.5, 1.5, 5).astype(np.float32)
        v2 = np.linspace(0.5, 1.5, 21).astype(np.float32)
        pnll2 = mle.profile2d("sig", "bkg", v1, v2, res)
        pnll1 = mle.profile("sig", v1, res)
        # The dense-axis grid min is an upper bound on the continuous
        # profile (it cannot beat the optimizer), tight up to the grid
        # discretization ~ curvature * (step/2)^2.
        gap = pnll2.min(axis=1) - pnll1
        assert np.all(gap > -0.02), gap
        assert np.all(gap < 0.3), gap

    def test_rejects_duplicates(self):
        obs, systs, sources, signals = make_fixture(with_systematic=True)
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mle = MLE(sources, signals, systs, [obs])
        mle.fit(data)
        with pytest.raises(ValueError):
            mle.profile2d("sig", "sig", [1.0], [1.0])

    def test_contour_plot_writes_file(self, tmp_path):
        from sxmc_jax.plots import plot_profile2d
        from sxmc_jax.stats.mle import profile2d_contour_levels

        levels = profile2d_contour_levels((0.683, 0.95))
        assert levels[0] == pytest.approx(-np.log(1 - 0.683), abs=1e-9)
        assert levels[1] == pytest.approx(2.9957, abs=1e-3)
        v = np.linspace(-2, 2, 15)
        pnll = 0.5 * (v[:, None] ** 2 + v[None, :] ** 2)
        out = tmp_path / "c.png"
        plot_profile2d(v, v, pnll, str(out), "a", "b", best=(0.0, 0.0))
        assert out.exists() and out.stat().st_size > 0


class TestProfile2DRateSyst:
    def test_rate_syst_map(self):
        """(rate x systematic) 2-D profile: PDFs rebuilt per syst value,
        minimum near the best fit, syst-axis min tracks the 1-D syst
        profile."""
        obs, systs, sources, signals = make_fixture(with_systematic=True)
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mle = MLE(sources, signals, systs, [obs])
        res = mle.fit(data)
        v_rate = np.linspace(0.6, 1.4, 7).astype(np.float32)
        v_syst = np.linspace(-0.1, 0.1, 5).astype(np.float32)
        pnll = mle.profile2d("sig", "energy_shift_0", v_rate, v_syst,
                             res)
        assert pnll.shape == (7, 5)
        assert pnll.min() >= res.nll - 0.05
        # Transposed argument order gives the transposed map.
        pnll_t = mle.profile2d("energy_shift_0", "sig", v_syst, v_rate,
                               res)
        np.testing.assert_allclose(pnll_t, pnll.T, atol=1e-4)
        # Minimizing out the systematic axis approximates the 1-D rate
        # profile (grid min >= continuous profile).
        p1 = mle.profile("sig", v_rate, res)
        gap = pnll.min(axis=1) - p1
        assert np.all(gap > -0.1), gap

    def test_two_systematics_rejected(self):
        obs, systs, sources, signals = make_fixture(with_systematic=True)
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mle = MLE(sources, signals, systs, [obs])
        mle.fit(data)
        with pytest.raises(ValueError):
            mle.profile2d("energy_shift_0", "energy_shift_0",
                          [0.0], [0.0])
