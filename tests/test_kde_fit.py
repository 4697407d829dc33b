"""KDE-backed signals in full fits.

The reference declared pdfz::EvalKernel and never implemented it
(pdfz.h:590-625); here KDE signals participate in fits end-to-end: the
density is represented as pseudo-counts on the bin grid, so the batched
LUT/NLL/sampler machinery is unchanged.
"""

import numpy as np
import jax
import pytest

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.pdf.evalkde import EvalKDE
from sxmc_jax.pdf.stack import PdfStack
from sxmc_jax.signal import Observable, Signal, Source
from sxmc_jax.stats.mle import MLE


def make_kde_fixture(n_mc=4000, seed=1):
    """Gaussian signal with few MC samples (where KDE shines) + flat
    background with plenty."""
    rng = np.random.default_rng(seed)
    obs = Observable(name="energy", field="energy", bins=25, lower=5.0,
                     upper=15.0, field_index=0)
    fields = ["energy", "DATASET"]
    sig_mc = rng.normal(10, 1, (n_mc, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (40000, 1)).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0, sigma=0.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    sig = Signal.from_table("sig", "S", sig_mc, ["energy"], 0, src_s,
                            200.0, fields, [obs], [], [], kde=True)
    bkg = Signal.from_table("bkg", "B", bkg_mc, ["energy"], 0, src_b,
                            400.0, fields, [obs], [], [])
    return obs, [src_s, src_b], [sig, bkg]


class TestKDEGrid:
    def test_signal_builds_evalkde(self):
        obs, sources, signals = make_kde_fixture()
        assert isinstance(signals[0].histogram, EvalKDE)
        assert not isinstance(signals[1].histogram, EvalKDE)

    def test_pseudo_counts_integrate_to_norm(self):
        obs, sources, signals = make_kde_fixture()
        kde = signals[0].histogram
        counts, norm = kde.histogram(np.zeros(0, np.float32))
        counts = np.asarray(counts)
        # All MC in [5,15) except Gaussian tails; counts sum ~ norm.
        assert abs(counts.sum() - float(norm)) < 0.02 * float(norm)
        # Smooth: neighboring-bin jumps bounded by the true Gaussian
        # flank slope (~0.24/bin at this binning), not shot noise.
        rel = np.abs(np.diff(counts)) / counts.max()
        assert rel.max() < 0.3

    def test_stack_overrides_kde_row(self):
        obs, sources, signals = make_kde_fixture()
        stack = PdfStack(signals, [obs], [])
        assert stack.has_kde
        hists, norms = stack.histograms(np.zeros(0, np.float32))
        hists = np.asarray(hists)
        direct, nrm = signals[0].histogram.histogram(
            np.zeros(0, np.float32))
        np.testing.assert_allclose(hists[0], np.asarray(direct),
                                   rtol=1e-5)
        assert abs(float(norms[0]) - float(nrm)) < 1e-3
        # The binned row (bkg) is untouched.
        assert float(norms[1]) == 40000.0

    def test_density_smoother_than_histogram(self):
        """KDE pseudo-density has lower shot noise than the histogram of
        the same few samples (the reason EvalKernel was planned)."""
        rng = np.random.default_rng(9)
        obs = Observable(name="x", field="x", bins=40, lower=-4.0,
                         upper=4.0, field_index=0)
        mc = rng.normal(0, 1, (800, 1)).astype(np.float32)
        fields = ["x", "DATASET"]
        src = Source(name="s", index=0)
        s_kde = Signal.from_table("s", "S", mc, ["x"], 0, src, 10.0,
                                  fields, [obs], [], [], kde=True)
        s_hist = Signal.from_table("s", "S", mc, ["x"], 0, src, 10.0,
                                   fields, [obs], [], [])
        edges = np.linspace(-4, 4, 41)
        centers = 0.5 * (edges[:-1] + edges[1:])
        truth = np.exp(-0.5 * centers**2) / np.sqrt(2 * np.pi)
        dk = np.asarray(s_kde.histogram.density_histogram(None)).ravel()
        dh = np.asarray(s_hist.histogram.density_histogram(None)).ravel()
        err_k = np.abs(dk - truth).mean()
        err_h = np.abs(dh - truth).mean()
        assert err_k < err_h, (err_k, err_h)


class TestKDEFit:
    def test_mcmc_recovers_rates(self):
        obs, sources, signals = make_kde_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, [],
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, [], [obs])
        ls = mcmc(data, nsteps=8000, burnin_fraction=0.2, seed=5)
        bf = ls.get_best_fit()
        assert abs(bf["sig"].point_estimate - 1.0) < 0.3, bf["sig"]
        assert abs(bf["bkg"].point_estimate - 1.0) < 0.2, bf["bkg"]

    def test_mle_with_kde_signal(self):
        obs, sources, signals = make_kde_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, [],
                                 [obs], poisson=False)
        mle = MLE(sources, signals, [], [obs])
        res = mle.fit(data)
        assert res.converged
        assert abs(res.value("sig") - 1.0) < 0.3

    def test_kde_with_floating_systematic(self):
        from sxmc_jax.signal import Systematic

        rng = np.random.default_rng(3)
        obs = Observable(name="energy", field="energy", bins=25,
                         lower=5.0, upper=15.0, field_index=0)
        syst = Systematic(name="shift", type=0, observable_field="energy",
                          means=[0.0], sigmas=[0.05],
                          observable_field_index=0, pidx=[0])
        fields = ["energy", "DATASET"]
        mc = rng.normal(10, 1, (3000, 1)).astype(np.float32)
        src = Source(name="s", index=0, mean=1.0, sigma=0.0)
        sig = Signal.from_table("s", "S", mc, ["energy"], 0, src, 300.0,
                                fields, [obs], [], [syst], kde=True)
        # The KDE density must move under the shift parameter.
        d0, _ = sig.histogram.histogram(np.array([0.0], np.float32))
        d1, _ = sig.histogram.histogram(np.array([0.5], np.float32))
        d0, d1 = np.asarray(d0), np.asarray(d1)
        assert np.argmax(d1) > np.argmax(d0)
        data = make_fake_dataset(jax.random.PRNGKey(4), [sig], [syst],
                                 [obs], poisson=False)
        mcmc = MCMC([src], [sig], [syst], [obs])
        ls = mcmc(data, nsteps=3000, burnin_fraction=0.2, seed=5)
        bf = ls.get_best_fit()
        assert abs(bf["shift_0"].point_estimate) < 0.1

    def test_sharded_chain_rejects_kde(self):
        from sxmc_jax.parallel.chain_sharded import run_sharded_chain

        obs, sources, signals = make_kde_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, [],
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, [], [obs])
        with pytest.raises(NotImplementedError):
            run_sharded_chain(mcmc, data, 100)


class TestKDEExact:
    """exact_lut=True: fits evaluate the KDE at the true event
    coordinates, removing the bin-grid discretization bias entirely."""

    def _fixture(self, with_syst=False, n_mc=2000, seed=2):
        from sxmc_jax.signal import Systematic

        rng = np.random.default_rng(seed)
        obs = Observable(name="energy", field="energy", bins=25,
                         lower=5.0, upper=15.0, field_index=0)
        fields = ["energy", "DATASET"]
        systs = []
        sig_systs = []
        if with_syst:
            systs = [Systematic(name="shift", type=0,
                                observable_field="energy",
                                means=[0.0], sigmas=[0.05],
                                observable_field_index=0, pidx=[0])]
            sig_systs = systs
        sig_mc = rng.normal(10, 1, (n_mc, 1)).astype(np.float32)
        bkg_mc = rng.uniform(5, 15, (20000, 1)).astype(np.float32)
        src_s = Source(name="sig", index=0, mean=1.0, sigma=0.0)
        src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
        sig = Signal.from_table("sig", "S", sig_mc, ["energy"], 0,
                                src_s, 200.0, fields, [obs], [],
                                sig_systs, kde=True, kde_exact=True)
        bkg = Signal.from_table("bkg", "B", bkg_mc, ["energy"], 0,
                                src_b, 400.0, fields, [obs], [], [])
        return obs, systs, [src_s, src_b], [sig, bkg]

    def test_exact_row_matches_eval_points(self):
        obs, systs, sources, signals = self._fixture()
        stack = PdfStack(signals, [obs], systs)
        assert stack._kde_exact
        rng = np.random.default_rng(7)
        data = np.stack([rng.uniform(5, 15, 300).astype(np.float32),
                         np.zeros(300, np.float32)], axis=1)
        stack.set_data(data)
        import jax.numpy as jnp

        theta = jnp.zeros(0, jnp.float32)
        lut, norms = stack.evaluate(theta, use_exact_kde=True)
        exact, nrm = signals[0].histogram.eval_points(data)
        np.testing.assert_allclose(np.asarray(lut[0]), np.asarray(exact),
                                   rtol=1e-5)
        assert float(norms[0]) == float(nrm)
        # The grid row is a (slightly) different approximation.
        lut_grid, _ = stack.evaluate(theta, use_exact_kde=False)
        diff = np.abs(np.asarray(lut[0]) - np.asarray(lut_grid[0]))
        assert diff.max() > 0  # override really happened

    def test_exact_row_with_systematic_tracks_theta(self):
        obs, systs, sources, signals = self._fixture(with_syst=True)
        stack = PdfStack(signals, [obs], systs)
        rng = np.random.default_rng(8)
        data = np.stack([rng.uniform(5, 15, 200).astype(np.float32),
                         np.zeros(200, np.float32)], axis=1)
        stack.set_data(data)
        import jax.numpy as jnp

        for tv in (0.0, 0.4):
            theta = jnp.asarray([tv], jnp.float32)
            lut, _ = stack.evaluate(theta, use_exact_kde=True)
            exact, _ = signals[0].histogram.eval_points(data, theta)
            np.testing.assert_allclose(np.asarray(lut[0]),
                                       np.asarray(exact), rtol=1e-5)

    def test_exact_batch_matches_single(self):
        obs, systs, sources, signals = self._fixture(with_syst=True)
        stack = PdfStack(signals, [obs], systs)
        rng = np.random.default_rng(9)
        data = np.stack([rng.uniform(5, 15, 150).astype(np.float32),
                         np.zeros(150, np.float32)], axis=1)
        stack.set_data(data)
        import jax.numpy as jnp

        thetas = jnp.asarray([[0.0], [0.3]], jnp.float32)
        lutb, normb = stack.evaluate_batch(thetas, use_exact_kde=True)
        for c in range(2):
            lut1, norm1 = stack.evaluate(thetas[c], use_exact_kde=True)
            np.testing.assert_allclose(np.asarray(lutb[c]),
                                       np.asarray(lut1), rtol=1e-5)
            np.testing.assert_allclose(np.asarray(normb[c]),
                                       np.asarray(norm1), rtol=1e-6)

    def test_mcmc_fit_with_exact_kde(self):
        obs, systs, sources, signals = self._fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, [],
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, [], [obs])
        ls = mcmc(data, nsteps=6000, burnin_fraction=0.2, seed=5)
        bf = ls.get_best_fit()
        assert abs(bf["sig"].point_estimate - 1.0) < 0.3, bf["sig"]
        assert abs(bf["bkg"].point_estimate - 1.0) < 0.2, bf["bkg"]

    def test_hmc_nuts_exact_kde_value_and_gradient(self):
        """HMC/NUTS on a kde_exact stack: the potential evaluates the
        KDE rows at event coordinates (use_exact_kde=True through
        _nll_backend) and its gradient flows through EvalKDE.eval_at —
        with a floating systematic the theta direction must carry a
        finite, NONZERO gradient (histogram rows are piecewise
        constant there; the smooth KDE row is what makes HMC move it).
        """
        import jax.numpy as jnp

        from sxmc_jax.mcmc.hmc import HMC, _make_hmc_fns

        obs, systs, sources, signals = self._fixture(with_syst=True)
        rng = np.random.default_rng(11)
        data = np.stack([rng.uniform(5, 15, 250).astype(np.float32),
                         np.zeros(250, np.float32)], axis=1)
        hmc = HMC(sources, signals, systs, [obs])
        hmc.stack.set_data(data)
        fns = _make_hmc_fns(hmc, hmc.stack._read_bins,
                            hmc.stack.device_data, 4, 0.8)
        # Value: matches the standalone exact-KDE NLL at the means
        # (modulo the log-rate Jacobian, which is 0 at rates == 1).
        U0 = float(fns.potential(fns.q0))
        ref = hmc.nll(data, hmc.parameter_means)
        assert np.isfinite(U0)
        assert abs(U0 - ref) < 1e-2 * max(abs(ref), 1.0), (U0, ref)
        g = np.asarray(jax.grad(fns.potential)(fns.q0))
        assert np.isfinite(g).all(), g
        # theta is the last parameter; exact-KDE density is smooth in
        # it, so the gradient there is nonzero.
        assert abs(g[-1]) > 0, g

    def test_parallel_ensemble_exact_kde(self):
        """kde_exact through the batched sharded ensemble (r5): each
        experiment pairs with its OWN event coordinates (padding rows
        carry the unknown-dataset tag, zeroed by eval_at's mismatch
        sentinel), and each per-experiment result matches a serial
        single-experiment fit on that experiment's dataset."""
        import jax
        import jax.numpy as jnp

        from sxmc_jax.fitconfig import FitConfig
        from sxmc_jax.generator import make_fake_dataset
        from sxmc_jax.mcmc import metropolis
        from sxmc_jax.parallel import ensemble as par_ensemble

        obs, systs, sources, signals = self._fixture()
        fc = FitConfig(
            nexperiments=2, nsteps=200, burnin_fraction=0.2,
            signal_name="sig", seed=7, signals=signals,
            sources=sources, systematics=systs, observables=[obs])
        lspaces, limits = par_ensemble.run_sharded_ensemble(
            fc, nsteps=200, verbose=False)
        assert len(limits) == 2
        assert np.isfinite(limits).all()
        # The two experiments saw different datasets.
        assert limits[0] != limits[1]

        # Cross-check experiment 0 against a serial fit with the
        # identical dataset, key derivation, and padded read bins.
        mcmc = metropolis.MCMC(fc.sources, fc.signals, fc.systematics,
                               fc.observables)
        key = jax.random.PRNGKey(fc.seed)
        datasets = [
            make_fake_dataset(jax.random.fold_in(key, i), fc.signals,
                              fc.systematics, fc.observables,
                              poisson=True, stack=mcmc.stack)
            for i in range(2)]
        batch = par_ensemble.pad_datasets(datasets)
        mcmc.stack.set_data(batch[0])
        chain_key = jax.random.split(
            jax.random.fold_in(key, 1000), 1)[0]
        s, nl, _ = metropolis._run_single_chain(
            mcmc, chain_key, mcmc.stack._read_bins,
            mcmc.stack.device_data, nsteps=200,
            burnin_steps=40, debug_mode=False)
        want = np.asarray(s)
        got = lspaces[0].samples
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_parallel_ensemble_exact_kde_checkpoint_refused(self,
                                                            tmp_path):
        from sxmc_jax.fitconfig import FitConfig
        from sxmc_jax.parallel import ensemble as par_ensemble

        obs, systs, sources, signals = self._fixture()
        fc = FitConfig(
            nexperiments=2, nsteps=100, signals=signals,
            sources=sources, systematics=systs, observables=[obs])
        with pytest.raises(NotImplementedError, match="kde_exact"):
            par_ensemble.run_sharded_ensemble(
                fc, nsteps=100, checkpoint_steps=20,
                checkpoint_path=str(tmp_path / "ck"))
