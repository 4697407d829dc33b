"""Tests for the KDE evaluator, chain checkpointing, observability."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sxmc_jax.pdf.evalkde import EvalKDE
from sxmc_jax.ops.transforms import SHIFT, SystematicDesc
from sxmc_jax import checkpoint
from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.observability import MetricsLogger, Stopwatch, plot_traces
from tests.test_mcmc import make_fixture


class TestEvalKDE:
    def test_density_integrates_to_one(self):
        rng = np.random.default_rng(0)
        samples = rng.normal(0.5, 0.15, (5000, 1)).astype(np.float32)
        kde = EvalKDE(samples, 1, 1, [0.0], [1.0])
        xs = np.linspace(0.0, 0.9999, 400)
        pts = np.stack([xs, np.zeros_like(xs)], axis=1)
        dens, norm = kde.eval_points(pts)
        dens = np.asarray(dens)
        assert np.isfinite(dens).all()
        integral = np.trapezoid(dens, xs)
        np.testing.assert_allclose(integral, 1.0, atol=0.01)
        assert float(norm) == ((samples >= 0) & (samples < 1)).sum()

    def test_matches_true_density(self):
        rng = np.random.default_rng(1)
        samples = rng.uniform(0, 1, (20000, 1)).astype(np.float32)
        kde = EvalKDE(samples, 1, 1, [0.0], [1.0])
        pts = np.array([[0.3, 0], [0.5, 0], [0.7, 0]], np.float32)
        dens, _ = kde.eval_points(pts)
        np.testing.assert_allclose(np.asarray(dens), 1.0, rtol=0.1)

    def test_sentinels(self):
        samples = np.full((100, 1), 0.5, np.float32)
        kde = EvalKDE(samples, 1, 1, [0.0], [1.0], dataset=2)
        pts = np.array([[-0.5, 2], [0.5, 0], [0.5, 2]], np.float32)
        dens, _ = kde.eval_points(pts)
        dens = np.asarray(dens)
        assert np.isnan(dens[0])       # out of domain
        assert dens[1] == 0.0          # dataset mismatch
        assert dens[2] > 0             # valid

    def test_systematic_shifts_density(self):
        rng = np.random.default_rng(2)
        samples = rng.normal(0.5, 0.1, (5000, 1)).astype(np.float32)
        kde = EvalKDE(samples, 1, 1, [0.0], [1.0])
        kde.add_systematic(SystematicDesc(SHIFT, obs=0, par_indices=(0,)))
        pts = np.array([[0.7, 0]], np.float32)
        d0, _ = kde.eval_points(pts, params=[0.0])
        d1, _ = kde.eval_points(pts, params=[0.2])
        assert float(d1[0]) > float(d0[0])

    def test_bandwidth_scale_validation(self):
        with pytest.raises(Exception):
            EvalKDE(np.zeros((10, 1), np.float32), 1, 1, [0.0], [1.0],
                    bandwidth_scale=[1.0, 1.0])


class TestCheckpoint:
    def test_resume_reproduces_uninterrupted_run(self, tmp_path):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])

        # Uninterrupted run.
        p1 = str(tmp_path / "a.npz")
        ls1 = checkpoint.run_checkpointed(
            mcmc, data, nsteps=600, burnin_fraction=0.2,
            segment_steps=10000, checkpoint_path=p1, seed=7)

        # Interrupted run: small segments; kill after a few, resume.
        p2 = str(tmp_path / "b.npz")
        checkpoint.run_checkpointed(
            mcmc, data, nsteps=300, burnin_fraction=0.4,
            segment_steps=50, checkpoint_path=p2, seed=7)
        # Same total via resume on the *same* checkpoint with more steps
        st = checkpoint.load_chain_state(p2)
        assert int(st["step"]) == 300
        ls2 = checkpoint.run_checkpointed(
            mcmc, data, nsteps=600, burnin_fraction=0.2,
            segment_steps=50, checkpoint_path=p2, seed=7)
        # Identical RNG stream per segment is not guaranteed between
        # different segmentations, but the posterior must agree.
        m1, m2 = ls1.column("sig").mean(), ls2.column("sig").mean()
        s1 = ls1.column("sig").std()
        assert abs(m1 - m2) < 5 * s1

    def test_hmc_resume_reproduces_uninterrupted_run(self, tmp_path):
        from sxmc_jax.mcmc.hmc import HMC

        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        hmc = HMC(sources, signals, systs, [obs], num_leapfrog=4)

        p1 = str(tmp_path / "h1.npz")
        ls1 = checkpoint.run_checkpointed_hmc(
            hmc, data, nsteps=400, burnin_fraction=0.25,
            segment_steps=10000, checkpoint_path=p1, seed=3)

        # Interrupted: stop mid-sampling (same warmup=100 boundary),
        # then resume to the full length on the same checkpoint.
        p2 = str(tmp_path / "h2.npz")
        checkpoint.run_checkpointed_hmc(
            hmc, data, nsteps=160, burnin_fraction=0.625,
            segment_steps=40, checkpoint_path=p2, seed=3)
        st = checkpoint.load_chain_state(p2)
        assert int(st["step"]) == 160
        assert float(st["eps"]) > 0  # warmup finished, step size set
        ls2 = checkpoint.run_checkpointed_hmc(
            hmc, data, nsteps=400, burnin_fraction=0.25,
            segment_steps=40, checkpoint_path=p2, seed=3)
        assert ls2.samples.shape[0] == 300
        m1 = ls1.column("sig").mean()
        m2 = ls2.column("sig").mean()
        s1 = max(ls1.column("sig").std(), 1e-3)
        assert abs(m1 - m2) < 6 * s1
        assert np.isfinite(ls2.nll_values).all()

    def test_nuts_checkpoint_resume(self, tmp_path):
        from sxmc_jax.mcmc.nuts import NUTS

        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        nuts = NUTS(sources, signals, systs, [obs], max_depth=3)

        p = str(tmp_path / "n1.npz")
        checkpoint.run_checkpointed_hmc(
            nuts, data, nsteps=120, burnin_fraction=0.5,
            segment_steps=30, checkpoint_path=p, seed=5)
        st = checkpoint.load_chain_state(p)
        assert int(st["step"]) == 120
        ls = checkpoint.run_checkpointed_hmc(
            nuts, data, nsteps=240, burnin_fraction=0.25,
            segment_steps=30, checkpoint_path=p, seed=5)
        assert ls.samples.shape[0] == 180
        assert np.isfinite(ls.nll_values).all()

    def test_stretch_checkpoint_resume(self, tmp_path):
        from sxmc_jax.mcmc.stretch import StretchSampler

        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        s = StretchSampler(sources, signals, systs, [obs], nwalkers=8)

        # Uninterrupted reference run.
        p1 = str(tmp_path / "w1.npz")
        ls1 = checkpoint.run_checkpointed_stretch(
            s, data, nsteps=300, burnin_fraction=0.2,
            segment_steps=10000, checkpoint_path=p1, seed=9)
        assert ls1.samples.shape[0] == 240 * s.nwalkers

        # Kill mid-run, resume on the same checkpoint.
        p2 = str(tmp_path / "w2.npz")
        checkpoint.run_checkpointed_stretch(
            s, data, nsteps=120, burnin_fraction=0.5,
            segment_steps=40, checkpoint_path=p2, seed=9)
        st = checkpoint.load_chain_state(p2)
        assert int(st["step"]) == 120
        ls2 = checkpoint.run_checkpointed_stretch(
            s, data, nsteps=300, burnin_fraction=0.2,
            segment_steps=40, checkpoint_path=p2, seed=9)
        assert np.isfinite(ls2.nll_values).all()
        m1, m2 = ls1.column("sig").mean(), ls2.column("sig").mean()
        s1 = max(ls1.column("sig").std(), 1e-3)
        assert abs(m1 - m2) < 6 * s1

    def test_state_roundtrip(self, tmp_path):
        p = str(tmp_path / "s.npz")
        state = {"params": np.arange(3, dtype=np.float32),
                 "step": np.int64(42)}
        checkpoint.save_chain_state(p, state)
        got = checkpoint.load_chain_state(p)
        assert int(got["step"]) == 42
        np.testing.assert_array_equal(got["params"], state["params"])
        assert checkpoint.load_chain_state(str(tmp_path / "no.npz")) is None


class TestObservability:
    def test_metrics_logger(self, tmp_path):
        path = str(tmp_path / "metrics.jsonl")
        log = MetricsLogger(path)
        log.log("step_batch", step=100, accept_rate=0.31)
        log.log("fit_done", nll=-12.5)
        assert len(log.records) == 2
        lines = open(path).read().strip().split("\n")
        assert len(lines) == 2
        assert '"event": "step_batch"' in lines[0]

    def test_stopwatch(self):
        sw = Stopwatch()
        assert sw.real_time() >= 0

    def test_plot_traces(self, tmp_path):
        from sxmc_jax.stats.likelihood import LikelihoodSpace

        rng = np.random.default_rng(0)
        ls = LikelihoodSpace(rng.normal(size=(500, 2)).astype(np.float32),
                             rng.normal(size=500).astype(np.float32),
                             ["a", "b"])
        out = plot_traces(ls, str(tmp_path))
        assert os.path.exists(out)

    def test_plot_cls_scan(self, tmp_path):
        from sxmc_jax.plots import plot_cls_scan

        grid = np.linspace(0.05, 1.0, 9)
        cls_vals = np.array([1.0, 0.82, 0.4, 0.12, 0.053, 0.02,
                             0.006, 0.001, 0.0])
        out = str(tmp_path / "cls.png")
        plot_cls_scan(grid, cls_vals, 0.41, 0.95, out, signal_name="sig",
                      expected={0.16: 0.16, 0.5: 0.40, 0.84: 0.50})
        assert os.path.exists(out)
        # Without a band dict (no --hypotest-band).
        out2 = str(tmp_path / "cls2.png")
        plot_cls_scan(grid, cls_vals, 0.41, 0.95, out2)
        assert os.path.exists(out2)


class TestPosterior2DPlot:
    def test_writes_file_and_contours(self, tmp_path):
        from sxmc_jax.plots import plot_posterior2d
        from sxmc_jax.stats.likelihood import LikelihoodSpace

        rng = np.random.default_rng(0)
        n = 20000
        a = rng.normal(1.0, 0.1, n)
        b = rng.normal(2.0, 0.2, n) + 0.5 * (a - 1.0)
        nll = 0.5 * (((a - 1) / 0.1) ** 2 + ((b - 2) / 0.2) ** 2)
        ls = LikelihoodSpace(np.stack([a, b], axis=1), nll, ["a", "b"])
        out = tmp_path / "post2d.png"
        plot_posterior2d(ls, "a", "b", str(out))
        assert out.exists() and out.stat().st_size > 0
