"""End-to-end tests for the BASELINE.json benchmark configurations.

Covers: 2-D (energy x radius) fits with floating shift+scale
systematics, upper-limit extraction for a zero-rate signal, the
vmapped+sharded ensemble, and weighted-MC fits.
"""

import json

import numpy as np
import jax
import pytest

from sxmc_jax.fitconfig import FitConfig
from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.io import loaders
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.signal import Observable, Signal, Source, Systematic


@pytest.fixture
def mc_2d(tmp_path):
    rng = np.random.default_rng(21)
    n = 30000
    sig = np.stack([
        rng.normal(10, 1, n),
        np.clip(rng.normal(4, 2, n), 0, 9.999),
    ], axis=1).astype(np.float32)
    bkg = np.stack([
        rng.uniform(5, 15, n),
        rng.uniform(0, 10, n),
    ], axis=1).astype(np.float32)
    fields = ["energy", "radius"]
    loaders.write_float_table(str(tmp_path / "sig2d.npz"), sig, fields)
    loaders.write_float_table(str(tmp_path / "bkg2d.npz"), bkg, fields)
    return tmp_path


def config_2d(tmp_path, **fit_overrides):
    """2-D fit with shift + scale systematics floating."""
    conf = {
        "fit": {
            "nexperiments": 1, "nsteps": 6000, "burnin_fraction": 0.2,
            "signal_name": "sig", "signals": ["sig", "bkg"],
            "observables": ["energy", "radius"], "seed": 3,
            "plots": False,
        },
        "pdfs": {
            "observables": {
                "energy": {"title": "E", "field": "energy", "bins": 15,
                           "min": 5.0, "max": 15.0},
                "radius": {"title": "R", "field": "radius", "bins": 8,
                           "min": 0.0, "max": 10.0},
            },
            "systematics": {
                "energy_shift": {"title": "dE", "type": "shift",
                                 "observable_field": "energy",
                                 "mean": [0.0], "sigma": [0.05]},
                "radius_scale": {"title": "sR", "type": "scale",
                                 "observable_field": "radius",
                                 "mean": [0.0], "sigma": [0.01]},
            },
        },
        "signals": {
            "sig": {"title": "Sig",
                    "filename": str(tmp_path / "sig2d.npz"),
                    "dataset": 0,
                    "systematics": ["energy_shift", "radius_scale"],
                    "rate": 400.0},
            "bkg": {"title": "Bkg",
                    "filename": str(tmp_path / "bkg2d.npz"),
                    "dataset": 0,
                    "systematics": ["energy_shift", "radius_scale"],
                    "rate": 600.0},
        },
    }
    conf["fit"].update(fit_overrides)
    return conf


class Test2DFit:
    def test_2d_fit_recovers_rates(self, mc_2d):
        fc = FitConfig.from_dict(config_2d(mc_2d))
        assert fc.signals[0].histogram.total_nbins == 15 * 8
        data = make_fake_dataset(jax.random.PRNGKey(9), fc.signals,
                                 fc.systematics, fc.observables,
                                 poisson=False)
        assert data.shape[1] == 3  # energy, radius, DATASET
        mcmc = MCMC(fc.sources, fc.signals, fc.systematics,
                    fc.observables)
        ls = mcmc(data, 6000, 0.2, seed=4)
        bf = ls.get_best_fit()
        assert abs(bf["sig"].point_estimate - 1.0) < 0.3
        assert abs(bf["bkg"].point_estimate - 1.0) < 0.3
        assert abs(bf["energy_shift_0"].point_estimate) < 0.15
        assert abs(bf["radius_scale_0"].point_estimate) < 0.03

    def test_2d_bin_layout_row_major(self, mc_2d):
        fc = FitConfig.from_dict(config_2d(mc_2d))
        hist = fc.signals[0].histogram
        dens = hist.density_histogram()
        assert dens.shape == (15, 8)
        # Signal peaks near E=10 (bin 7 of 15) and R=4 (bin 3 of 8).
        imax = np.unravel_index(dens.argmax(), dens.shape)
        assert abs(imax[0] - 7) <= 1 and abs(imax[1] - 3) <= 1

    def test_density_projection(self, mc_2d):
        fc = FitConfig.from_dict(config_2d(mc_2d))
        hist = fc.signals[0].histogram
        proj = hist.density_projection(0)
        assert proj.shape == (15,)
        width = 10.0 / 15
        np.testing.assert_allclose(proj.sum() * width, 1.0, rtol=1e-5)
        with pytest.raises(Exception):
            hist.density_projection(5)


class TestUpperLimit:
    def test_zero_signal_gives_one_sided_limit(self):
        """Sensitivity mode: truth rate ~ 0 -> one-sided 90% CL limit
        via the projection estimator (projection.cpp:38-50)."""
        rng = np.random.default_rng(5)
        obs = Observable(name="energy", field="energy", bins=20,
                         lower=5.0, upper=15.0, field_index=0)
        sample_fields = ["energy", "DATASET"]
        sig_mc = rng.normal(10, 0.5, (20000, 1)).astype(np.float32)
        bkg_mc = rng.uniform(5, 15, (20000, 1)).astype(np.float32)
        src_s = Source(name="sig", index=0, mean=0.01, sigma=0.0)
        src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
        # nexpected for the signal is what 1 unit of rate would give.
        sig = Signal.from_table("sig", "S", sig_mc, ["energy"], 0, src_s,
                                50.0, sample_fields, [obs], [], [])
        bkg = Signal.from_table("bkg", "B", bkg_mc, ["energy"], 0, src_b,
                                500.0, sample_fields, [obs], [], [])
        # Background-only data.
        data_e = rng.uniform(5, 15, 500).astype(np.float32)
        data = np.stack([data_e, np.zeros_like(data_e)], axis=1)

        mcmc = MCMC([src_s, src_b], [sig, bkg], [], [obs])
        ls = mcmc(data, 20000, 0.2, seed=6)
        ls.cl = 0.9
        ls.error_type = "projection"
        bf = ls.get_best_fit()
        interval = bf["sig"]
        assert interval.one_sided, interval
        assert 0 < interval.upper < 1.0, interval
        assert interval.coverage >= 0.9


class TestShardedEnsembleE2E:
    def test_cli_sharded(self, mc_2d, tmp_path, capsys):
        conf = config_2d(mc_2d, nexperiments=4, nsteps=1500,
                         error_type="projection", confidence=0.9)
        cfg = tmp_path / "fit.json"
        cfg.write_text(json.dumps(conf))
        from sxmc_jax.cli import main

        assert main([str(cfg), str(tmp_path / "out"), "--sharded"]) == 0
        out = capsys.readouterr().out
        assert "Best fit" in out
        assert (tmp_path / "out" / "lspace_3.npz").exists()


class TestWeightedStack:
    def test_weighted_signal_changes_pdf(self):
        rng = np.random.default_rng(8)
        obs = Observable(name="x", field="x", bins=2, lower=0.0,
                         upper=1.0, field_index=0)
        samples = np.array([[0.25], [0.25], [0.75]], np.float32)
        src = Source(name="s", index=0)
        sig = Signal.from_table("s", "S", samples, ["x"], 0, src, 10.0,
                                ["x", "DATASET"], [obs], [], [])
        # Reweight the single high-bin sample by 2.
        sig.histogram.weights = np.array([1.0, 1.0, 2.0], np.float32)
        from sxmc_jax.pdf.stack import PdfStack

        stack = PdfStack([sig], [obs], [])
        assert stack.has_weights
        hists, norms = stack.histograms(np.zeros(0, np.float32))
        np.testing.assert_array_equal(np.asarray(hists)[0], [2.0, 2.0])
        assert float(norms[0]) == 4.0


class TestHMCSamplerCLI:
    def test_cli_hmc_sampler(self, mc_2d, tmp_path):
        conf = config_2d(mc_2d, nsteps=1200)
        # HMC path: fix the systematics so gradients drive everything.
        conf["pdfs"]["systematics"]["energy_shift"]["fixed"] = True
        conf["pdfs"]["systematics"]["radius_scale"]["fixed"] = True
        cfg = tmp_path / "fit.json"
        cfg.write_text(json.dumps(conf))
        from sxmc_jax.cli import main

        assert main([str(cfg), str(tmp_path / "out"),
                     "--sampler", "hmc"]) == 0
        assert (tmp_path / "out" / "lspace_0.npz").exists()


class TestMLESamplerCLI:
    def test_cli_mle(self, mc_2d, tmp_path, capsys):
        conf = config_2d(mc_2d, confidence=0.683)
        cfg = tmp_path / "fit.json"
        cfg.write_text(json.dumps(conf))
        from sxmc_jax.cli import main

        assert main([str(cfg), str(tmp_path / "out"),
                     "--sampler", "mle"]) == 0
        out = capsys.readouterr().out
        assert "MLE best fit" in out
        assert "Profile upper limit" in out
        mle_json = tmp_path / "out" / "lspace_mle_0.json"
        assert mle_json.exists()
        res = json.loads(mle_json.read_text())
        assert abs(res["params"]["sig"] - 1.0) < 0.3
        assert res["converged"]
        assert res["upper_limit"] > res["params"]["sig"]


class TestStretchSamplerCLI:
    def test_cli_stretch(self, mc_2d, tmp_path):
        conf = config_2d(mc_2d, nsteps=800, burnin_fraction=0.3)
        cfg = tmp_path / "fit.json"
        cfg.write_text(json.dumps(conf))
        from sxmc_jax.cli import main

        assert main([str(cfg), str(tmp_path / "out"),
                     "--sampler", "stretch"]) == 0
        assert (tmp_path / "out" / "lspace_0.npz").exists()
