"""Pull/bias studies: batched toy validation of the gradient MLE."""

import jax
import numpy as np
import pytest

from sxmc_jax.signal import Observable, Signal, Source
from sxmc_jax.stats.bias import PullStudy, pull_study
from sxmc_jax.stats.mle import MLE


@pytest.fixture(scope="module")
def model():
    """Two unconstrained rates: pulls must be ~N(0, 1)."""
    rng = np.random.default_rng(11)
    obs = Observable(name="energy", field="energy", bins=20, lower=5.0,
                     upper=15.0, field_index=0)
    sig_mc = rng.normal(10, 1, (20000, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (20000, 1)).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0, sigma=0.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.0)
    fields = ["energy", "DATASET"]
    sig = Signal.from_table("sig", "S", sig_mc, ["energy"], 0, src_s,
                            200.0, fields, [obs], [], [])
    bkg = Signal.from_table("bkg", "B", bkg_mc, ["energy"], 0, src_b,
                            400.0, fields, [obs], [], [])
    return obs, [src_s, src_b], [sig, bkg]


class TestPullStudy:
    @pytest.fixture(scope="class")
    def study(self, model):
        obs, sources, signals = model
        mle = MLE(sources, signals, [], [obs])
        return pull_study(mle, 300, jax.random.PRNGKey(2), cl=0.683)

    def test_shapes_and_names(self, study):
        assert study.names == ["sig", "bkg"]
        assert study.estimates.shape == (300, 2)
        assert study.errors.shape == (300, 2)
        assert study.pulls.shape == (300, 2)

    def test_unbiased(self, study):
        """Pull mean compatible with 0 at ~4/sqrt(ntoys)."""
        s = study.summary()
        for name in study.names:
            assert abs(s[name]["pull_mean"]) < 4.0 / np.sqrt(
                s[name]["n_used"]) + 0.05, (name, s[name])

    def test_pull_width_near_unity(self, study):
        s = study.summary()
        for name in study.names:
            assert 0.8 < s[name]["pull_std"] < 1.25, (name, s[name])

    def test_coverage_near_cl(self, study):
        s = study.summary()
        for name in study.names:
            assert 0.58 < s[name]["coverage"] < 0.78, (name, s[name])

    def test_str_table(self, study):
        text = str(study)
        assert "Pull study" in text
        assert "sig" in text and "bkg" in text

    def test_rates_override(self, model):
        """Generating at a different true rate shifts the estimates."""
        obs, sources, signals = model
        mle = MLE(sources, signals, [], [obs])
        ps = pull_study(mle, 60, jax.random.PRNGKey(5),
                        rates={"sig": 2.0})
        assert ps.true_rates[0] == 2.0
        # r-hat distribution centered near the injected 2.0
        assert abs(np.median(ps.estimates[:, 0]) - 2.0) < 0.4
        s = ps.summary()
        assert abs(s["sig"]["pull_mean"]) < 0.6


class TestCLIBias:
    def test_bias_flag(self, tmp_path, capsys):
        """--bias-study runs the pull study and writes the JSON."""
        import json

        rng = np.random.default_rng(3)
        mc = rng.normal(10, 1, 5000).astype(np.float32)
        np.savez(tmp_path / "sig.npz", energy=mc)
        bkg = rng.uniform(5, 15, 5000).astype(np.float32)
        np.savez(tmp_path / "bkg.npz", energy=bkg)
        conf = {
            "fit": {"nexperiments": 1, "nsteps": 400,
                    "burnin_fraction": 0.2, "signal_name": "signal1",
                    "output_prefix": "lspace",
                    "signals": ["signal1", "bkg1"],
                    "observables": ["energy"], "plots": False},
            "pdfs": {"observables": {
                "energy": {"title": "E", "field": "energy", "bins": 15,
                           "min": 5.0, "max": 15.0}},
                "systematics": {}},
            "signals": {
                "signal1": {"title": "S", "dataset": 0, "filename":
                            str(tmp_path / "sig.npz"), "rate": 100.0},
                "bkg1": {"title": "B", "dataset": 0, "filename":
                         str(tmp_path / "bkg.npz"), "rate": 300.0}},
        }
        cfg = tmp_path / "fit.json"
        cfg.write_text(json.dumps(conf))
        outdir = tmp_path / "out"

        from sxmc_jax.cli import main
        assert main([str(cfg), str(outdir), "--sampler", "mle",
                     "--bias-study", "40"]) == 0
        out = capsys.readouterr().out
        assert "Pull study" in out
        pf = outdir / "lspace_pulls.json"
        assert pf.exists()
        res = json.loads(pf.read_text())
        assert res["ntoys"] == 40
        assert set(res["summary"]) == {"signal1", "bkg1"}
        for s in res["summary"].values():
            assert s["n_used"] > 0


class TestPullPlot:
    def test_plot_pulls_writes_file(self, model, tmp_path):
        obs, sources, signals = model
        mle = MLE(sources, signals, [], [obs])
        ps = pull_study(mle, 40, jax.random.PRNGKey(9))
        from sxmc_jax.plots import plot_pulls

        out = tmp_path / "pulls.png"
        plot_pulls(ps, str(out))
        assert out.exists() and out.stat().st_size > 0
