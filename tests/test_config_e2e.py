"""Config-DSL parsing + end-to-end ensemble tests.

Exercises the JSON DSL semantics of reference src/config.cpp (systematics
union, implicit self-sources, rate-vs-scale, sample-field layout) and a
full fake-data ensemble through the CLI driver — coverage the reference
never had (SURVEY.md section 4).
"""

import json
import os

import numpy as np
import pytest

from sxmc_jax.fitconfig import FitConfig, strip_json_comments
from sxmc_jax.io import loaders


@pytest.fixture
def mc_files(tmp_path):
    rng = np.random.default_rng(11)
    n = 20000
    sig = np.stack([
        rng.normal(10, 1, n),        # energy
        rng.normal(10, 0.9, n),      # mc_energy (truth)
        rng.uniform(0, 10, n),       # radius
    ], axis=1).astype(np.float32)
    bkg = np.stack([
        rng.uniform(5, 15, n),
        rng.uniform(5, 15, n),
        rng.uniform(0, 10, n),
    ], axis=1).astype(np.float32)
    fields = ["energy", "mc_energy", "radius"]
    loaders.write_float_table(str(tmp_path / "signal1.npz"), sig, fields)
    loaders.write_float_table(str(tmp_path / "signal2.npz"), bkg, fields)
    return tmp_path


def example_config(tmp_path, **fit_overrides):
    """A config/example.json-compatible configuration."""
    config = {
        "fit": {
            "nexperiments": 1,
            "nsteps": 4000,
            "burnin_fraction": 0.2,
            "signal_name": "signal1",
            "signals": ["signal1", "signal2"],
            "observables": ["energy"],
            "cuts": ["radius"],
            "seed": 42,
            "plots": False,
        },
        "pdfs": {
            "observables": {
                "energy": {"title": "Energy (MeV)", "units": "MeV",
                           "field": "energy", "bins": 10, "min": 5.0,
                           "max": 15.0},
                "radius": {"title": "Radius (m)", "units": "m",
                           "field": "radius", "bins": 10, "min": 0.0,
                           "max": 10.0},
            },
            "systematics": {
                "energy_scale": {
                    "title": "Energy scale", "type": "scale",
                    "observable_field": "energy",
                    "mean": [0.0], "sigma": [1e-2]},
                "energy_resolution": {
                    "title": "Energy resolution", "type": "resolution_scale",
                    "observable_field": "energy",
                    "true_field": "mc_energy",
                    "truth_field": "mc_energy",
                    "mean": [0.0], "sigma": [1e-3]},
            },
        },
        "signals": {
            "signal1": {
                "title": "Signal 1",
                "filename": str(tmp_path / "signal1.npz"),
                "dataset": 0,
                "systematics": ["energy_scale", "energy_resolution"],
                "scale": 500.0,
                "sigma": 0.05,
            },
            "signal2": {
                "title": "Signal 2",
                "filename": str(tmp_path / "signal2.npz"),
                "dataset": 0,
                "systematics": ["energy_scale", "energy_resolution"],
                "scale": 100.0,
            },
        },
    }
    config["fit"].update(fit_overrides)
    return config


class TestConfigParsing:
    def test_comment_stripping(self):
        text = '{"a": 1, // comment\n "b": "x//y" /* block */ }'
        assert json.loads(strip_json_comments(text)) == \
            {"a": 1, "b": "x//y"}

    def test_output_file_alias(self, mc_files):
        """The reference's example.json says "output_file" where
        config.cpp:67 reads "output_prefix" — accept both."""
        conf = example_config(mc_files)
        conf["fit"]["output_file"] = "myfit"
        assert FitConfig.from_dict(conf).output_prefix == "myfit"
        conf["fit"]["output_prefix"] = "wins"
        assert FitConfig.from_dict(conf).output_prefix == "wins"

    def test_example_config(self, mc_files):
        fc = FitConfig.from_dict(example_config(mc_files))
        assert fc.nexperiments == 1
        assert [o.name for o in fc.observables] == ["energy"]
        assert [c.name for c in fc.cuts] == ["radius"]
        # Systematics union with global param indices (config.cpp:94-123).
        assert [s.name for s in fc.systematics] == \
            ["energy_scale", "energy_resolution"]
        assert fc.systematics[0].pidx == [0]
        assert fc.systematics[1].pidx == [1]
        # Implicit self-sources with signal-level mean/sigma
        # (config.cpp:142-150).
        assert [s.name for s in fc.sources] == ["signal1", "signal2"]
        assert fc.sources[0].sigma == pytest.approx(0.05)
        # Sample-field layout: observables, truth fields, DATASET
        # (config.cpp:153-194).
        assert fc.sample_fields == ["energy", "mc_energy", "DATASET"]
        # scale=500 -> nexpected = n_mc / 500 (config.cpp:211-221,
        # signal.cpp:32-35).
        assert fc.signals[0].nexpected == pytest.approx(20000 / 500.0)
        assert fc.signals[1].nexpected == pytest.approx(20000 / 100.0)
        assert fc.nparameters == 4
        assert fc.parameter_names() == \
            ["signal1", "signal2", "energy_scale_0", "energy_resolution_0"]

    def test_rate_instead_of_scale(self, mc_files):
        conf = example_config(mc_files)
        conf["signals"]["signal1"].pop("scale")
        conf["signals"]["signal1"]["rate"] = 123.0
        fc = FitConfig.from_dict(conf)
        assert fc.signals[0].nexpected == pytest.approx(123.0)

    def test_explicit_source(self, mc_files):
        conf = example_config(mc_files)
        conf["sources"] = {"shared": {"mean": 1.0, "sigma": 0.3}}
        conf["signals"]["signal1"]["source"] = "shared"
        conf["signals"]["signal2"]["source"] = "shared"
        fc = FitConfig.from_dict(conf)
        assert [s.name for s in fc.sources] == ["shared"]
        assert fc.signals[0].source.name == "shared"
        assert fc.signals[1].source.index == 0
        assert fc.nsources == 1

    def test_cuts_applied_to_mc(self, mc_files):
        conf = example_config(mc_files)
        conf["pdfs"]["observables"]["radius"]["max"] = 5.0
        fc = FitConfig.from_dict(conf)
        # About half the MC survives the radius < 5 cut.
        n_in_pdf = fc.signals[0].histogram.samples.shape[0]
        assert 0.4 < n_in_pdf / 20000 < 0.6


class TestEndToEnd:
    def test_cli_full_fit(self, mc_files, tmp_path, capsys):
        conf = example_config(mc_files, nsteps=3000)
        cfg_file = tmp_path / "fit.json"
        cfg_file.write_text(json.dumps(conf))
        outdir = tmp_path / "out"

        from sxmc_jax.cli import main
        assert main([str(cfg_file), str(outdir)]) == 0
        out = capsys.readouterr().out
        assert "Best fit" in out
        assert "Median upper limit" in out
        assert (outdir / "lspace_0.npz").exists()

    def test_cli_hypotest(self, mc_files, tmp_path, capsys):
        """--hypotest reports q0 + a CLs limit on fit.signal_name and
        writes the machine-readable hypotest JSON."""
        conf = example_config(mc_files, nsteps=1500)
        cfg_file = tmp_path / "fit.json"
        cfg_file.write_text(json.dumps(conf))
        outdir = tmp_path / "out"

        from sxmc_jax.cli import main
        assert main([str(cfg_file), str(outdir),
                     "--sampler", "mle", "--hypotest", "20"]) == 0
        out = capsys.readouterr().out
        assert "hypotest: Discovery signal1" in out
        assert "hypotest: CLs upper limit" in out
        hfile = outdir / "lspace_hypotest_0.json"
        assert hfile.exists()
        res = json.loads(hfile.read_text())
        assert res["signal"] == "signal1"
        assert res["ntoys"] == 20
        # 500 expected signal events: discovery must be overwhelming,
        # and the CLs limit must sit above the (large) best-fit rate.
        assert res["z_asymptotic"] > 5.0
        assert res["cls_limit"] > 0.0
        # 8 coarse points plus the refinement pass around the
        # CLs = 1 - cl crossing (stats/hypotest.py upper_limit_cls).
        assert len(res["r_grid"]) == len(res["cls_values"]) >= 8

    def test_cli_hypotest_asymptotic(self, mc_files, tmp_path, capsys):
        """--hypotest-asymptotic (no toys) writes the Asimov-based CLs
        limit and expected band."""
        conf = example_config(mc_files, nsteps=1500)
        cfg_file = tmp_path / "fit.json"
        cfg_file.write_text(json.dumps(conf))
        outdir = tmp_path / "out"

        from sxmc_jax.cli import main
        assert main([str(cfg_file), str(outdir),
                     "--sampler", "mle", "--hypotest-asymptotic"]) == 0
        out = capsys.readouterr().out
        assert "Asymptotic (Asimov)" in out
        res = json.loads(
            (outdir / "lspace_hypotest_0.json").read_text())
        assert res["asymptotic_limit"] > 0.0
        exp = res["asymptotic_expected"]
        assert set(exp) == {"-2", "-1", "0", "1", "2"}
        assert exp["-2"] <= exp["0"] <= exp["2"]
        assert "cls_limit" not in res  # no toys requested

    def test_cli_gof_and_blocked(self, mc_files, tmp_path, capsys):
        """--gof reports a saturated-chi2 p-value (and logs it to the
        metrics JSONL); --rate-substeps engages the blocked sampler."""
        conf = example_config(mc_files, nsteps=2000)
        cfg_file = tmp_path / "fit.json"
        cfg_file.write_text(json.dumps(conf))
        outdir = tmp_path / "out"

        from sxmc_jax.cli import main
        assert main([str(cfg_file), str(outdir), "--gof", "30",
                     "--rate-substeps", "3"]) == 0
        out = capsys.readouterr().out
        assert "Rate substeps (blocked within-Gibbs): 3" in out
        assert "Goodness of fit" in out
        assert "chi2/ndof" in out
        metrics = (outdir / "lspace_metrics.jsonl").read_text()
        events = [json.loads(ln) for ln in metrics.splitlines()]
        gof = [e for e in events if e.get("event") == "experiment_gof"]
        assert gof and gof[0]["ndof"] > 0
        assert 0.0 <= gof[0]["p_toys"] <= 1.0

        # Resume path: the experiment reloads from its lspace file
        # (samples_data is None) — --gof must be skipped, not crash.
        assert main([str(cfg_file), str(outdir), "--gof", "30",
                     "--resume"]) == 0
        out = capsys.readouterr().out
        assert "Resuming from" in out

    def test_resume_from_samples(self, mc_files, tmp_path):
        conf = example_config(mc_files, nsteps=2000)
        cfg_file = tmp_path / "fit.json"
        cfg_file.write_text(json.dumps(conf))
        outdir = tmp_path / "out"

        from sxmc_jax.ensemble import main_fit
        main_fit(str(cfg_file), str(outdir))

        # fit.samples: recompute intervals from the stored samples,
        # skipping the MCMC (sxmc.cpp:84-94, config.cpp:51).
        conf2 = example_config(
            mc_files, nsteps=2000,
            samples=str(outdir / "lspace_0.npz"))
        cfg2 = tmp_path / "fit2.json"
        cfg2.write_text(json.dumps(conf2))
        limits = main_fit(str(cfg2), str(tmp_path / "out2"))
        assert limits  # interval extracted without re-running MCMC
