"""Multi-dataset (multi-phase) fit tests.

The reference supports simultaneous fits over several datasets tagged
by a DATASET column (config.cpp:261-296, pdfz.cpp:289-293): each
signal's PDF only sees events with its own tag; the ``data`` section
maps dataset ids to real data files.
"""

import json

import numpy as np
import jax
import pytest

from sxmc_jax.fitconfig import FitConfig
from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.io import loaders
from sxmc_jax.mcmc.metropolis import MCMC


@pytest.fixture
def two_phase(tmp_path):
    rng = np.random.default_rng(17)
    n = 20000
    fields = ["energy"]
    # Phase 0: Gaussian signal; phase 1: different resolution.
    loaders.write_float_table(
        str(tmp_path / "sig_p0.npz"),
        rng.normal(10, 1, (n, 1)).astype(np.float32), fields)
    loaders.write_float_table(
        str(tmp_path / "sig_p1.npz"),
        rng.normal(10, 2, (n, 1)).astype(np.float32), fields)
    loaders.write_float_table(
        str(tmp_path / "bkg_p0.npz"),
        rng.uniform(5, 15, (n, 1)).astype(np.float32), fields)
    loaders.write_float_table(
        str(tmp_path / "bkg_p1.npz"),
        rng.uniform(5, 15, (n, 1)).astype(np.float32), fields)
    conf = {
        "fit": {
            "nexperiments": 1, "nsteps": 5000, "burnin_fraction": 0.2,
            "signals": ["sig0", "sig1", "bkg0", "bkg1"],
            "observables": ["energy"], "seed": 2, "plots": False,
        },
        "pdfs": {"observables": {
            "energy": {"title": "E", "field": "energy", "bins": 20,
                       "min": 5.0, "max": 15.0}}},
        "sources": {
            # One shared rate for the signal across both phases
            # (source-correlated rates, source.h:21-58).
            "signal_rate": {"mean": 1.0, "sigma": 0.0},
        },
        "signals": {
            "sig0": {"title": "S0",
                     "filename": str(tmp_path / "sig_p0.npz"),
                     "dataset": 0, "source": "signal_rate",
                     "rate": 300.0},
            "sig1": {"title": "S1",
                     "filename": str(tmp_path / "sig_p1.npz"),
                     "dataset": 1, "source": "signal_rate",
                     "rate": 200.0},
            "bkg0": {"title": "B0",
                     "filename": str(tmp_path / "bkg_p0.npz"),
                     "dataset": 0, "rate": 400.0},
            "bkg1": {"title": "B1",
                     "filename": str(tmp_path / "bkg_p1.npz"),
                     "dataset": 1, "rate": 300.0},
        },
    }
    return conf, tmp_path


class TestMultiDataset:
    def test_shared_source_across_phases(self, two_phase):
        conf, _ = two_phase
        fc = FitConfig.from_dict(conf)
        assert fc.datasets == [0, 1]
        # 3 sources: shared signal_rate + two implicit background ones.
        assert [s.name for s in fc.sources] == \
            ["signal_rate", "bkg0", "bkg1"]
        assert fc.signals[0].source.index == fc.signals[1].source.index

        data = make_fake_dataset(jax.random.PRNGKey(1), fc.signals,
                                 fc.systematics, fc.observables,
                                 poisson=False)
        tags = data[:, -1]
        # Both phases present in the fake dataset.
        assert (tags == 0).sum() > 500 and (tags == 1).sum() > 300

        mcmc = MCMC(fc.sources, fc.signals, fc.systematics,
                    fc.observables)
        ls = mcmc(data, 5000, 0.2, seed=8)
        bf = ls.get_best_fit()
        # The shared rate is constrained by both phases jointly.
        assert abs(bf["signal_rate"].point_estimate - 1.0) < 0.25
        assert abs(bf["bkg0"].point_estimate - 1.0) < 0.3
        assert abs(bf["bkg1"].point_estimate - 1.0) < 0.3

    def test_data_section_real_datasets(self, two_phase, tmp_path):
        conf, base = two_phase
        rng = np.random.default_rng(3)
        # Real "data" files per dataset.
        d0 = np.concatenate([rng.normal(10, 1, 300),
                             rng.uniform(5, 15, 400)])
        d1 = np.concatenate([rng.normal(10, 2, 200),
                             rng.uniform(5, 15, 300)])
        loaders.write_float_table(str(base / "data0.npz"),
                                  d0[:, None].astype(np.float32),
                                  ["energy"])
        loaders.write_float_table(str(base / "data1.npz"),
                                  d1[:, None].astype(np.float32),
                                  ["energy"])
        conf["data"] = {
            "0": [{"title": "run0",
                   "filename": str(base / "data0.npz")}],
            "1": [{"title": "run1",
                   "filename": str(base / "data1.npz")}],
        }
        conf["fit"]["nsteps"] = 3000
        cfg = tmp_path / "fit.json"
        cfg.write_text(json.dumps(conf))

        from sxmc_jax.ensemble import main_fit

        main_fit(str(cfg), str(tmp_path / "out"))
        assert (tmp_path / "out" / "lspace_0.npz").exists()
