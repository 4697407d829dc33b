"""Ensemble failure detection / recovery (SURVEY.md section 5).

The reference aborts the whole ensemble on any error.  run_ensemble
instead puts each experiment behind a fault barrier: failures are
logged to the structured metrics stream with a traceback, retried
under a fresh RNG key (a pathologically-drawn toy gets redrawn), and
permanently-failing experiments are recorded + skipped so the rest of
the ensemble still completes and reports its median limit.
"""

import json
import os

import numpy as np
import pytest

from sxmc_jax import ensemble as ensemble_mod
from sxmc_jax.ensemble import run_ensemble
from sxmc_jax.fitconfig import FitConfig

from tests.test_config_e2e import example_config, mc_files  # noqa: F401


def _read_metrics(outdir, prefix="lspace"):
    path = os.path.join(outdir, f"{prefix}_metrics.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture
def fc3(mc_files):  # noqa: F811 — pytest fixture chaining
    conf = example_config(mc_files, nexperiments=3, nsteps=800,
                          plots=False)
    return FitConfig.from_dict(conf)


def test_transient_failure_retried(fc3, tmp_path, monkeypatch):
    """A failing first attempt is retried under a fresh key and the
    ensemble reports a limit for every experiment."""
    calls = {"n": 0, "keys": []}
    real = ensemble_mod.make_fake_dataset

    def flaky(key, *args, **kwargs):
        calls["n"] += 1
        calls["keys"].append(np.asarray(key).tolist())
        # Fail the FIRST generation attempt of experiment 1 only.
        if calls["n"] == 2:
            raise RuntimeError("injected transient failure")
        return real(key, *args, **kwargs)

    monkeypatch.setattr(ensemble_mod, "make_fake_dataset", flaky)
    out = str(tmp_path / "out")
    limits = run_ensemble(fc3, out, verbose=False, max_retries=2)
    assert len(limits) == 3
    # 3 experiments + 1 retry = 4 generation calls, and the retry used
    # a DIFFERENT key than the failed attempt.
    assert calls["n"] == 4
    assert calls["keys"][1] != calls["keys"][2]

    events = _read_metrics(out)
    failed = [e for e in events if e["event"] == "experiment_failed"]
    assert len(failed) == 1
    assert failed[0]["experiment"] == 1 and failed[0]["attempt"] == 0
    assert "injected transient failure" in failed[0]["error"]
    assert "traceback" in failed[0]
    done = [e for e in events if e["event"] == "ensemble_done"]
    assert done and done[0]["nfailed"] == 0


def test_permanent_failure_skipped(fc3, tmp_path, monkeypatch):
    """An experiment that keeps failing is recorded and skipped; the
    rest of the ensemble completes."""
    real = ensemble_mod.make_fake_dataset
    calls = {"n": 0}

    def broken_for_exp0(key, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] <= 2:  # attempts 0 and 1 of experiment 0
            raise RuntimeError("injected permanent failure")
        return real(key, *args, **kwargs)

    monkeypatch.setattr(ensemble_mod, "make_fake_dataset",
                        broken_for_exp0)
    out = str(tmp_path / "out")
    limits = run_ensemble(fc3, out, verbose=False, max_retries=1)
    assert len(limits) == 2  # experiments 1 and 2 still produced limits

    events = _read_metrics(out)
    failed = [e for e in events if e["event"] == "experiment_failed"]
    assert len(failed) == 2  # two attempts of experiment 0
    done = [e for e in events if e["event"] == "ensemble_done"][0]
    assert done["nfailed"] == 1
    assert done["failures"][0]["experiment"] == 0


def test_zero_retries(fc3, tmp_path, monkeypatch):
    real = ensemble_mod.make_fake_dataset

    def fail_once(key, *args, **kwargs):
        if not getattr(fail_once, "done", False):
            fail_once.done = True
            raise ValueError("boom")
        return real(key, *args, **kwargs)

    monkeypatch.setattr(ensemble_mod, "make_fake_dataset", fail_once)
    out = str(tmp_path / "out")
    limits = run_ensemble(fc3, out, verbose=False, max_retries=0)
    assert len(limits) == 2
    done = [e for e in _read_metrics(out)
            if e["event"] == "ensemble_done"][0]
    assert done["nfailed"] == 1


class TestTypedErrors:
    """User-facing validation raises ConfigError/FitError with
    actionable messages (python -O safe — no bare asserts)."""

    def _minimal(self):
        return {
            "fit": {"nexperiments": 1, "nsteps": 100,
                    "experiments": 1, "observables": [], "signals": []},
            "pdfs": {"observables": {}, "systematics": {}},
            "signals": {}, "sources": {},
        }

    def test_nexperiments_nsteps(self):
        from sxmc_jax.utils import ConfigError

        for key in ("nexperiments", "nsteps"):
            conf = self._minimal()
            conf["fit"][key] = 0
            with pytest.raises(ConfigError, match=key):
                FitConfig.from_dict(conf)

    def test_rate_xor_scale(self):
        from sxmc_jax.utils import ConfigError

        conf = self._minimal()
        conf["pdfs"]["observables"]["energy"] = {
            "field": "energy", "bins": 10, "min": 0.0, "max": 1.0,
            "units": "u", "title": "E"}
        conf["fit"]["observables"] = ["energy"]
        conf["fit"]["signals"] = ["sig"]
        conf["signals"]["sig"] = {
            "dataset": 0, "title": "s", "source": "s",
            "rate": 10.0, "scale": 2.0,
            "files": [], "systematics": []}
        conf["sources"]["s"] = {"mean": 1.0, "sigma": 0.0}
        with pytest.raises(ConfigError, match="exactly one"):
            FitConfig.from_dict(conf)

    def test_cut_duplicates_observable(self):
        from sxmc_jax.utils import ConfigError

        conf = self._minimal()
        conf["pdfs"]["observables"]["energy"] = {
            "field": "energy", "bins": 10, "min": 0.0, "max": 1.0,
            "units": "u", "title": "E"}
        conf["fit"]["observables"] = ["energy"]
        conf["fit"]["cuts"] = ["energy"]
        with pytest.raises(ConfigError, match="cut"):
            FitConfig.from_dict(conf)

    def test_likelihood_space_shape(self):
        from sxmc_jax.stats.likelihood import LikelihoodSpace
        from sxmc_jax.utils import FitError

        with pytest.raises(FitError, match="shapes"):
            LikelihoodSpace(np.zeros((5, 2)), np.zeros(4), ["a", "b"])

    def test_empty_contour(self):
        from sxmc_jax.stats.likelihood import LikelihoodSpace
        from sxmc_jax.utils import FitError

        ls = LikelihoodSpace(np.zeros((3, 1)), np.ones(3), ["a"])
        with pytest.raises(FitError, match="dNLL"):
            ls.get_contour(0.0)

    def test_load_rejects_non_lspace(self, tmp_path):
        from sxmc_jax.io import loaders
        from sxmc_jax.stats.likelihood import LikelihoodSpace
        from sxmc_jax.utils import FitError

        path = str(tmp_path / "notls.npz")
        loaders.write_float_table(
            path, np.zeros((3, 2), np.float32), ["a", "b"])
        with pytest.raises(FitError, match="likelihood"):
            LikelihoodSpace.load(path)
