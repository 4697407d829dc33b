"""The reference's shipped example configuration, end to end.

The upstream config/example.json is MALFORMED JSON (missing comma
between the two systematics objects at lines 41-42) — jsoncpp 0.6
rejects it too, so this is the reference's bug, not a parity gap.
examples/reference_example.json is the repaired copy (see its
_comment block and docs/MIGRATION.md); this test proves it parses,
builds the exact reference model structure, and fits.
"""

import json
import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def example_workdir(tmp_path_factory):
    wd = tmp_path_factory.mktemp("refexample")
    sys.path.insert(0, os.path.join(REPO, "examples"))
    try:
        import make_example
        make_example.main(str(wd))
    finally:
        sys.path.pop(0)
    return str(wd)


class TestReferenceExample:
    def test_malformed_original_is_rejected(self, tmp_path):
        """A config with the reference's missing-comma defect must be
        rejected loudly (strict JSON, like jsoncpp)."""
        bad = """{
          "pdfs": {"systematics": {
            "a": {"type": "scale", "observable_field": "x",
                  "mean": [0.0], "sigma": [0.01]}
            "b": {"type": "scale", "observable_field": "x",
                  "mean": [0.0], "sigma": [0.01]}
          }}
        }"""
        path = tmp_path / "bad.json"
        path.write_text(bad)
        from sxmc_jax.fitconfig import load_json

        with pytest.raises(json.JSONDecodeError):
            load_json(str(path))

    def test_repaired_example_parses_to_reference_model(
            self, example_workdir):
        from sxmc_jax.fitconfig import FitConfig

        fc = FitConfig.from_json_file(
            os.path.join(REPO, "examples", "reference_example.json"),
            data_root=example_workdir)
        assert fc.nexperiments == 1 and fc.nsteps == 100000
        assert fc.signal_name == "signal1"
        assert [s.name for s in fc.signals] == ["signal1", "signal2"]
        assert [s.name for s in fc.systematics] == [
            "energy_scale", "energy_resolution"]
        # scale sentinel: nexpected = n_mc / scale (signal.cpp:32-35).
        assert fc.signals[0].nexpected == pytest.approx(
            fc.signals[0].n_mc / 500.0)
        assert fc.signals[1].nexpected == pytest.approx(
            fc.signals[1].n_mc / 1000.0)
        # signal1 carries the rate constraint.
        assert fc.signals[0].source.sigma == pytest.approx(0.05)
        # radius is a cut, not a fit observable.
        assert [o.name for o in fc.observables] == ["energy"]
        assert [c.name for c in fc.cuts] == ["radius"]
        # resolution_scale wired to the truth field.
        assert fc.systematics[1].truth_field == "mc_energy"

    def test_repaired_example_fits(self, example_workdir, tmp_path):
        from sxmc_jax.ensemble import run_ensemble
        from sxmc_jax.fitconfig import FitConfig

        fc = FitConfig.from_json_file(
            os.path.join(REPO, "examples", "reference_example.json"),
            data_root=example_workdir)
        # Same model, test-sized walk.
        fc.nsteps = 3000
        fc.burnin_fraction = 0.2
        limits = run_ensemble(fc, str(tmp_path / "out"), verbose=False)
        assert len(limits) == 1 and np.isfinite(limits[0])
