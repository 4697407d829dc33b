"""Kill-and-resume for the sharded ensemble (8-device CPU mesh).

run_sharded_ensemble(checkpoint_steps > 0) persists the full batched
chain state after every segment; killing the run mid-walk and resuming
must reproduce the uninterrupted segmented run BIT-identically (the
per-segment keys are deterministic in fc.seed and the segment index).
"""

import numpy as np
import jax
import pytest

from sxmc_jax.fitconfig import FitConfig
from sxmc_jax.parallel import ensemble as par_ensemble
from tests.test_mcmc import make_fixture


def _config(seed=3):
    obs, systs, sources, signals = make_fixture(with_systematic=True,
                                                seed=9)
    return FitConfig(
        nexperiments=4, nsteps=250, burnin_fraction=0.2,
        signal_name="sig", seed=seed, nchains=2,
        observables=[obs], systematics=systs, sources=sources,
        signals=signals)


class TestShardedEnsembleCheckpoint:
    def test_requires_path(self):
        fc = _config()
        with pytest.raises(ValueError, match="checkpoint_path"):
            par_ensemble.run_sharded_ensemble(fc, checkpoint_steps=10)

    def test_kill_and_resume_bitwise(self, tmp_path):
        fc = _config()

        # Reference: uninterrupted segmented run.
        pA = str(tmp_path / "runA")
        lsA, limA = par_ensemble.run_sharded_ensemble(
            fc, verbose=False, checkpoint_path=pA, checkpoint_steps=40)

        # Killed run: die after 3 completed segments, then resume.
        pB = str(tmp_path / "runB")
        real = par_ensemble._batched_segment
        calls = {"n": 0}

        def dying(*args, **kwargs):
            if calls["n"] >= 3:
                raise RuntimeError("simulated preemption")
            calls["n"] += 1
            return real(*args, **kwargs)

        par_ensemble._batched_segment = dying
        try:
            with pytest.raises(RuntimeError, match="preemption"):
                par_ensemble.run_sharded_ensemble(
                    fc, verbose=False, checkpoint_path=pB,
                    checkpoint_steps=40)
        finally:
            par_ensemble._batched_segment = real

        import os
        assert os.path.exists(pB + ".state.npz")
        lsB, limB = par_ensemble.run_sharded_ensemble(
            fc, verbose=False, checkpoint_path=pB, checkpoint_steps=40,
            resume=True)

        assert len(limA) == len(limB) == fc.nexperiments
        np.testing.assert_array_equal(np.asarray(limA),
                                      np.asarray(limB))
        for a, b in zip(lsA, lsB):
            np.testing.assert_array_equal(a.samples, b.samples)
            np.testing.assert_array_equal(a.nll_values, b.nll_values)

    def test_posterior_sane(self, tmp_path):
        fc = _config(seed=5)
        ls, limits = par_ensemble.run_sharded_ensemble(
            fc, verbose=False, checkpoint_path=str(tmp_path / "r"),
            checkpoint_steps=60)
        assert len(limits) == fc.nexperiments
        assert np.isfinite(limits).all()
        for l in ls:
            assert np.isfinite(l.nll_values).all()
