"""Full-covariance adaptive-proposal tests.

An anticorrelated rate posterior (two heavily overlapping signal PDFs)
is the classic failure mode of axis-aligned proposals: the chain can
only cross the ridge in tiny steps.  The Haario full-covariance
proposal (metropolis._make_step_cov) walks along it.
"""

import jax
import numpy as np
import pytest

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.signal import Observable, Signal, Source
from sxmc_jax.stats.diagnostics import summarize


@pytest.fixture(scope="module")
def correlated_fit():
    rng = np.random.default_rng(1)
    obs = Observable(name="energy", field="energy", bins=30, lower=5.0,
                     upper=15.0, field_index=0)
    fields = ["energy", "DATASET"]
    a_mc = rng.normal(10.0, 1.5, (30000, 1)).astype(np.float32)
    b_mc = rng.normal(10.4, 1.5, (30000, 1)).astype(np.float32)
    src_a = Source(name="a", index=0, mean=1.0, sigma=0.0)
    src_b = Source(name="b", index=1, mean=1.0, sigma=0.0)
    sa = Signal.from_table("a", "a", a_mc, ["energy"], 0, src_a, 400.0,
                           fields, [obs], [], [])
    sb = Signal.from_table("b", "b", b_mc, ["energy"], 0, src_b, 400.0,
                           fields, [obs], [], [])
    data = make_fake_dataset(jax.random.PRNGKey(4), [sa, sb], [],
                             [obs], poisson=False)
    return MCMC([src_a, src_b], [sa, sb], [], [obs]), data


class TestFullCov:
    def test_mixing_beats_diagonal_on_correlated_posterior(
            self, correlated_fit):
        mcmc, data = correlated_fit
        results = {}
        for prop in ("diagonal", "full_cov"):
            ls = mcmc(data, nsteps=12000, burnin_fraction=0.2, seed=5,
                      proposal=prop)
            d = summarize(ls.samples, ls.names, nchains=1)
            results[prop] = {
                "ess": min(v["ess"] for v in d.values()),
                "accept": mcmc.last_accept_rate,
                "mean_a": float(np.mean(ls.column("a"))),
                "corr": float(np.corrcoef(ls.samples.T)[0, 1]),
            }
        # The posterior really is ridge-shaped.
        assert results["full_cov"]["corr"] < -0.8
        # Measured (seed 5): ESS 139 -> 959, accept 0.043 -> 0.355.
        assert results["full_cov"]["ess"] > \
            3.0 * results["diagonal"]["ess"], results
        assert 0.1 < results["full_cov"]["accept"] < 0.7, results
        # Same posterior: means agree well within the ~0.15 width.
        assert abs(results["full_cov"]["mean_a"]
                   - results["diagonal"]["mean_a"]) < 0.1

    def test_fixed_parameter_pinned(self, correlated_fit):
        # Fresh MCMC with source b fixed (jit specializes on the MCMC
        # object, so fit metadata must never be mutated in place).
        mcmc, data = correlated_fit
        src_a, src_b = mcmc.sources
        src_b2 = Source(name="b", index=1, mean=1.0, sigma=0.0,
                        fixed=True)
        sa, sb = mcmc.signals
        sb2 = Signal.from_table(
            "b", "b", np.asarray(sb.histogram.samples_host), ["energy"],
            0, src_b2, 400.0, ["energy", "DATASET"], mcmc.observables,
            [], [])
        mcmc2 = MCMC([src_a, src_b2], [sa, sb2], [], mcmc.observables)
        ls = mcmc2(data, nsteps=1500, burnin_fraction=0.2, seed=5,
                   proposal="full_cov")
        np.testing.assert_array_equal(ls.column("b"), 1.0)

    def test_incompatible_options_raise(self, correlated_fit):
        mcmc, data = correlated_fit
        with pytest.raises(ValueError):
            mcmc(data, nsteps=100, proposal="full_cov", rate_substeps=2)
        with pytest.raises(ValueError):
            mcmc(data, nsteps=100, proposal="banana")

    def test_multichain(self, correlated_fit):
        mcmc, data = correlated_fit
        ls = mcmc(data, nsteps=2000, burnin_fraction=0.2, seed=7,
                  nchains=3, proposal="full_cov")
        assert ls.samples.shape == (3 * 1200, 2)
        assert abs(float(np.mean(ls.column("a"))) - 1.0) < 0.4

    def test_degenerate_phase_keeps_previous_proposal(self,
                                                      correlated_fit):
        """A burn-in phase with zero accepted moves (constant samples)
        must retune to the PREVIOUS proposal, not collapse to ~0."""
        from sxmc_jax.mcmc import metropolis

        mcmc, _ = correlated_fit
        tril0 = metropolis._initial_scale_tril(mcmc)
        frozen = np.broadcast_to(
            np.array([1.0, 2.0], np.float32), (50, 2))
        new = metropolis.retune_scale_tril(
            mcmc, tril0, jax.numpy.asarray(frozen))
        np.testing.assert_allclose(np.asarray(new), np.asarray(tril0))

    def test_burnin_validation(self, correlated_fit):
        mcmc, data = correlated_fit
        with pytest.raises(ValueError, match="post-burn-in"):
            mcmc(data, nsteps=100, burnin_fraction=0.5)

    def test_checkpoint_full_cov_resume(self, correlated_fit,
                                        tmp_path):
        from sxmc_jax import checkpoint as ckpt_mod

        mcmc, data = correlated_fit
        path = str(tmp_path / "fc.ckpt.npz")
        ls_full = ckpt_mod.run_checkpointed(
            mcmc, data, 900, 0.1, segment_steps=300,
            checkpoint_path=path, seed=9, proposal="full_cov")
        import os

        os.remove(path)

        class Stop(Exception):
            pass

        orig = ckpt_mod.save_chain_state
        calls = {"n": 0}

        def bomb(p, s):
            orig(p, s)
            calls["n"] += 1
            if calls["n"] == 2:
                raise Stop()

        ckpt_mod.save_chain_state = bomb
        try:
            ckpt_mod.run_checkpointed(
                mcmc, data, 900, 0.1, segment_steps=300,
                checkpoint_path=path, seed=9, proposal="full_cov")
            raise AssertionError("expected Stop")
        except Stop:
            pass
        finally:
            ckpt_mod.save_chain_state = orig

        ls_res = ckpt_mod.run_checkpointed(
            mcmc, data, 900, 0.1, segment_steps=300,
            checkpoint_path=path, seed=9, proposal="full_cov")
        np.testing.assert_allclose(ls_res.samples, ls_full.samples,
                                   rtol=1e-6)
