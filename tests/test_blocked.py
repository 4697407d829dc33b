"""Blocked Metropolis-within-Gibbs tests.

The blocked stepper (metropolis._make_blocked_step) alternates one
systematic-block update (full PDF rebuild) with ``rate_substeps``
rate-block updates that reuse the carried LUT.  These tests pin:

  * the carried (lut, norms) never desynchronize from the params — the
    recorded NLL history must equal an independent recomputation at the
    recorded parameters;
  * the walk targets the same posterior as the joint sampler;
  * the batched multi-chain variant agrees too;
  * checkpoint kill-and-resume works unchanged (extras are derived
    state).
"""

import jax
import numpy as np

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.mcmc import metropolis
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.ops.nll import nll as nll_fn
from sxmc_jax.signal import Observable, Signal, Source, Systematic


def make_fixture(seed=1, n_mc=20000):
    rng = np.random.default_rng(seed)
    obs = Observable(name="energy", field="energy", bins=20, lower=5.0,
                     upper=15.0, field_index=0)
    syst = Systematic(
        name="energy_shift", type=0, observable_field="energy",
        means=[0.0], sigmas=[0.05], observable_field_index=0, pidx=[0])
    sample_fields = ["energy", "DATASET"]

    sig_mc = rng.normal(10, 1, (n_mc, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (n_mc, 1)).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0, sigma=0.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    sig = Signal.from_table("sig", "Signal", sig_mc, ["energy"], 0,
                            src_s, 200.0, sample_fields, [obs], [],
                            [syst])
    bkg = Signal.from_table("bkg", "Bkg", bkg_mc, ["energy"], 0, src_b,
                            400.0, sample_fields, [obs], [], [])
    return obs, [syst], [src_s, src_b], [sig, bkg]


class TestBlockedStep:
    def test_history_nll_matches_recomputation(self):
        """The carried LUT must track the current systematics exactly:
        recomputing the NLL fresh at each recorded parameter vector
        must reproduce the recorded chain NLL."""
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])
        mcmc.stack.set_data(np.asarray(data, np.float32))
        rb = mcmc.stack._read_bins
        dd = mcmc.stack.device_data

        p0, nll0, w0 = metropolis.initial_state(mcmc, rb, dd)
        _, _, samples, nlls, _ = metropolis.run_segment(
            mcmc, p0, nll0, w0, rb, dd, jax.random.PRNGKey(7), 50,
            False, 3)
        samples = np.asarray(samples)
        hist = metropolis.nll_history_to_f64(nlls)
        for t in range(0, 50, 7):
            params = samples[t]
            lut, norms = mcmc.stack.evaluate(
                params[mcmc.nsources:], rb, dd, use_exact_kde=True)
            fresh = float(nll_fn(params, lut, norms, mcmc.static))
            assert abs(fresh - hist[t]) < 5e-3 * max(abs(fresh), 1.0), \
                (t, fresh, hist[t])

    def test_debug_mode_accepts_everything(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])
        mcmc(data, nsteps=200, burnin_fraction=0.0, debug_mode=True,
             seed=5, rate_substeps=3)
        assert mcmc.last_accept_rate == 1.0

    def test_fixed_parameter_pinned(self):
        obs, systs, sources, signals = make_fixture()
        sources[1].fixed = True
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])
        ls = mcmc(data, nsteps=800, burnin_fraction=0.1, seed=5,
                  rate_substeps=2)
        np.testing.assert_array_equal(ls.column("bkg"), 1.0)


class TestBlockedPosterior:
    def test_same_posterior_as_joint(self):
        """Blocked and joint walks must agree on posterior location and
        scale (same target distribution)."""
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)

        mcmc = MCMC(sources, signals, systs, [obs])
        ls_joint = mcmc(data, nsteps=8000, burnin_fraction=0.2, seed=5)
        ls_block = mcmc(data, nsteps=8000, burnin_fraction=0.2, seed=6,
                        rate_substeps=4)

        for name in ("sig", "bkg"):
            mj = float(np.mean(ls_joint.column(name)))
            mb = float(np.mean(ls_block.column(name)))
            sj = float(np.std(ls_joint.column(name)))
            sb = float(np.std(ls_block.column(name)))
            # Means agree within a fraction of the posterior width and
            # widths within 40% (MC error at 6.4k kept samples).
            assert abs(mj - mb) < 0.5 * max(sj, sb), (name, mj, mb, sj)
            assert 0.6 < sj / sb < 1.67, (name, sj, sb)

    def test_batched_chains_same_posterior(self):
        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])
        ls_joint = mcmc(data, nsteps=4000, burnin_fraction=0.2, seed=5,
                        nchains=4)
        ls_block = mcmc(data, nsteps=4000, burnin_fraction=0.2, seed=6,
                        nchains=4, rate_substeps=4)
        for name in ("sig", "bkg"):
            mj = float(np.mean(ls_joint.column(name)))
            mb = float(np.mean(ls_block.column(name)))
            sj = float(np.std(ls_joint.column(name)))
            sb = float(np.std(ls_block.column(name)))
            assert abs(mj - mb) < 0.5 * max(sj, sb), (name, mj, mb, sj)
            assert 0.6 < sj / sb < 1.67, (name, sj, sb)

    def test_no_floating_systematics_falls_back_to_joint(self):
        """Without a floating systematic, rate_substeps is a no-op (the
        plain step already never rebuilds)."""
        obs, _, sources, signals = make_fixture()
        # Build WITHOUT the systematic: LUT is fixed.
        signals2 = []
        rng = np.random.default_rng(3)
        sample_fields = ["energy", "DATASET"]
        for s, nexp in zip(("sig", "bkg"), (200.0, 400.0)):
            mc = (rng.normal(10, 1, (5000, 1)) if s == "sig" else
                  rng.uniform(5, 15, (5000, 1))).astype(np.float32)
            signals2.append(Signal.from_table(
                s, s, mc, ["energy"], 0, sources[0 if s == "sig" else 1],
                nexp, sample_fields, [obs], [], []))
        data = make_fake_dataset(jax.random.PRNGKey(4), signals2, [],
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals2, [], [obs])
        ls = mcmc(data, nsteps=500, burnin_fraction=0.1, seed=5,
                  rate_substeps=5)
        assert ls.samples.shape[0] == 400  # nsteps - 2*burnin


class TestBlockedCheckpoint:
    def test_kill_and_resume(self, tmp_path):
        from sxmc_jax import checkpoint as ckpt_mod

        obs, systs, sources, signals = make_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])
        path = str(tmp_path / "chain.ckpt.npz")

        # Straight-through run.
        ls_full = ckpt_mod.run_checkpointed(
            mcmc, data, 600, 0.1, segment_steps=200,
            checkpoint_path=path, seed=9, rate_substeps=3)
        import os

        os.remove(path)

        # "Killed" run: only the first segment, then resume.
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
                mcmc, data, 600, 0.1, segment_steps=200,
                checkpoint_path=path, seed=9, rate_substeps=3)
            raise AssertionError("expected Stop")
        except Stop:
            pass
        finally:
            ckpt_mod.save_chain_state = orig

        ls_res = ckpt_mod.run_checkpointed(
            mcmc, data, 600, 0.1, segment_steps=200,
            checkpoint_path=path, seed=9, rate_substeps=3)
        np.testing.assert_allclose(ls_res.samples, ls_full.samples,
                                   rtol=1e-6)
