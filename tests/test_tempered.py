"""Parallel-tempered Metropolis tests.

Pins: the temperature ladder, detailed-balance swap bookkeeping, cold-
chain posterior equivalence with plain Metropolis on a unimodal target,
and the headline capability — sampling BOTH modes of a genuinely
bimodal posterior that traps a single chain.
"""

import jax
import numpy as np

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.mcmc.tempered import TemperedMCMC, temperature_ladder
from sxmc_jax.signal import Observable, Signal, Source, Systematic


def unimodal_fixture(seed=1):
    rng = np.random.default_rng(seed)
    obs = Observable(name="energy", field="energy", bins=20, lower=5.0,
                     upper=15.0, field_index=0)
    syst = Systematic(
        name="energy_shift", type=0, observable_field="energy",
        means=[0.0], sigmas=[0.05], observable_field_index=0, pidx=[0])
    sample_fields = ["energy", "DATASET"]
    sig_mc = rng.normal(10, 1, (20000, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (20000, 1)).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0, sigma=0.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    sig = Signal.from_table("sig", "Signal", sig_mc, ["energy"], 0,
                            src_s, 200.0, sample_fields, [obs], [],
                            [syst])
    bkg = Signal.from_table("bkg", "Bkg", bkg_mc, ["energy"], 0, src_b,
                            400.0, sample_fields, [obs], [], [])
    return obs, [syst], [src_s, src_b], [sig, bkg]


def bimodal_fixture(seed=2):
    """Shift posterior with two exactly symmetric modes at +-1.

    The MC PDF is a mixture of peaks at 9 and 11; the data is a single
    peak at 10.  A shift of +1 aligns the 9-peak with the data, -1
    aligns the 11-peak — equal likelihood, separated by a deep valley
    at 0 where the data sits between the MC peaks.
    """
    rng = np.random.default_rng(seed)
    obs = Observable(name="energy", field="energy", bins=40, lower=5.0,
                     upper=15.0, field_index=0)
    # Loose symmetric constraint: keeps the walk bounded, preserves the
    # +-1 symmetry.
    syst = Systematic(
        name="shift", type=0, observable_field="energy",
        means=[0.0], sigmas=[2.0], observable_field_index=0, pidx=[0])
    sample_fields = ["energy", "DATASET"]
    half = 20000
    mc = np.concatenate([
        rng.normal(9.0, 0.3, half), rng.normal(11.0, 0.3, half)
    ]).astype(np.float32)[:, None]
    src = Source(name="sig", index=0, mean=1.0, sigma=0.1)
    sig = Signal.from_table("sig", "Signal", mc, ["energy"], 0, src,
                            500.0, sample_fields, [obs], [], [syst])
    ev = rng.normal(10.0, 0.3, 500).astype(np.float32)
    data = np.stack([ev, np.zeros_like(ev)], axis=1)
    return obs, [syst], [src], [sig], data


class TestLadder:
    def test_geometric(self):
        b = temperature_ladder(5, 16.0)
        assert b[0] == 1.0
        assert abs(b[-1] - 1.0 / 16.0) < 1e-7
        ratios = b[:-1] / b[1:]
        np.testing.assert_allclose(ratios, ratios[0], rtol=1e-5)

    def test_single_temp(self):
        np.testing.assert_array_equal(temperature_ladder(1, 8.0), [1.0])


class TestTemperedUnimodal:
    def test_matches_plain_metropolis(self):
        obs, systs, sources, signals = unimodal_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        plain = MCMC(sources, signals, systs, [obs])
        ls_p = plain(data, nsteps=6000, burnin_fraction=0.2, seed=5)
        temp = TemperedMCMC(sources, signals, systs, [obs], ntemps=4,
                            tmax=8.0, swap_every=10)
        ls_t = temp(data, nsteps=6000, burnin_fraction=0.2, seed=6)
        assert 0.0 <= temp.last_swap_rate <= 1.0
        for name in ("sig", "bkg"):
            mp = float(np.mean(ls_p.column(name)))
            mt = float(np.mean(ls_t.column(name)))
            sp = float(np.std(ls_p.column(name)))
            st = float(np.std(ls_t.column(name)))
            assert abs(mp - mt) < 0.5 * max(sp, st), (name, mp, mt)
            assert 0.6 < sp / st < 1.67, (name, sp, st)

    def test_two_replica_ladder_swaps_every_window(self):
        """ntemps=2 has exactly one adjacent pair; both pairing
        parities must use it (a self-pairing parity would silently
        halve the swap cadence and the reported rate)."""
        obs, systs, sources, signals = unimodal_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        temp = TemperedMCMC(sources, signals, systs, [obs], ntemps=2,
                            tmax=1.1, swap_every=3)
        temp(data, nsteps=300, burnin_fraction=0.1, seed=5)
        # Near-identical temperatures swap nearly always; a
        # self-pairing parity bug would halve the measured rate.
        assert temp.last_swap_rate > 0.6, temp.last_swap_rate

    def test_debug_mode(self):
        obs, systs, sources, signals = unimodal_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        temp = TemperedMCMC(sources, signals, systs, [obs], ntemps=3,
                            tmax=4.0)
        temp(data, nsteps=200, burnin_fraction=0.0, debug_mode=True,
             seed=5)
        assert temp.last_accept_rate == 1.0


class TestTemperedBimodal:
    def test_cold_chain_visits_both_modes(self):
        obs, systs, sources, signals, data = bimodal_fixture()
        temp = TemperedMCMC(sources, signals, systs, [obs], ntemps=8,
                            tmax=64.0, swap_every=5)
        ls = temp(data, nsteps=12000, burnin_fraction=0.15, seed=3)
        shift = np.asarray(ls.column("shift_0"))
        frac_pos = float((shift > 0).mean())
        # Both modes sampled with substantial weight (they are exactly
        # symmetric, so the true split is 50/50).
        assert 0.15 < frac_pos < 0.85, frac_pos
        # And the modes sit near +-1.
        pos = shift[shift > 0]
        neg = shift[shift < 0]
        assert abs(np.median(pos) - 1.0) < 0.2
        assert abs(np.median(neg) + 1.0) < 0.2
        # Swaps actually happen.
        assert temp.last_swap_rate > 0.05

    def test_checkpoint_kill_and_resume(self, tmp_path):
        from sxmc_jax import checkpoint as ckpt_mod

        obs, systs, sources, signals = unimodal_fixture()
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        temp = TemperedMCMC(sources, signals, systs, [obs], ntemps=3,
                            tmax=8.0, swap_every=4)
        path = str(tmp_path / "t.ckpt.npz")

        ls_full = ckpt_mod.run_checkpointed_tempered(
            temp, data, 600, 0.1, segment_steps=200,
            checkpoint_path=path, seed=9)
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
            ckpt_mod.run_checkpointed_tempered(
                temp, data, 600, 0.1, segment_steps=200,
                checkpoint_path=path, seed=9)
            raise AssertionError("expected Stop")
        except Stop:
            pass
        finally:
            ckpt_mod.save_chain_state = orig

        ls_res = ckpt_mod.run_checkpointed_tempered(
            temp, data, 600, 0.1, segment_steps=200,
            checkpoint_path=path, seed=9)
        np.testing.assert_allclose(ls_res.samples, ls_full.samples,
                                   rtol=1e-6)

    def test_plain_chain_gets_trapped(self):
        """The same budget of plain Metropolis steps stays in one mode
        (this is WHY tempering exists; if this ever starts passing both
        modes, revisit the fixture)."""
        obs, systs, sources, signals, data = bimodal_fixture()
        plain = MCMC(sources, signals, systs, [obs])
        ls = plain(data, nsteps=12000, burnin_fraction=0.15, seed=3)
        shift = np.asarray(ls.column("shift_0"))
        frac_pos = float((shift > 0).mean())
        assert frac_pos < 0.02 or frac_pos > 0.98, frac_pos
