"""Metropolis segment runners (metropolis.run_segment and friends).

Contracts pinned here: a scanned segment equals a step-by-step host
drive of the same chain NLL under the same presampled streams and the
same accept rule (``u <= exp(delta)``); segments chain exactly through
their carry (the checkpoint/resume contract); lock-step batched chains
advance each chain exactly as a batch of one would; blocked
Metropolis-within-Gibbs cycles follow the same per-block reference.
"""

import numpy as np
import jax
import jax.numpy as jnp

from sxmc_jax.mcmc import metropolis
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.signal import Observable, Signal, Source, Systematic


def _fixture(nbins=100, n_mc=40_000, nevents=3000, seed=3):
    rng = np.random.default_rng(seed)
    obs = Observable(name="energy", field="energy", bins=nbins,
                     lower=5.0, upper=15.0, field_index=0)
    syst = Systematic(name="shift", type=0, observable_field="energy",
                      means=[0.0], sigmas=[0.05],
                      observable_field_index=0, pidx=[0])
    fields = ["energy", "DATASET"]
    sig_mc = rng.normal(10, 1, (n_mc, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (n_mc, 1)).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    sig = Signal.from_table("sig", "sig", sig_mc, ["energy"], 0, src_s,
                            1000.0, fields, [obs], [], [syst])
    bkg = Signal.from_table("bkg", "bkg", bkg_mc, ["energy"], 0,
                            src_b, 2000.0, fields, [obs], [], [])
    data = np.stack([rng.uniform(4.5, 15.5, nevents).astype(np.float32),
                     np.zeros(nevents, np.float32)], axis=1)
    return obs, syst, [src_s, src_b], [sig, bkg], data


def _mcmc_fixture(**kw):
    obs, syst, sources, signals, data = _fixture(**kw)
    mcmc = MCMC(sources, signals, [syst], [obs])
    mcmc.stack.set_data(data)
    return mcmc


def _chain_nll(mcmc):
    rb = mcmc.stack._read_bins
    dd = mcmc.stack.device_data
    f = jax.jit(lambda p, dd: metropolis._chain_nll(mcmc, rb, dd)(p))
    return lambda p: tuple(np.float32(x) for x in f(jnp.asarray(p), dd))


def _reference_walk(mcmc, p0, nll0, width, key, nsteps, m=0,
                    debug_mode=False):
    """Host drive of the chain NLL under the scan's accept rule.  With
    m > 0 each cycle is one systematic-block move plus m rate-block
    moves (the blocked stepper's streams)."""
    nll = _chain_nll(mcmc)
    noise, u = metropolis._presample(
        jax.random.split(key, nsteps), mcmc.nparameters, m)
    noise = np.asarray(noise, np.float32)
    u = np.asarray(u, np.float32)
    params = np.asarray(p0, np.float32)
    cur = (np.float32(nll0[0]), np.float32(nll0[1]))
    w = np.asarray(width, np.float32)
    rate_sel = np.arange(mcmc.nparameters) < mcmc.nsources
    samples, accs, nll_hist = [], [], []
    for s in range(nsteps):
        acc_n = 0.0
        for sub in range(m + 1):
            nz = noise[s, sub] * np.maximum(w, np.float32(0.0))
            move = w > 0
            if m > 0:
                move = move & (rate_sel if sub > 0 else ~rate_sel)
            prop = np.where(move, (params + nz).astype(np.float32),
                            params)
            hi, lo = nll(prop)
            delta = np.float32(cur[0] - hi) + np.float32(cur[1] - lo)
            if debug_mode or delta > 0 or u[s, sub] <= np.exp(delta):
                params, cur = prop, (hi, lo)
                acc_n += 1.0
        samples.append(params.copy())
        accs.append(acc_n / (m + 1))
        nll_hist.append(np.float64(cur[0]) + np.float64(cur[1]))
    return np.stack(samples), np.asarray(accs), np.asarray(nll_hist)


def _start(mcmc):
    return metropolis.initial_state(mcmc, mcmc.stack._read_bins,
                                    mcmc.stack.device_data)


class TestSegment:
    def test_trajectory_matches_oneshot_reference(self):
        mcmc = _mcmc_fixture(n_mc=20_000, nevents=800)
        rb, dd = mcmc.stack._read_bins, mcmc.stack.device_data
        p0, nll0, w0 = _start(mcmc)
        key = jax.random.PRNGKey(7)
        nsteps = 24
        pf, nf, samples, nlls, acc = metropolis.run_segment(
            mcmc, p0, nll0, w0, rb, dd, key, nsteps)
        ref_s, ref_a, ref_n = _reference_walk(mcmc, p0, nll0, w0, key,
                                              nsteps)
        # Params agree to f32 ulp (the reference computes the proposal
        # in separately compiled ops; FMA-contraction freedom allows
        # 1-ulp differences, never trajectory divergence on this seed).
        np.testing.assert_allclose(np.asarray(samples), ref_s, rtol=3e-7,
                                   atol=3e-7)
        got_n = np.asarray(nlls[0], np.float64) + np.asarray(nlls[1])
        np.testing.assert_allclose(got_n, ref_n, rtol=1e-6)
        assert abs(float(acc) - ref_a.mean()) < 1e-6
        np.testing.assert_allclose(np.asarray(pf), ref_s[-1],
                                   rtol=3e-7, atol=3e-7)

    def test_determinism_and_carry(self):
        mcmc = _mcmc_fixture(n_mc=20_000, nevents=800)
        rb, dd = mcmc.stack._read_bins, mcmc.stack.device_data
        p0, nll0, w0 = _start(mcmc)
        key = jax.random.PRNGKey(11)
        out1 = metropolis.run_segment(mcmc, p0, nll0, w0, rb, dd, key, 16)
        out2 = metropolis.run_segment(mcmc, p0, nll0, w0, rb, dd, key, 16)
        np.testing.assert_array_equal(np.asarray(out1[2]),
                                      np.asarray(out2[2]))
        # Segment chaining: two 8-step segments from the carry equal one
        # 16-step segment with the same per-step streams.
        pf, nf, _, _, _ = out1
        key2 = jax.random.PRNGKey(12)
        o_a = metropolis.run_segment(mcmc, pf, nf, w0, rb, dd, key2, 8)
        o_b = metropolis.run_segment(mcmc, pf, nf, w0, rb, dd, key2, 8)
        np.testing.assert_array_equal(np.asarray(o_a[2]),
                                      np.asarray(o_b[2]))
        np.testing.assert_array_equal(np.asarray(o_a[0]),
                                      np.asarray(o_a[2])[-1])

    def test_debug_mode_accepts_all(self):
        mcmc = _mcmc_fixture(n_mc=20_000, nevents=400)
        rb, dd = mcmc.stack._read_bins, mcmc.stack.device_data
        p0, nll0, w0 = _start(mcmc)
        _, _, _, _, acc = metropolis.run_segment(
            mcmc, p0, nll0, w0, rb, dd, jax.random.PRNGKey(3), 12,
            debug_mode=True)
        assert float(acc) == 1.0

    def test_batched_matches_per_chain(self):
        """Lock-step chains (one batched rebuild per step) advance each
        chain exactly as a batch of one with that chain's key."""
        mcmc = _mcmc_fixture(n_mc=20_000, nevents=600)
        rb, dd = mcmc.stack._read_bins, mcmc.stack.device_data
        keys = jax.random.split(jax.random.PRNGKey(8), 3)
        s3, n3, a3 = metropolis._run_chains_batched(
            mcmc, keys, rb, dd, 12, 0, False)
        assert np.asarray(s3).shape == (3, 12, mcmc.nparameters)
        for c in range(3):
            s1, n1, a1 = metropolis._run_chains_batched(
                mcmc, keys[c:c + 1], rb, dd, 12, 0, False)
            np.testing.assert_allclose(np.asarray(s3)[c],
                                       np.asarray(s1)[0],
                                       rtol=3e-7, atol=3e-7)
            assert float(a3[c]) == float(a1[0])

    def test_fullcov_trajectory(self):
        """run_segment_cov proposes params + L @ z; its trajectory
        matches a host drive with the same streams."""
        mcmc = _mcmc_fixture(n_mc=20_000, nevents=600)
        rb, dd = mcmc.stack._read_bins, mcmc.stack.device_data
        p0, nll0, _ = _start(mcmc)
        npar = mcmc.nparameters
        tril = np.zeros((npar, npar), np.float32)
        tril[0, 0] = 0.04
        tril[1, 0], tril[1, 1] = -0.02, 0.03
        tril[2, 2] = 0.01
        key = jax.random.PRNGKey(17)
        nsteps = 16
        pf, nf, samples, nlls, acc = metropolis.run_segment_cov(
            mcmc, p0, nll0, jnp.asarray(tril), rb, dd, key, nsteps)

        nll = _chain_nll(mcmc)
        params = np.asarray(p0, np.float32)
        cur = (np.float32(nll0[0]), np.float32(nll0[1]))
        ref = []
        for k in jax.random.split(key, nsteps):
            k_prop, k_accept = jax.random.split(k)
            z = np.asarray(jax.random.normal(k_prop, (npar,)), np.float64)
            prop = (params + tril.astype(np.float64) @ z).astype(
                np.float32)
            hi, lo = nll(prop)
            u = float(jax.random.uniform(k_accept, ()))
            delta = np.float32(cur[0] - hi) + np.float32(cur[1] - lo)
            if delta > 0 or u <= np.exp(delta):
                params, cur = prop, (hi, lo)
            ref.append(params.copy())
        np.testing.assert_allclose(np.asarray(samples), np.stack(ref),
                                   rtol=3e-7, atol=3e-7)
        assert 0.0 <= float(acc) <= 1.0

    def test_fixed_parameter_pinned(self):
        """width <= 0 pins a parameter exactly."""
        mcmc = _mcmc_fixture(n_mc=20_000, nevents=400)
        rb, dd = mcmc.stack._read_bins, mcmc.stack.device_data
        p0, nll0, w0 = _start(mcmc)
        w_pin = np.asarray(w0, np.float32).copy()
        w_pin[1] = -1.0
        _, _, samples, _, _ = metropolis.run_segment(
            mcmc, p0, nll0, jnp.asarray(w_pin), rb, dd,
            jax.random.PRNGKey(5), 16)
        col = np.asarray(samples)[:, 1]
        np.testing.assert_array_equal(col, np.full(16, float(p0[1]),
                                                   np.float32))


class TestBlockedSegment:
    """Blocked Metropolis-within-Gibbs: rate substeps reuse the carried
    LUT of the current state."""

    def test_trajectory_matches_oneshot_reference(self):
        mcmc = _mcmc_fixture(n_mc=20_000, nevents=800)
        rb, dd = mcmc.stack._read_bins, mcmc.stack.device_data
        p0, nll0, w0 = _start(mcmc)
        key = jax.random.PRNGKey(19)
        nsteps, m = 12, 3
        pf, nf, samples, nlls, acc = metropolis.run_segment(
            mcmc, p0, nll0, w0, rb, dd, key, nsteps, rate_substeps=m)
        ref_s, ref_a, ref_n = _reference_walk(mcmc, p0, nll0, w0, key,
                                              nsteps, m)
        np.testing.assert_allclose(np.asarray(samples), ref_s,
                                   rtol=3e-7, atol=3e-7)
        got_n = np.asarray(nlls[0], np.float64) + np.asarray(nlls[1])
        np.testing.assert_allclose(got_n, ref_n, rtol=1e-6)
        assert abs(float(acc) - ref_a.mean()) < 1e-6
        np.testing.assert_allclose(np.asarray(pf), ref_s[-1],
                                   rtol=3e-7, atol=3e-7)

    def test_rate_moves_actually_move_rates_only(self):
        """With the systematic pinned, blocked cycles move only rates;
        with the rates pinned, only the systematic moves."""
        mcmc = _mcmc_fixture(n_mc=20_000, nevents=600)
        rb, dd = mcmc.stack._read_bins, mcmc.stack.device_data
        p0, nll0, w0 = _start(mcmc)
        ns = mcmc.nsources
        for pin in (slice(ns, None), slice(0, ns)):
            w = np.asarray(w0, np.float32).copy()
            w[pin] = -1.0
            _, _, samples, _, acc = metropolis.run_segment(
                mcmc, p0, nll0, jnp.asarray(w), rb, dd,
                jax.random.PRNGKey(2), 10, rate_substeps=4)
            s = np.asarray(samples)
            np.testing.assert_array_equal(
                s[:, pin], np.broadcast_to(np.asarray(p0)[pin],
                                           s[:, pin].shape))
            assert 0.0 < float(acc) <= 1.0

    def test_batched_matches_per_chain(self):
        mcmc = _mcmc_fixture(n_mc=20_000, nevents=600)
        rb, dd = mcmc.stack._read_bins, mcmc.stack.device_data
        keys = jax.random.split(jax.random.PRNGKey(8), 3)
        s3, n3, a3 = metropolis._run_chains_batched(
            mcmc, keys, rb, dd, 8, 0, False, rate_substeps=2)
        for c in range(3):
            s1, n1, a1 = metropolis._run_chains_batched(
                mcmc, keys[c:c + 1], rb, dd, 8, 0, False,
                rate_substeps=2)
            np.testing.assert_allclose(np.asarray(s3)[c],
                                       np.asarray(s1)[0],
                                       rtol=3e-7, atol=3e-7)

    def test_posterior_matches_joint_sampler(self):
        """Blocked and joint samplers target the same posterior:
        posterior means agree within MC error on a short run."""
        obs, syst, sources, signals, data = _fixture(n_mc=20_000,
                                                     nevents=800)
        mcmc = MCMC(sources, signals, [syst], [obs])
        ls_b = mcmc(data, 600, burnin_fraction=0.2, seed=4,
                    rate_substeps=3)
        ls_j = mcmc(data, 1200, burnin_fraction=0.2, seed=5)
        for name in ("sig", "bkg"):
            b = ls_b.column(name)
            j = ls_j.column(name)
            assert abs(b.mean() - j.mean()) < 4 * max(
                j.std(), 1e-3), (name, b.mean(), j.mean())
