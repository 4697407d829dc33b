"""Sharded-ensemble segments on the 8-device CPU mesh.

Contracts pinned here:
  * each (experiment, chain) trajectory of the batched segment
    (parallel.ensemble._batched_segment, vmapped over {exp, chain} and
    partitioned over the mesh) equals a single-chain ``run_segment``
    with that experiment's read bins and the same per-chain key;
  * ``run_sharded_ensemble`` with ``checkpoint_steps`` runs the
    segmented route, and kill-and-resume stays bit-exact on it, for the
    diagonal, full_cov and blocked (rate_substeps) proposals;
  * full_cov retunes from running centered moments equal the
    two-pass history retune.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sxmc_jax.fitconfig import FitConfig
from sxmc_jax.mcmc import metropolis
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.parallel import ensemble as par_ensemble
from sxmc_jax.parallel import mesh as mesh_lib

from tests.test_mcmc import make_fixture
from tests.test_segment_runner import _fixture


def _grouped_fixture(nexp=2, nchain=2, nevents=500):
    obs, syst, sources, signals, data = _fixture(n_mc=20_000,
                                                 nevents=nevents)
    mcmc = MCMC(sources, signals, [syst], [obs])
    rng = np.random.default_rng(4)
    datasets = [data[:nevents - 40 * i] for i in range(nexp)]
    batch = par_ensemble.pad_datasets(datasets)
    rb = mcmc.stack.compute_read_bins(batch)
    # Distinct starts/widths per (exp, chain).
    p0, nll0, w0 = metropolis.initial_state(mcmc, rb[0],
                                            mcmc.stack.device_data)
    npar = mcmc.nparameters
    params = np.tile(np.asarray(p0, np.float32), (nexp, nchain, 1))
    params += rng.uniform(-0.05, 0.05,
                          params.shape).astype(np.float32)
    width = np.tile(np.asarray(w0, np.float32), (nexp, nchain, 1))
    width *= rng.uniform(0.5, 1.5, width.shape).astype(np.float32)
    return mcmc, rb, jnp.asarray(params), jnp.asarray(width)


def _initial_nll(mcmc, rb, params):
    """Per-(exp, chain) compensated NLL pairs at ``params``."""
    dd = mcmc.stack.device_data
    f = jax.jit(lambda p, r, dd: metropolis._chain_nll(mcmc, r, dd)(p))
    his, los = [], []
    for e in range(params.shape[0]):
        h, l = jax.vmap(lambda p: f(p, rb[e], dd))(params[e])
        his.append(h)
        los.append(l)
    return jnp.stack(his), jnp.stack(los)


def _check_matches_run_segment(nexp, nchain, nsteps, m=0):
    mcmc, rb, params, width = _grouped_fixture(nexp, nchain)
    dd = mcmc.stack.device_data
    nll_hi, nll_lo = _initial_nll(mcmc, rb, params)
    mesh = mesh_lib.make_mesh(exp=nexp, chain=nchain)
    keys = par_ensemble._segment_keys(jax.random.PRNGKey(5), nexp,
                                      nchain, 0, 0)
    with mesh:
        p, nll, samples, nlls, acc = par_ensemble._batched_segment(
            mcmc, params, (nll_hi, nll_lo), width, keys, rb, dd, nsteps,
            False, m)
    assert np.asarray(samples).shape == (nexp, nchain, nsteps,
                                         mcmc.nparameters)
    for e in range(nexp):
        for c in range(nchain):
            pf, nf, s1, n1, a1 = metropolis.run_segment(
                mcmc, params[e, c], (nll_hi[e, c], nll_lo[e, c]),
                width[e, c], rb[e], dd, keys[e, c], nsteps,
                rate_substeps=m)
            np.testing.assert_allclose(np.asarray(samples)[e, c],
                                       np.asarray(s1), rtol=3e-7,
                                       atol=3e-7)
            np.testing.assert_allclose(np.asarray(nlls[0])[e, c],
                                       np.asarray(n1[0]), rtol=1e-6)
            np.testing.assert_allclose(np.asarray(p)[e, c],
                                       np.asarray(pf), rtol=3e-7,
                                       atol=3e-7)


class TestBatchedSegment:
    def test_matches_per_chain_run_segment(self):
        _check_matches_run_segment(2, 2, 10)

    def test_experiments_see_their_own_data(self):
        """Distinct datasets must give distinct NLL trajectories (the
        batched rb is not a broadcast of experiment 0)."""
        nexp, nchain, nsteps = 2, 1, 8
        mcmc, rb, params, width = _grouped_fixture(nexp, nchain)
        dd = mcmc.stack.device_data
        params = jnp.asarray(
            np.tile(np.asarray(params[0, 0]), (nexp, nchain, 1)))
        width = jnp.asarray(
            np.tile(np.asarray(width[0, 0]), (nexp, nchain, 1)))
        nll_hi, nll_lo = _initial_nll(mcmc, rb, params)
        assert float(nll_hi[0, 0]) != float(nll_hi[1, 0])
        mesh = mesh_lib.make_mesh(exp=2, chain=1)
        keys = par_ensemble._segment_keys(jax.random.PRNGKey(1),
                                          nexp, nchain, 0, 0)
        # Same key for both experiments: trajectories must still split
        # because the rb rows differ.
        keys = jnp.asarray(np.tile(np.asarray(keys[:1]), (nexp, 1, 1)))
        with mesh:
            _, _, _, nlls, _ = par_ensemble._batched_segment(
                mcmc, params, (nll_hi, nll_lo), width, keys, rb, dd,
                nsteps, False)
        assert not np.array_equal(np.asarray(nlls[0])[0],
                                  np.asarray(nlls[0])[1])


def _config(seed=3, proposal="diagonal", nexperiments=4):
    obs, systs, sources, signals = make_fixture(with_systematic=True,
                                                seed=9)
    return FitConfig(
        nexperiments=nexperiments, nsteps=250, burnin_fraction=0.2,
        signal_name="sig", seed=seed, nchains=2, proposal=proposal,
        observables=[obs], systematics=systs, sources=sources,
        signals=signals)


def _kill_and_resume(fc, tmp_path, ckpt_steps=40, die_after=3, mesh=None):
    """Uninterrupted segmented run vs. one killed after ``die_after``
    segments and resumed; returns both results."""
    pA = str(tmp_path / "runA")
    lsA, limA = par_ensemble.run_sharded_ensemble(
        fc, mesh=mesh, verbose=False, checkpoint_path=pA,
        checkpoint_steps=ckpt_steps)

    pB = str(tmp_path / "runB")
    real = par_ensemble._batched_segment
    calls = {"n": 0}

    def dying(*args, **kwargs):
        if calls["n"] >= die_after:
            raise RuntimeError("simulated preemption")
        calls["n"] += 1
        return real(*args, **kwargs)

    par_ensemble._batched_segment = dying
    try:
        with pytest.raises(RuntimeError, match="preemption"):
            par_ensemble.run_sharded_ensemble(
                fc, mesh=mesh, verbose=False, checkpoint_path=pB,
                checkpoint_steps=ckpt_steps)
    finally:
        par_ensemble._batched_segment = real
    assert os.path.exists(pB + ".state.npz")
    state = dict(np.load(pB + ".state.npz"))
    lsB, limB = par_ensemble.run_sharded_ensemble(
        fc, mesh=mesh, verbose=False, checkpoint_path=pB,
        checkpoint_steps=ckpt_steps, resume=True)
    np.testing.assert_array_equal(np.asarray(limA), np.asarray(limB))
    for a, b in zip(lsA, lsB):
        np.testing.assert_array_equal(a.samples, b.samples)
        np.testing.assert_array_equal(a.nll_values, b.nll_values)
    return state, limA


class TestSegmentedEnsembleRoute:
    def test_segmented_route_taken_and_sane(self, tmp_path):
        fc = _config()
        calls = {"n": 0}
        real = par_ensemble._batched_segment

        def counting(*args, **kwargs):
            calls["n"] += 1
            return real(*args, **kwargs)

        par_ensemble._batched_segment = counting
        try:
            ls, limits = par_ensemble.run_sharded_ensemble(
                fc, verbose=False, checkpoint_path=str(tmp_path / "r"),
                checkpoint_steps=100)
        finally:
            par_ensemble._batched_segment = real
        assert calls["n"] >= 3  # two burn-in phases + sampling
        assert len(limits) == fc.nexperiments
        assert np.isfinite(limits).all()
        for l in ls:
            assert np.isfinite(l.nll_values).all()

    def test_kill_and_resume_bitwise_explicit_mesh(self, tmp_path):
        fc = _config()
        mesh = mesh_lib.make_mesh(exp=2, chain=2)
        _, limits = _kill_and_resume(fc, tmp_path, mesh=mesh)
        assert len(limits) == fc.nexperiments


class TestFullCovSegmented:
    @pytest.mark.parametrize("ckpt_steps", [40, 70])
    def test_fullcov_kill_and_resume_bitwise(self, tmp_path, ckpt_steps):
        """full_cov segment checkpointing: resume continues
        bit-identically, with retunes from running centered moments,
        whatever the segment length."""
        fc = _config(proposal="full_cov")
        state, _ = _kill_and_resume(fc, tmp_path, ckpt_steps=ckpt_steps)
        assert "pcross" in state and "cref" in state
        # The proposal state is the per-chain scale_tril.
        assert state["width"].ndim == 4

    def test_moment_retune_matches_history_retune(self):
        """_sharded_retune_cov (centered one-pass moments) agrees with
        retune_scale_tril (two-pass history covariance) to fp
        tolerance."""
        obs, systs, sources, signals = make_fixture(
            with_systematic=True, seed=9)
        mcmc = MCMC(sources, signals, systs, [obs])
        npar = mcmc.nparameters
        rng = np.random.default_rng(11)
        nexp, nch, n = 2, 2, 300
        base = np.asarray(mcmc.parameter_means, np.float32)
        hist = (base[None, None, None, :]
                + rng.normal(0, 0.1, (nexp, nch, n, npar))
                ).astype(np.float32)
        tril0 = np.tile(
            np.asarray(metropolis._initial_scale_tril(mcmc)),
            (nexp, nch, 1, 1)).astype(np.float32)
        cref = hist[:, :, 0, :]
        xc = hist - cref[:, :, None, :]
        psum = xc.sum(axis=2)
        pcross = np.einsum("ecsi,ecsj->ecij", xc, xc)
        got = par_ensemble._sharded_retune_cov(
            mcmc, jnp.asarray(tril0), jnp.float32(n),
            jnp.asarray(psum), jnp.asarray(pcross))
        want = jax.vmap(jax.vmap(
            lambda t, s: metropolis.retune_scale_tril(mcmc, t, s)))(
                jnp.asarray(tril0), jnp.asarray(hist))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-3, atol=2e-5)


class TestBlockedSegmented:
    def test_blocked_matches_per_chain(self):
        """rate_substeps through the batched segment: each (exp, chain)
        advances exactly as a standalone blocked run_segment with that
        experiment's rb and the same key."""
        _check_matches_run_segment(2, 2, 6, m=2)

    def test_blocked_kill_and_resume_bitwise(self, tmp_path):
        fc = _config()
        fc.rate_substeps = 3
        _kill_and_resume(fc, tmp_path, die_after=2)
