"""Event-sharded chain tests on the virtual 8-device CPU mesh."""

import numpy as np
import jax
import pytest

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.parallel.chain_sharded import run_sharded_chain
from tests.test_mcmc import make_fixture


class TestShardedChain:
    def test_matches_unsharded_posterior(self):
        obs, systs, sources, signals = make_fixture(seed=5)
        data = make_fake_dataset(jax.random.PRNGKey(2), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])

        ls_ref = mcmc(data, nsteps=8000, burnin_fraction=0.2, seed=11)
        ls_sh = run_sharded_chain(mcmc, data, nsteps=8000,
                                  burnin_fraction=0.2, seed=12)

        for name in ["sig", "bkg"]:
            m_ref = ls_ref.column(name).mean()
            m_sh = ls_sh.column(name).mean()
            s_ref = ls_ref.column(name).std()
            assert abs(m_ref - m_sh) < 5 * s_ref / np.sqrt(50), \
                (name, m_ref, m_sh)

    def test_shard_builds_sum_to_stack_histograms(self):
        """Per-shard bincounts of slices of the MC samples, psummed over
        the 8-device event mesh, equal the stack's single-device build
        exactly (integer counts), and the sharded fit is sane."""
        import jax.numpy as jnp
        from jax.sharding import Mesh, PartitionSpec as P

        from sxmc_jax.ops import histogram as hist_ops
        from sxmc_jax.pdf.stack import _apply_masked_systematics

        obs, systs, sources, signals = make_fixture(
            with_systematic=True, seed=7)
        data = make_fake_dataset(jax.random.PRNGKey(4), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])
        stack = mcmc.stack
        theta = jnp.asarray([0.07], jnp.float32)
        want, _ = stack.histograms(theta)

        ls = run_sharded_chain(mcmc, data, nsteps=1500,
                               burnin_fraction=0.2, seed=3)
        bf = ls.get_best_fit()
        assert np.isfinite(ls.nll_values).all()
        assert abs(bf["sig"].point_estimate - 1.0) < 0.5

        ndev = len(jax.devices())
        mesh = Mesh(np.asarray(jax.devices()), axis_names=("event",))
        samples = stack.samples_host
        seg = stack.segment_ids_host
        n = samples.shape[0]
        npad = -(-n // ndev) * ndev
        samples_p = np.concatenate([samples, np.full(
            (npad - n, samples.shape[1]), stack.lower_host[0] - 1e9,
            np.float32)])
        seg_p = np.concatenate([seg, np.zeros(npad - n, np.int32)])

        def body(samples_l, seg_l):
            t = _apply_masked_systematics(samples_l, seg_l, theta,
                                          stack.systematics,
                                          stack.nsignals)
            h, _ = hist_ops.segmented_histogram(
                t[:, :1], seg_l, jnp.ones(samples_l.shape[0], bool),
                stack.lower, stack.upper, stack.nbins, stack.nsignals)
            return jax.lax.psum(h, "event")

        with mesh:
            got = jax.shard_map(
                body, mesh=mesh, in_specs=(P("event"), P("event")),
                out_specs=P())(jnp.asarray(samples_p), jnp.asarray(seg_p))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))

    def test_floating_systematics_sharded(self):
        obs, systs, sources, signals = make_fixture(
            with_systematic=True, seed=5)
        data = make_fake_dataset(jax.random.PRNGKey(2), signals, systs,
                                 [obs], poisson=False)
        mcmc = MCMC(sources, signals, systs, [obs])
        ls = run_sharded_chain(mcmc, data, nsteps=2000,
                               burnin_fraction=0.2, seed=3)
        bf = ls.get_best_fit()
        assert abs(bf["energy_shift_0"].point_estimate) < 0.2
        assert abs(bf["sig"].point_estimate - 1.0) < 0.4
        assert np.isfinite(ls.nll_values).all()
