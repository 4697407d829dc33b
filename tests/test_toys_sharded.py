"""Sharded toy-fit batches: exactness vs the single-device path.

Runs on the virtual 8-device CPU mesh (tests/conftest.py), the same
SPMD code a multi-device mesh executes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sxmc_jax.generator import make_fake_dataset_batch
from sxmc_jax.parallel import mesh as mesh_lib
from sxmc_jax.parallel.toys_sharded import (_pad_to_devices,
                                            sharded_pull_batch,
                                            sharded_toy_dnll)
from sxmc_jax.signal import Observable, Signal, Source
from sxmc_jax.stats.bias import _toy_fit_batch, pull_study
from sxmc_jax.stats.feldman_cousins import (FeldmanCousins,
                                            _toy_dnll_batch)
from sxmc_jax.stats.mle import MLE


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(11)
    obs = Observable(name="energy", field="energy", bins=20, lower=5.0,
                     upper=15.0, field_index=0)
    sig_mc = rng.normal(10, 1, (20000, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (20000, 1)).astype(np.float32)
    src_s = Source(name="sig", index=0, mean=1.0, sigma=0.0)
    src_b = Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    fields = ["energy", "DATASET"]
    sig = Signal.from_table("sig", "S", sig_mc, ["energy"], 0, src_s,
                            150.0, fields, [obs], [], [])
    bkg = Signal.from_table("bkg", "B", bkg_mc, ["energy"], 0, src_b,
                            400.0, fields, [obs], [], [])
    mle = MLE([src_s, src_b], [sig, bkg], [], [obs])
    batch = make_fake_dataset_batch(
        jax.random.PRNGKey(3), mle.signals, [], [obs], 24,
        poisson=True, stack=mle.stack)
    rb = np.asarray(mle.stack.compute_read_bins(batch))
    return mle, rb


def test_pad_to_devices():
    a = jnp.arange(10).reshape(5, 2)
    p, n = _pad_to_devices(a, 8)
    assert p.shape == (8, 2) and n == 5
    np.testing.assert_array_equal(
        np.asarray(p[5:]), np.broadcast_to(np.asarray(a[:1]), (3, 2)))
    p2, n2 = _pad_to_devices(a, 5)
    assert p2.shape == (5, 2) and n2 == 5


class TestShardedToyDnll:
    def test_matches_unsharded(self, model):
        mle, rb = model
        mesh = mesh_lib.make_mesh(exp=8)
        rv = np.full(rb.shape[0], 0.8, np.float32)
        d_sh, rh_sh = sharded_toy_dnll(
            mesh, mle, rv, rb, 0, tuple(mle._free_rates), mle.maxiter)
        d_un, rh_un = _toy_dnll_batch(
            mle, jnp.asarray(rv), jnp.asarray(rb),
            mle.stack.device_data, 0, tuple(mle._free_rates),
            mle.maxiter)
        np.testing.assert_allclose(d_sh, np.asarray(d_un),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(rh_sh, np.asarray(rh_un),
                                   rtol=1e-5, atol=1e-5)

    def test_belt_via_mesh(self, model):
        """FeldmanCousins.build_belt(mesh=...) returns a usable belt."""
        mle, _ = model
        fc = FeldmanCousins(mle, "sig")
        mesh = mesh_lib.make_mesh(exp=4, chain=2)
        belt = fc.build_belt(jax.random.PRNGKey(5), [0.5, 1.0],
                             ntoys=12, cl=0.9, mesh=mesh)
        assert belt.dnll_toys.shape == (2, 12)
        assert np.all(belt.crit >= 0)


class TestShardedPulls:
    def test_matches_unsharded(self, model):
        mle, rb = model
        mesh = mesh_lib.make_mesh(exp=8)
        r_sh, e_sh = sharded_pull_batch(
            mesh, mle, rb, tuple(mle._free_rates), mle.maxiter)
        r_un, e_un = _toy_fit_batch(
            mle, jnp.asarray(rb), mle.stack.device_data,
            tuple(mle._free_rates), mle.maxiter)
        np.testing.assert_allclose(r_sh, np.asarray(r_un),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(e_sh, np.asarray(e_un),
                                   rtol=1e-4, atol=1e-6)

    def test_pull_study_mesh_kwarg(self, model):
        mle, _ = model
        mesh = mesh_lib.make_mesh(exp=8)
        ps = pull_study(mle, 20, jax.random.PRNGKey(7), mesh=mesh)
        assert ps.estimates.shape == (20, 2)
        assert all(v["n_used"] > 0 for v in ps.summary().values())
