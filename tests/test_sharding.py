"""Multi-device sharding tests on the virtual 8-device CPU mesh.

The analog of the reference's CPU-fallback testing (SURVEY.md
section 4): the identical sharded code paths execute with real XLA
collectives on 8 virtual devices.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sxmc_jax.parallel import mesh as mesh_lib
from sxmc_jax.parallel import nll_sharded
from sxmc_jax.parallel.ensemble import PAD_TAG, pad_datasets
from sxmc_jax.ops.nll import nll as nll_ref


@pytest.fixture(scope="module")
def fit():
    import __graft_entry__

    return __graft_entry__._synthetic_fit()


def test_device_count():
    assert len(jax.devices()) == 8


def test_mesh_construction():
    m = mesh_lib.make_mesh(exp=2, chain=2, event=2)
    assert m.shape == {"exp": 2, "chain": 2, "event": 2}
    with pytest.raises(ValueError):
        mesh_lib.make_mesh(exp=16)


def test_auto_mesh():
    m = mesh_lib.auto_mesh(nexperiments=4, nchains=2)
    assert m.shape["exp"] * m.shape["chain"] * m.shape["event"] <= 8


def test_event_sharded_nll_matches_reference(fit):
    mcmc, data = fit
    mesh = mesh_lib.make_mesh(exp=1, chain=1, event=8)
    theta = jnp.asarray(mcmc.parameter_means, jnp.float32)
    rb = mcmc.stack.compute_read_bins(data)
    lut, norms = mcmc.stack.evaluate(theta[mcmc.nsources:], rb)

    ref = float(nll_ref(theta, lut, norms, mcmc.static))
    sharded = nll_sharded.event_sharded_nll(mesh, mcmc.static)
    hi, lo = sharded(theta, nll_sharded.shard_lut(mesh, lut), norms)
    np.testing.assert_allclose(float(hi) + float(lo), ref, rtol=1e-5)


def test_pad_datasets_sentinel(fit):
    mcmc, data = fit
    batch = pad_datasets([data[:10], data[:20]])
    assert batch.shape == (2, 20, 2)
    assert (batch[0, 10:, -1] == PAD_TAG).all()
    # Padding rows map to a negative sentinel (-1 out-of-domain or -2
    # dataset mismatch) -> zero NLL contribution either way.
    rb = mcmc.stack.compute_read_bins(batch)
    assert (np.asarray(rb)[0, :, 10:] < 0).all()

    # The padded experiment's NLL must equal the unpadded one.
    theta = jnp.asarray(mcmc.parameter_means, jnp.float32)
    lut_pad, norms = mcmc.stack.evaluate(theta[mcmc.nsources:], rb[0])
    lut_ref, _ = mcmc.stack.evaluate(
        theta[mcmc.nsources:], mcmc.stack.compute_read_bins(data[:10]))
    a = float(nll_ref(theta, lut_pad, norms, mcmc.static))
    b = float(nll_ref(theta, lut_ref, norms, mcmc.static))
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_dryrun_multichip():
    import __graft_entry__

    __graft_entry__.dryrun_multichip(8)


def test_sharded_ensemble_runs(fit):
    """Full vmapped+sharded ensemble: 4 experiments x 2 chains."""
    from sxmc_jax.mcmc import metropolis

    mcmc, data = fit
    mesh = mesh_lib.make_mesh(exp=4, chain=2)
    datasets = [data[:24 + i] for i in range(4)]
    batch = pad_datasets(datasets)
    rb = mcmc.stack.compute_read_bins(batch)
    key = jax.random.PRNGKey(1)
    keys = jnp.stack([jax.random.split(jax.random.fold_in(key, i), 2)
                      for i in range(4)])

    device_data = mcmc.stack.device_data

    def run_one(exp_keys, exp_rb):
        run = lambda k: metropolis._run_single_chain(  # noqa: E731
            mcmc, k, exp_rb, device_data, nsteps=10, burnin_steps=2,
            debug_mode=False)
        return jax.vmap(run)(exp_keys)

    from jax.sharding import NamedSharding, PartitionSpec as P

    keys_s = jax.device_put(keys, NamedSharding(mesh, P("exp", "chain")))
    rb_s = jax.device_put(rb, NamedSharding(mesh, P("exp")))
    with mesh:
        samples, nlls, accept = jax.jit(jax.vmap(run_one))(keys_s, rb_s)
    assert samples.shape[:2] == (4, 2)
    nlls64 = metropolis.nll_history_to_f64(nlls)
    assert np.isfinite(nlls64).all()
