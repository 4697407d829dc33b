"""Statistical correctness: interval coverage over a vmapped ensemble.

The reference never validated its interval estimators statistically;
here we run many fake experiments (vmapped, fixed systematics so the
LUT is static and the ensemble is fast) and check that the 68.3%
projection interval covers the true rate at the expected frequency.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.mcmc import metropolis
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.parallel.ensemble import pad_datasets
from sxmc_jax.stats.likelihood import LikelihoodSpace
from tests.test_mcmc import make_fixture


@pytest.mark.slow
def test_projection_interval_coverage():
    nexp = 32
    obs, systs, sources, signals = make_fixture(seed=12)
    key = jax.random.PRNGKey(100)

    datasets = [
        make_fake_dataset(jax.random.fold_in(key, i), signals, systs,
                          [obs], poisson=True)
        for i in range(nexp)
    ]
    batch = pad_datasets(datasets)

    mcmc = MCMC(sources, signals, systs, [obs])
    rb = mcmc.stack.compute_read_bins(batch)
    dd = mcmc.stack.device_data
    keys = jax.random.split(jax.random.fold_in(key, 999), nexp)

    samples, nlls, _ = metropolis.run_experiment_batch(
        mcmc, keys, rb, dd, nsteps=6000, burnin_steps=1200)
    samples = np.asarray(samples)
    nlls = metropolis.nll_history_to_f64(nlls)

    covered = 0
    for i in range(nexp):
        ls = LikelihoodSpace.from_arrays(
            samples[i], nlls[i], mcmc.parameter_names, cl=0.683,
            error_type="projection")
        iv = ls.get_best_fit()["sig"]
        if iv.lower <= 1.0 <= iv.upper:
            covered += 1

    # 68.3% nominal; binomial sigma ~ 0.082 for n=32: accept 3 sigma.
    frac = covered / nexp
    assert 0.43 < frac < 0.95, f"coverage {frac} ({covered}/{nexp})"
