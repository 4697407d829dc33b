"""Multi-host ensemble driver: experiments fanned out over processes.

The reference runs its sensitivity ensemble in a serial host loop on
one GPU (reference: src/sxmc.cpp:59-145).  Here the ensemble axis is
the DCN axis of SURVEY.md section 2.2: each host process owns a
contiguous block of global experiment indices, generates and fits ONLY
its local experiments on its local devices, and the per-experiment
limits are all-gathered at the end — the median limit is then computed
identically on every process.

Determinism: datasets are keyed by jax.random.fold_in(key, global_i),
so the gathered results are bit-identical for any process count —
which is exactly what tests/test_multihost.py asserts with a
2-process CPU `jax.distributed` run against a single-process one.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sxmc_jax.generator import make_fake_dataset
from sxmc_jax.mcmc import metropolis
from sxmc_jax.mcmc.metropolis import MCMC
from sxmc_jax.parallel import mesh as mesh_lib
from sxmc_jax.parallel.ensemble import pad_datasets
from sxmc_jax.stats.likelihood import LikelihoodSpace


def run_multihost_ensemble(
    fc,
    nsteps: Optional[int] = None,
    verbose: bool = True,
    poisson: bool = True,
) -> Tuple[List[Optional[LikelihoodSpace]], np.ndarray]:
    """Run ``fc.nexperiments`` fits spread over ``jax.process_count()``
    processes.

    Returns:
        (lspaces, limits): per-GLOBAL-experiment likelihood spaces
        (None for experiments owned by other processes) and the
        ``(nexperiments,)`` gathered upper limits, identical on every
        process.
    """
    nsteps = nsteps or fc.nsteps
    nexp = fc.nexperiments
    local = mesh_lib.process_local_experiments(nexp)
    if verbose:
        print(f"multihost: process {jax.process_index()}/"
              f"{jax.process_count()} owns experiments {local}")

    mcmc = MCMC(fc.sources, fc.signals, fc.systematics, fc.observables)
    if getattr(mcmc.stack, "_kde_exact", ()):
        raise NotImplementedError(
            "the multihost driver does not thread per-experiment "
            "event-coordinate extras (the single-host sharded "
            "ensemble does, parallel/ensemble.py); use "
            "kde_exact=false here.")
    key = jax.random.PRNGKey(fc.seed)

    lspaces: List[Optional[LikelihoodSpace]] = [None] * nexp
    local_limits = np.zeros(nexp, np.float64)
    if local:
        datasets = [
            make_fake_dataset(jax.random.fold_in(key, gi), fc.signals,
                              fc.systematics, fc.observables,
                              poisson=poisson, stack=mcmc.stack)
            for gi in local
        ]
        batch = pad_datasets(datasets)
        rb = mcmc.stack.compute_read_bins(batch)
        keys = jnp.stack([jax.random.fold_in(key, 1000 + gi)
                          for gi in local])
        burnin_steps = int(nsteps * fc.burnin_fraction)
        if getattr(fc, "proposal", "diagonal") == "full_cov":
            run = lambda k, rb1: metropolis._run_single_chain_fullcov(  # noqa: E731,E501
                mcmc, k, rb1, mcmc.stack.device_data, nsteps=nsteps,
                burnin_steps=burnin_steps, debug_mode=fc.debug_mode)
            samples, nlls, _ = jax.vmap(run)(
                keys, jnp.asarray(np.asarray(rb)))
        else:
            samples, nlls, _ = metropolis.run_experiment_batch(
                mcmc, keys, jnp.asarray(np.asarray(rb)),
                mcmc.stack.device_data, nsteps=nsteps,
                burnin_steps=burnin_steps, debug_mode=fc.debug_mode,
                rate_substeps=getattr(fc, 'rate_substeps', 0))
        samples = np.asarray(samples)
        nlls = metropolis.nll_history_to_f64(nlls)

        for k, gi in enumerate(local):
            ls = LikelihoodSpace.from_arrays(
                samples[k], nlls[k], mcmc.parameter_names,
                cl=fc.confidence, error_type=fc.error_type)
            lspaces[gi] = ls
            if fc.signal_name and fc.signal_name in mcmc.parameter_names:
                local_limits[gi] = ls.get_best_fit()[
                    fc.signal_name].upper

    # Gather the limits over processes: every process holds zeros in
    # the slots it does not own, so a psum-style allgather-and-sum
    # reconstructs the full vector identically everywhere (DCN
    # collective; a no-op single-process).
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils

        gathered = multihost_utils.process_allgather(
            jnp.asarray(local_limits, jnp.float64
                        if jax.config.jax_enable_x64 else jnp.float32))
        limits = np.asarray(gathered, np.float64).sum(axis=0)
    else:
        limits = local_limits
    return lspaces, limits
