"""Affine-invariant ensemble sampler (Goodman & Weare 2010 stretch move).

A sampler family the reference's one-walker-per-GPU design could not
express: an ensemble of walkers whose proposals are built from *each
other's* positions, so the proposal automatically adapts to the scale
and correlations of the posterior — no jump-width tuning at all
(replacing the Haario heuristic + burn-in retuning of mcmc.cpp:197-311).

The move is embarrassingly data-parallel over walkers, which is exactly
the accelerator shape: each half-ensemble updates as one vmapped NLL
batch (one batched histogram+LUT+NLL pass for all walkers), the whole walk is a
``lax.scan``, and walker ensembles vmap/shard like chains.

Move (for walker x_i in half S0, partner x_j drawn from half S1):
    z ~ g(z) prop. 1/sqrt(z) on [1/a, a]   (z = ((a-1)u + 1)^2 / a)
    y = x_j + z (x_i - x_j)                (free coordinates only)
    accept with prob min(1, z^(d-1) exp(nll(x_i) - nll(y)))
with d the number of free parameters; halves update alternately.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sxmc_jax.mcmc.metropolis import (MCMC, _chain_nll_batch,
                                      nll_history_to_f64)
from sxmc_jax.ops.nll import df_diff
from sxmc_jax.stats.likelihood import LikelihoodSpace


class StretchSampler(MCMC):
    """Ensemble sampler with the same call contract as MCMC.

    ``nchains`` in ``__call__`` selects the number of independent walker
    ensembles (vmapped); ``nwalkers`` sets the walkers per ensemble.
    """

    def __init__(self, *args, nwalkers: int = 0, a: float = 2.0, **kwargs):
        super().__init__(*args, **kwargs)
        if nwalkers <= 0:
            nwalkers = max(2 * self.nparameters + 2, 16)
        self.nwalkers = nwalkers + (nwalkers % 2)  # even split
        self.a = float(a)

    def __call__(
        self,
        data: np.ndarray,
        nsteps: int,
        burnin_fraction: float = 0.1,
        debug_mode: bool = False,
        seed: int = 0,
        nchains: int = 1,
        key: Optional[jax.Array] = None,
    ) -> LikelihoodSpace:
        self.stack.set_data(np.asarray(data, np.float32))
        burnin = int(nsteps * burnin_fraction)

        if key is None:
            key = jax.random.PRNGKey(seed)
        ens_keys = jax.random.split(key, nchains)

        samples, nlls, accept = _run_stretch_ensembles(
            self, ens_keys, self.stack._read_bins,
            self.stack.device_data, nsteps, burnin, debug_mode)

        samples = np.asarray(samples).reshape(-1, self.nparameters)
        nlls = nll_history_to_f64(nlls).reshape(-1)
        self.last_accept_rate = float(np.mean(np.asarray(accept)))
        return LikelihoodSpace.from_arrays(
            samples, nlls, self.parameter_names)


@functools.partial(
    jax.jit,
    static_argnames=("s", "nsteps", "burnin", "debug_mode"))
def _run_stretch_ensembles(s: StretchSampler, ens_keys, read_bins,
                           device_data, nsteps: int, burnin: int,
                           debug_mode: bool):
    run = functools.partial(_run_stretch_single, s, nsteps=nsteps,
                            burnin=burnin, debug_mode=debug_mode)
    return jax.vmap(run, in_axes=(0, None, None))(
        ens_keys, read_bins, device_data)


@functools.partial(jax.jit, static_argnames=("s",))
def initial_walkers(s: StretchSampler, key, read_bins, device_data):
    """Initial walker cloud + compensated NLL pair.

    Means + initial-jump-width ball, rates kept positive (negative
    rates are the 1e18 barrier region, nll_kernels.cpp:173).
    """
    nll_batch = _chain_nll_batch(s, read_bins, device_data, s.nwalkers)
    npar = s.nparameters
    free = ~jnp.asarray(s.parameter_fixed)
    means = jnp.asarray(s.parameter_means, jnp.float32)
    w0 = jnp.maximum(jnp.asarray(s.initial_jump_widths()), 0.0)
    noise = jax.random.normal(key, (s.nwalkers, npar)) * w0
    walkers = means + jnp.where(free, noise, 0.0)
    is_rate = jnp.arange(npar) < s.nsources
    floor = 1e-4 * jnp.maximum(jnp.abs(means), 1.0)
    walkers = jnp.where(is_rate & free,
                        jnp.maximum(walkers, floor), walkers)
    wnll = nll_batch(walkers)  # compensated (hi, lo) pair of (K,) arrays
    return walkers, wnll


@functools.partial(
    jax.jit, static_argnames=("s", "nsteps", "debug_mode"))
def stretch_segment(s: StretchSampler, walkers, wnll, read_bins,
                    device_data, key, nsteps: int,
                    debug_mode: bool = False):
    """Advance one walker ensemble ``nsteps`` steps from explicit carry.

    Returns ``((walkers, wnll), (hist, hist_nll, acc))`` — the building
    block for mid-chain checkpointing (sxmc_jax.checkpoint), like
    metropolis.run_segment / hmc.main_segment.
    """
    # One fused (walkers x signals) rebuild per half-move instead of
    # per-walker vmapped rebuilds (same trick as the lock-step chains).
    nll_batch = _chain_nll_batch(s, read_bins, device_data,
                                 s.nwalkers // 2)
    half = s.nwalkers // 2
    free = ~jnp.asarray(s.parameter_fixed)
    d = jnp.float32(max(s.nfloat, 1))
    a = s.a

    def half_update(active, active_nll, other, step_key):
        """Stretch-move one half against the other (vectorized)."""
        k_z, k_pair, k_acc = jax.random.split(step_key, 3)
        u = jax.random.uniform(k_z, (half,))
        z = ((a - 1.0) * u + 1.0) ** 2 / a
        partners = other[jax.random.randint(k_pair, (half,), 0, half)]
        prop = partners + z[:, None] * (active - partners)
        prop = jnp.where(free, prop, active)
        pnll = nll_batch(prop)
        delta = df_diff(active_nll[0], active_nll[1], pnll[0], pnll[1])
        log_acc = (d - 1.0) * jnp.log(z) + delta
        accept = debug_mode | (
            jnp.log(jax.random.uniform(k_acc, (half,))) < log_acc)
        new = jnp.where(accept[:, None], prop, active)
        new_nll = (jnp.where(accept, pnll[0], active_nll[0]),
                   jnp.where(accept, pnll[1], active_nll[1]))
        return new, new_nll, accept

    def step(carry, step_key):
        walkers, wnll = carry
        k0, k1 = jax.random.split(step_key)
        w0_ = walkers[:half]
        n0 = (wnll[0][:half], wnll[1][:half])
        w1_ = walkers[half:]
        n1 = (wnll[0][half:], wnll[1][half:])
        w0_, n0, a0 = half_update(w0_, n0, w1_, k0)
        w1_, n1, a1 = half_update(w1_, n1, w0_, k1)
        walkers = jnp.concatenate([w0_, w1_])
        wnll = (jnp.concatenate([n0[0], n1[0]]),
                jnp.concatenate([n0[1], n1[1]]))
        acc = jnp.concatenate([a0, a1]).astype(jnp.float32).mean()
        return (walkers, wnll), (walkers, wnll, acc)

    keys = jax.random.split(key, nsteps)
    carry, (hist, hist_nll, accs) = jax.lax.scan(
        step, (walkers, wnll), keys)
    return carry, (hist, hist_nll, accs.mean())


def _run_stretch_single(s: StretchSampler, key, read_bins, device_data, *,
                        nsteps: int, burnin: int, debug_mode: bool):
    npar = s.nparameters
    k_init, k_run = jax.random.split(key)
    walkers, wnll = initial_walkers(s, k_init, read_bins, device_data)
    _, (hist, hist_nll, acc) = stretch_segment(
        s, walkers, wnll, read_bins, device_data, k_run, nsteps,
        debug_mode)

    # Discard burn-in, pool walkers: (nsteps, K, npar) -> (kept*K, npar).
    kept = hist[burnin:].reshape(-1, npar)
    kept_nll = (hist_nll[0][burnin:].reshape(-1),
                hist_nll[1][burnin:].reshape(-1))
    return kept, kept_nll, acc
